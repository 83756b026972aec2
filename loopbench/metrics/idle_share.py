"""idle_share: the share of the traced window (the traced calls, first
start to last end) with no kernel, copy or memset on the card, in %."""


def read(run):
    if run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
