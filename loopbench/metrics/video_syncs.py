"""video_syncs: host waits for the device during one call after the
window (torch's sync debug mode, plus explicit synchronize calls)."""


def read(run):
    if not run.cuda:
        return None
    return run.counters["syncs_per_call"]
