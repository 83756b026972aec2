"""frames_per_s: every frame whose loop list reached the host in the
window, over the whole time of the window (host clock; the window runs
whole calls)."""


def read(run):
    return sum(run.call_frames) / run.window_s
