"""video_p95_ms: the 95th percentile of the calls of the window, each
timed on the host clock from the call until its loop list is on the host
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 95))
