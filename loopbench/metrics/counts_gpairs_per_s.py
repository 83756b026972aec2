"""counts_gpairs_per_s: the valid descriptor pairs (query row, target row)
of every frame pair the cell's counts need, over the device time inside the
counts span, in 1e9 a second (BASELINE's "Gpairs/sec")."""

from loopbench.yardstick import work


def read(run):
    device_s = run.trace.span_device_s.get("counts", 0.0)
    if device_s <= 0:
        return None
    rows = sum(work.pair_rows(w["nfeat"], w["gap"])[1] for w in run.work)
    return rows / device_s / 1e9
