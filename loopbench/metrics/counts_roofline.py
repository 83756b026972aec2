"""counts_roofline: the counts' least time (the b1 products of the valid
row pairs of the needed frame pairs, or the packed store read once and the
counts written once) over the device time inside the counts span, in %."""

from loopbench.yardstick import work


def read(run):
    device_s = run.trace.span_device_s.get("counts", 0.0)
    if device_s <= 0:
        return None
    least = sum(work.counts_least_s(w["nfeat"], w["gap"], w["slots"])
                for w in run.work)
    return 100.0 * least / device_s
