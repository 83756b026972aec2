"""frontend_roofline: the front-end's least time (its float32 frames read
and its keypoint slots written once, or the operations the algorithm needs
on each pipe) over the device time inside the front-end span, in %."""

from loopbench.yardstick import work


def read(run):
    device_s = run.trace.span_device_s.get("frontend", 0.0)
    if device_s <= 0:
        return None
    orb = run.cell.config["orb"]
    least = sum(work.frontend_least_s(w["frames"], w["height"], w["width"],
                                      orb) for w in run.work)
    return 100.0 * least / device_s
