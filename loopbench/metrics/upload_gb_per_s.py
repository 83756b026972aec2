"""upload_gb_per_s: bytes of the program's ``slam.image.upload`` spans
(host-to-device copies of the frames) over their device time."""

from loopbench.trace import program


def read(run):
    ups = [r for r in program.named(run, "slam.image.upload")
           if r["device_ms"]]
    if not ups:
        return None
    return (sum(r["counters"]["bytes"] for r in ups) / 1e6
            / sum(r["device_ms"] for r in ups))
