"""frontend_ms_per_frame: device time inside the front-end span
(``orb.detect_and_describe_batch``) over the traced calls' frames."""


def read(run):
    device_s = run.trace.span_device_s.get("frontend", 0.0)
    if device_s <= 0:
        return None
    return device_s * 1e3 / sum(w["frames"] for w in run.work)
