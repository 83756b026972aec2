"""detect_ms_per_frame: device time of the program's ``slam.orb.detect``
span (every pyramid level's FAST, NMS and blur (A), grid top-K and patches
(B)) over the traced calls' frames."""

from loopbench.trace import program


def read(run):
    return program.device_ms_per_frame(run, "slam.orb.detect")
