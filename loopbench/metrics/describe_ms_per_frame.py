"""describe_ms_per_frame: device time of the program's
``slam.orb.describe`` span (orientation (M), the 30-bin BRIEF selects and
products, the signed and packed descriptors) over the traced calls'
frames."""

from loopbench.trace import program


def read(run):
    return program.device_ms_per_frame(run, "slam.orb.describe")
