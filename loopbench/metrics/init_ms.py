"""init_ms: host time of the program's ``slam.loop.init`` span (a new
``LoopClosingSystem``: the BRIEF matrices built on the host and copied
from pageable memory, the frame database) a traced call."""

from loopbench.trace import program


def read(run):
    host_ms = [r["host_ms"] for r in program.named(run, "slam.loop.init")]
    return sum(host_ms) / len(run.work) if host_ms else None
