"""host_tail_ms: host time of the program's ``slam.loop.rule`` and
``slam.loop.frames`` spans inside ``process_video`` a traced call: the
host's work after the readback, while the card has nothing to do."""

from loopbench.trace import program

TAIL = ("slam.loop.rule", "slam.loop.frames")


def read(run):
    calls = {r["id"] for r in program.named(run, "slam.loop.process_video")}
    if not calls:
        return None
    return sum(r["host_ms"] for r in program.spans(run)
               if r["name"] in TAIL and r["request"] in calls) / len(calls)
