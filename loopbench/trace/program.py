"""The program's own spans (``slam_loop_closing_tpu_torch.utils.profiling``)
of a traced run's calls, for the readers that take them.

The program records a span only while a profiler session records, and a
run records its traced calls alone: so a run's spans are the newest the
process holds, and they lie in its traced window, which ends at or after
the newest span's end. A process that runs several runs holds the earlier
runs' spans too, each run's ended at least a whole call (the profiler's
warm-up step) before the next run's window. A program without spans gives
none, and its readers return None.
"""

from __future__ import annotations

SLACK_NS = 1_000_000   # the spans' clock against the profiler's: us apart


def spans(run) -> list:
    """The span records of ``run``'s traced calls, read once a run and
    kept in ``run.counters``."""
    if "program_spans" not in run.counters:
        run.counters["program_spans"] = _collect(run)
    return run.counters["program_spans"]


def _collect(run) -> list:
    from slam_loop_closing_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    records = read() if read is not None and run.trace is not None else []
    if not records:
        return []
    first = (max(r["end_ns"] for r in records)
             - int(run.trace.window_s * 1e9) - SLACK_NS)
    return [r for r in records if r["start_ns"] >= first]


def named(run, name: str) -> list:
    return [r for r in spans(run) if r["name"] == name]


def device_ms_per_frame(run, name: str):
    """The device time of the spans ``name`` over the traced calls'
    frames; None where the spans have no device time (a CPU run)."""
    device_ms = [r["device_ms"] for r in named(run, name)
                 if r["device_ms"] is not None]
    if not device_ms:
        return None
    return sum(device_ms) / sum(w["frames"] for w in run.work)
