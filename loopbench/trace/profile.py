"""Spans, counters and the profiler's trace of a traced run.

The spans come from the benchmark's own side: :class:`Spans` replaces the
module attributes that each ``spans/<span>.json`` names (the functions the
entries look up at call time) by wrappers that open a ``record_function``
range named ``loopbench.<span>`` and record CUDA events around the call.
Nothing in the program is edited; a span is added by adding its file. :func:`analyse` reduces a ``torch.profiler`` session to
what the per-layer readers take: each span's device time, the device's busy
time over the traced window, the device operations that took the most
time, and the longest idle gaps by what the host was doing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import warnings
from pathlib import Path

import torch

CALL = "loopbench.call"
GAPS_ATTRIBUTED = 200   # longest idle gaps named by the host's activity
NAME_CHARS = 160        # a device operation's name, cut to this length


@dataclasses.dataclass
class Trace:
    """What a traced run measured on the device and the host."""

    span_device_s: dict      # span -> device seconds inside it (profiler)
    span_event_s: dict       # span -> seconds between its CUDA events
    span_calls: dict         # span -> times it was entered
    busy_s: float            # union of device activity over the window
    window_s: float          # first traced call's start to last's end
    device_ops: list         # [[name, seconds], ...] longest first
    idle_gaps: list          # [[host activity, seconds], ...]


class Spans:
    """The functions of ``<folder>/<span>.json`` (a list of
    ``module:attribute``) wrapped from :meth:`start` to :meth:`stop`."""

    def __init__(self, cuda: bool, folder: Path):
        self.cuda = cuda
        self.folder = folder
        self.event_s = collections.Counter()
        self.calls = collections.Counter()
        self._pending = []
        self._saved = []

    def _wrap(self, span: str, fn):
        def wrapper(*args, **kwargs):
            self.calls[span] += 1
            with torch.profiler.record_function(f"loopbench.{span}"):
                if not self.cuda:
                    return fn(*args, **kwargs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self._pending.append((span, start, end))
                return out
        return wrapper

    def start(self) -> None:
        for path in sorted(self.folder.glob("*.json")):
            span = path.stem
            for target in json.loads(path.read_text()):
                mod_name, attr = target.split(":")
                module = importlib.import_module(mod_name)
                fn = getattr(module, attr)
                self._saved.append((module, attr, fn))
                setattr(module, attr, self._wrap(span, fn))

    def stop(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()
        if self.cuda:
            torch.cuda.synchronize()
        for span, start, end in self._pending:
            self.event_s[span] += start.elapsed_time(end) / 1e3
        self._pending.clear()


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_range(e) -> bool:
    """A profiler range (``record_function``, a profiler step) rather than
    device work."""
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(("loopbench.", "ProfilerStep")))


def _is_step(e) -> bool:
    """A range that holds a whole call: it names no host activity."""
    return e.name == CALL or e.name.startswith("ProfilerStep")


def _overlap(merged, s: float, e: float) -> float:
    """Length of [s, e] covered by the merged intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged
               if b > s and a < e)


def analyse(events, spans: Spans) -> Trace:
    """Reduce the profiler's ``events`` (``prof.events()``) of the traced
    calls, each inside a ``loopbench.call`` range."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # the device's own activity; the profiler also puts each range on the
    # device's timeline, from its first kernel's start to its last's end
    ranges = [e for e in events if e.device_type != DeviceType.CPU
              and _is_range(e)]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not _is_range(e)]
    calls = [e for e in cpu if e.name == CALL]
    if not calls:
        raise RuntimeError("the trace holds no traced call")
    w0 = min(e.time_range.start for e in calls)
    w1 = max(e.time_range.end for e in calls)
    busy = _union([[max(e.time_range.start, w0), min(e.time_range.end, w1)]
                   for e in dev if e.time_range.end > w0
                   and e.time_range.start < w1])
    busy_us = sum(e - s for s, e in busy)
    # a span's device time: the device's busy time inside the span's range
    # on the device's timeline (the kernels launched through ctypes are not
    # linked to the range's CPU event, so its device_time_total misses them)
    span_us = collections.Counter()
    for e in ranges:
        if e.name.startswith("loopbench.") and e.name != CALL:
            span_us[e.name[len("loopbench."):]] += _overlap(
                busy, e.time_range.start, e.time_range.end)
    by_op = collections.Counter()
    for e in dev:
        by_op[e.name[:NAME_CHARS]] += e.time_range.end - e.time_range.start
    # the host's activity in the longest idle gaps: the innermost CPU range
    # on the calling thread that holds the gap's midpoint
    thread = calls[0].thread
    host = [e for e in cpu if e.thread == thread and not _is_step(e)]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = sorted(((e - s, s, e) for s, e in zip(edges[0::2], edges[1::2])
                   if e > s), reverse=True)[:GAPS_ATTRIBUTED]
    gaps = collections.Counter()
    for length, s, e in idle:
        mid = 0.5 * (s + e)
        inner = max((h for h in host if h.time_range.start <= mid
                     <= h.time_range.end),
                    key=lambda h: h.time_range.start, default=None)
        gaps[inner.name[:NAME_CHARS] if inner is not None
             else "python (no op)"] += length
    return Trace(
        span_device_s={k: v / 1e6 for k, v in span_us.items()},
        span_event_s=dict(spans.event_s),
        span_calls=dict(spans.calls),
        busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
        device_ops=[[k, v / 1e6] for k, v in by_op.most_common(10)],
        idle_gaps=[[k, v / 1e6] for k, v in gaps.most_common(10)])


@contextlib.contextmanager
def counting_syncs(cuda: bool):
    """Count the host's waits for the device inside the block: the
    synchronising operations that torch's sync debug mode warns of, and
    every explicit ``synchronize()`` of a stream or the device, which it
    does not. Yields a dict whose ``"syncs"`` holds the count at the end."""
    box = {"syncs": 0}
    if not cuda:
        yield box
        return
    saved = (torch.cuda.Stream.synchronize, torch.cuda.synchronize)
    explicit = [0]

    def stream_sync(self):
        explicit[0] += 1
        return saved[0](self)

    def device_sync(device=None):
        explicit[0] += 1
        return saved[1](device)

    torch.cuda.Stream.synchronize = stream_sync
    torch.cuda.synchronize = device_sync
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            yield box
        box["syncs"] = explicit[0] + sum(
            "synchroniz" in str(w.message) for w in rec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.Stream.synchronize, torch.cuda.synchronize = saved
