"""The port's spans (:func:`annotate`, :func:`count`, :func:`spans`),
``torch.profiler`` trace capture around a block (:func:`trace`), and stage
timing on the host clock, synchronised with the device (:class:`StageTimer`).

A span is a named stage of the program, ``slam.<layer>.<stage>``. The
profiler is its only switch: while no ``torch.profiler`` session records,
:func:`annotate` returns one shared no-op context, and a span costs one
flag read. While a session records, a span opens a profiler range of its
name and keeps a record in memory:

* ``name``; ``id``; ``parent``, the id of the enclosing span (None at the
  outermost); ``request``, the id of the outermost open span, shared by
  every span of one call;
* ``start_ns`` and ``end_ns`` on ``time.time_ns()``, the clock of the
  profiler's ``trace_start_ns()``; ``host_ms`` between them;
* ``device_ms``: in a process that uses CUDA, the current stream's time
  from the span's entry to its exit (a pair of CUDA events, idle time
  included), resolved when the records are read; None otherwise;
* ``counters``: given at entry or added inside with :func:`count`.

The range is a function-scope one (``_RecordFunctionFast``, the range
``torch.compile``'s graphs open), not a user annotation
(``record_function``): the profiler gives a device kernel to the innermost
user annotation alone, so a span inside a caller's ``record_function``
would take the caller's kernels, and its range on the device timeline.
The spans show on the host's timeline, and a kernel is found under its
launching operator's spans.

PyTorch returns before a CUDA device finishes, so a host clock around CUDA
work measures the enqueue. :class:`StageTimer` synchronises the device at
the start and end of every stage, so each stage's time covers its device
work."""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_open = threading.local()      # .stack: this thread's open spans
_done: list[dict] = []         # finished records, in the order they ended
_pending: list[tuple] = []     # (record, start event, end event)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    """One span opened while a profiler session records."""

    __slots__ = ("record", "_range", "_start")

    def __init__(self, name: str, counters: dict):
        self.record = {"name": name, "id": next(_ids), "parent": None,
                       "request": None, "start_ns": 0, "end_ns": 0,
                       "host_ms": 0.0, "device_ms": None,
                       "counters": counters}

    def __enter__(self):
        rec = self.record
        stack = _stack()
        if stack:
            rec["parent"] = stack[-1].record["id"]
            rec["request"] = stack[-1].record["request"]
        else:
            rec["request"] = rec["id"]
        stack.append(self)
        self._range = torch._C._profiler._RecordFunctionFast(rec["name"])
        self._range.__enter__()
        rec["start_ns"] = time.time_ns()
        self._start = None
        if torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        rec = self.record
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((rec, self._start, end))
        rec["end_ns"] = time.time_ns()
        rec["host_ms"] = (rec["end_ns"] - rec["start_ns"]) / 1e6
        self._range.__exit__(*exc)
        _stack().pop()
        _done.append(rec)
        return False


def annotate(name: str, **counters):
    """Span ``name`` around a block (a context manager). Off the profiler,
    a shared no-op. A span opened while a span of the same name is open on
    the thread is folded into that one (no record, no range), so a stage
    whose functions call each other is recorded, and counted, once."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    for span in _stack():
        if span.record["name"] == name:
            return _OFF
    return _Span(name, counters)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the innermost open span."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        counters = stack[-1].record["counters"]
        counters[key] = counters.get(key, 0) + n


def spans() -> list[dict]:
    """The finished span records, in the order they ended, each span's
    CUDA events resolved into its ``device_ms`` (waiting for them where
    the device has not reached them). The records are kept."""
    resolved = len(_pending)
    for rec, start, end in _pending[:resolved]:
        end.synchronize()
        rec["device_ms"] = start.elapsed_time(end)
    del _pending[:resolved]
    return list(_done)


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace (host and CUDA activity) around a
    block and write it as ``trace.json`` (Chrome trace format) into
    ``log_dir``, with the block's span records as ``spans.json`` (a list,
    one object a span). No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    _done.clear()
    _pending.clear()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    (Path(log_dir) / "spans.json").write_text(json.dumps(spans(), indent=1))


class StageTimer:
    """Wall-clock stage timing on ``device`` with a frames/sec summary."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stages: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def frames_per_sec(self, num_frames: int,
                       stage: str | None = None) -> float:
        """``num_frames`` over the time of ``stage``, or over the summed
        time of every stage."""
        total = (self.stages.get(stage, 0.0) if stage
                 else sum(self.stages.values()))
        return num_frames / total if total > 0 else float("inf")

    def summary(self) -> str:
        """The ``Stage timings:`` block the CLI prints, a line per stage."""
        lines = [f"  {k}: {v:.3f}s" for k, v in self.stages.items()]
        return "Stage timings:\n" + "\n".join(lines)
