"""Stage timing on the host clock, synchronised with the device, and
``torch.profiler`` trace capture around a block (:func:`trace`).

PyTorch returns before a CUDA device finishes, so a host clock around CUDA
work measures the enqueue. :class:`StageTimer` synchronises the device at
the start and end of every stage, so each stage's time covers its device
work."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace (host and CUDA activity) around a
    block and write it as ``trace.json`` (Chrome trace format) into
    ``log_dir``. No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """Named range for device timelines: a context manager
    (``torch.profiler.record_function``) whose block shows under ``name`` in
    a :func:`trace`."""
    return torch.profiler.record_function(name)


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
