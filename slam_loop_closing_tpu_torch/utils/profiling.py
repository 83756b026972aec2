"""Stage timing on the host clock, synchronised with the device.

PyTorch returns before a CUDA device finishes, so a host clock around CUDA
work measures the enqueue. :class:`StageTimer` synchronises the device at
the start and end of every stage, so each stage's time covers its device
work."""

from __future__ import annotations

import contextlib
import time

import torch


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

    def frames_per_sec(self, num_frames: int) -> float:
        """``num_frames`` over the summed time of every stage."""
        total = sum(self.stages.values())
        return num_frames / total if total > 0 else float("inf")
