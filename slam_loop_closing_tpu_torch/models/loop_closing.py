"""The Version-A ``LoopClosingSystem``, batched path: ORB features of a whole
frame stack, ONE banded all-pairs good-match pass, and the loop rule.

Port of the batched half of
:mod:`slam_loop_closing_tpu.models.loop_closing`: :meth:`process_video`,
:meth:`get_loop_closures` and :meth:`save_results` (``loop_closures.txt``).
A loop fires between frames i and j <= i - ``min_loop_gap`` when
``similarity = matches / min(n_i, n_j) > loop_threshold`` AND the pair has
at least ``min_matches`` good matches (README.md:119-126 of the reference);
candidates come in (i, j) row-major order, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from slam_loop_closing_tpu_torch.config import CameraConfig, PipelineConfig
from slam_loop_closing_tpu_torch.ops import matching, orb
from slam_loop_closing_tpu_torch.ops.image import ship_frames
from slam_loop_closing_tpu_torch.utils import io as io_utils


@dataclasses.dataclass
class LoopCandidate:
    """Mirror of the reference's ``LoopCandidate`` (loop_closing.hpp:22-27)."""

    current_frame_id: int
    matched_frame_id: int
    num_matches: int
    similarity_score: float


class LoopClosingSystem:
    """Batched Version-A loop detector on one explicit ``device`` (a
    ``torch.device`` or its name, e.g. ``"cuda"`` or ``"cpu"``).
    ``max_frames`` bounds the frame stack one :meth:`process_video` call may
    take, as in the JAX package."""

    def __init__(self, config: PipelineConfig | None = None,
                 max_frames: int = 512, *, device):
        if config is None:
            # Version-A default: the README's assumed intrinsics
            # fx=fy=800, cx=640, cy=360 (README.md:137)
            config = dataclasses.replace(PipelineConfig(),
                                         camera=CameraConfig.assumed())
        self.config = config
        self.max_frames = max_frames
        self.device = torch.device(device)
        self._pattern = orb.brief_matrices(config.orb, self.device)
        self.loop_closures: list[LoopCandidate] = []
        self._frame_ids: list[int] = []

    def process_video(self, frames, frame_ids: list[int] | None = None
                      ) -> list[LoopCandidate]:
        """Loop detection over a ``[B, H, W]`` frame stack (numpy or tensor,
        uint8 or float in [0, 1]): batched ORB front-end, banded all-pairs
        good-match counts, loop rule. Returns the new loops."""
        b = frames.shape[0]
        if b > self.max_frames:
            raise ValueError("frame stack exceeds max_frames")
        ids = list(frame_ids) if frame_ids is not None else list(range(b))
        feats = orb.detect_and_describe_batch(
            ship_frames(frames, self.device), self.config.orb, self._pattern)
        valid = feats.keypoints.valid
        nfeat = torch.sum(valid, dim=1, dtype=torch.int32)

        cfg = self.config.loop
        new_loops: list[LoopCandidate] = []
        if b > cfg.min_loop_gap:
            counts = matching.banded_pair_counts(
                feats.signed, valid, cfg.min_loop_gap,
                self.config.match.hamming_filter_scale)
            sims = matching.similarity(counts, nfeat[:, None], nfeat[None, :])
            counts = counts.cpu().numpy()
            sims = sims.cpu().numpy()
            band = np.tril(np.ones((b, b), bool), -cfg.min_loop_gap)
            hits = band & (sims > cfg.loop_threshold) & (
                counts >= cfg.min_matches)
            for i, j in np.argwhere(hits):
                new_loops.append(LoopCandidate(ids[i], ids[j],
                                               int(counts[i, j]),
                                               float(sims[i, j])))
        self.loop_closures.extend(new_loops)
        self._frame_ids = ids
        return new_loops

    def get_loop_closures(self) -> list[LoopCandidate]:
        return self.loop_closures

    def save_results(self, out_dir: str | Path) -> Path:
        """``loop_closures.txt`` in the reference's format
        (README.md:150-166). The PNG visualisations of the JAX package are
        not ported."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        return io_utils.write_loop_closures_txt(
            out / "loop_closures.txt",
            [{"current": c.current_frame_id, "matched": c.matched_frame_id,
              "num_matches": c.num_matches, "similarity": c.similarity_score}
             for c in self.loop_closures],
            total_frames=len(self._frame_ids))
