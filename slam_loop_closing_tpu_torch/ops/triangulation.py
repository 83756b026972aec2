"""Gated two-view triangulation with per-rejection-class counters.

Port of :mod:`slam_loop_closing_tpu.ops.triangulation` (the triangulation
block of the reference's keyframe loop, main.cpp:1221-1346): linear
triangulation of the inlier matches, then cheirality in both views, relative
depth within [min, max] x baseline, parallax >= the minimum and reprojection
<= the maximum in both views, as masks over the fixed-size match array, with
the counters the reference prints (main.cpp:1343-1346).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_loop_closing_tpu_torch.config import TriangulationConfig
from slam_loop_closing_tpu_torch.ops import camera as camera_ops
from slam_loop_closing_tpu_torch.ops import epipolar, lie


class TriangulationResult(NamedTuple):
    X: torch.Tensor           # [N, 3] world points (junk where not accepted)
    accept: torch.Tensor      # [N] bool, passed every gate
    depths1: torch.Tensor     # [N] camera-1 depths
    n_input: torch.Tensor     # int32 candidate count
    n_behind: torch.Tensor    # int32 rejected: behind a camera
    n_depth: torch.Tensor     # int32 rejected: depth outside [min,max]*baseline
    n_parallax: torch.Tensor  # int32 rejected: parallax below threshold
    n_reproj: torch.Tensor    # int32 rejected: reprojection error too large


def triangulate_gated(K: torch.Tensor, R1: torch.Tensor, t1: torch.Tensor,
                      R2: torch.Tensor, t2: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                      mask: torch.Tensor,
                      cfg: TriangulationConfig = TriangulationConfig()
                      ) -> TriangulationResult:
    """Triangulate matched pairs between two posed views and gate them.
    ``x1``, ``x2`` [N, 2] are normalized coordinates, ``uv1``, ``uv2`` the
    same matches in pixels (the reprojection gate), ``mask`` [N] the
    candidate matches (RANSAC inliers)."""
    X = epipolar.triangulate_linear(R1, t1, R2, t2, x1, x2)
    z1 = epipolar.depths(R1, t1, X)
    z2 = epipolar.depths(R2, t2, X)
    in_front = (z1 > 0) & (z2 > 0)

    C1 = lie.camera_center(R1, t1)
    C2 = lie.camera_center(R2, t2)
    d = C2 - C1
    baseline = torch.clamp_min(torch.sqrt(torch.sum(d * d)), 1e-12)
    rel_depth = z1 / baseline
    depth_ok = (rel_depth >= cfg.min_depth_rel) & (rel_depth <= cfg.max_depth_rel)

    parallax_ok = epipolar.parallax_angle_deg(C1, C2, X) >= cfg.min_parallax_deg

    e1 = camera_ops.reproj_error(K, R1, t1, X, uv1)
    e2 = camera_ops.reproj_error(K, R2, t2, X, uv2)
    reproj_ok = ((e1 <= cfg.max_reproj_error_px)
                 & (e2 <= cfg.max_reproj_error_px))

    accept = mask & in_front & depth_ok & parallax_ok & reproj_ok

    # counters in the reference's gate order (main.cpp:1261-1341):
    # behind -> depth -> parallax -> reproj
    def cnt(m):
        return torch.sum(m, dtype=torch.int32)

    return TriangulationResult(
        X=X, accept=accept, depths1=z1, n_input=cnt(mask),
        n_behind=cnt(mask & ~in_front),
        n_depth=cnt(mask & in_front & ~depth_ok),
        n_parallax=cnt(mask & in_front & depth_ok & ~parallax_ok),
        n_reproj=cnt(mask & in_front & depth_ok & parallax_ok & ~reproj_ok))
