"""Map outlier removal by masks: points behind an observing camera, points
with a large reprojection error in any observation, points far from the
camera centroid.

Port of :mod:`slam_loop_closing_tpu.ops.outliers` (reference
main.cpp:1557-1659, threshold main.cpp:51). Points are invalidated, not
compacted; the OBJ writer drops invalid ones, which gives the reference's
output. The per-point "any observation" reductions are
``scatter_reduce_(..., "amax")`` over bool-as-uint8 (the JAX package's
``.at[].max``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_loop_closing_tpu_torch.config import OutlierConfig
from slam_loop_closing_tpu_torch.ops import lie
from slam_loop_closing_tpu_torch.ops.ba import Observations, reprojection_errors


class OutlierResult(NamedTuple):
    point_valid: torch.Tensor   # [P] bool updated validity
    obs_valid: torch.Tensor     # [O] bool observations of surviving points
    n_points_before: torch.Tensor
    n_outliers: torch.Tensor    # points removed (each counted once)
    n_behind: torch.Tensor      # points rejected: behind some camera
    n_reproj: torch.Tensor      # points rejected: reprojection error
    n_far: torch.Tensor         # points rejected: far from the cameras
    distance_threshold: torch.Tensor  # the max(floor, scale * spread) used


def _any_per_point(num_points: int, point: torch.Tensor,
                   flags: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(num_points, dtype=torch.uint8, device=flags.device)
    return out.scatter_reduce_(0, point, flags.to(torch.uint8), "amax") > 0


def remove_outliers(K: torch.Tensor, cam_params: torch.Tensor,
                    cam_valid: torch.Tensor, points: torch.Tensor,
                    point_valid: torch.Tensor, obs: Observations,
                    cfg: OutlierConfig = OutlierConfig()) -> OutlierResult:
    """The reference's three outlier criteria as batched masks."""
    num_points = points.shape[0]
    cam, point = obs.cam.long(), obs.point.long()
    Rs, ts = lie.params_to_pose(cam_params)

    # (a) behind an observing camera: per-observation depth z <= 0
    Xc_z = torch.sum(Rs[cam, 2, :] * points[point], dim=-1) + ts[cam, 2]
    behind_pt = _any_per_point(num_points, point, obs.valid & (Xc_z <= 0.0))

    # (b) reprojection error above the threshold in any observation
    errs = reprojection_errors(K, cam_params, points, obs)
    reproj_pt = _any_per_point(num_points, point,
                               obs.valid & (errs > cfg.reproj_threshold_px))

    # (c) distance from the camera centroid (main.cpp:1601):
    # > max(floor, scale * max camera spread)
    centers = lie.camera_center(Rs, ts)                     # [N, 3]
    cmask = cam_valid[:, None]
    ncam = torch.clamp_min(torch.sum(cam_valid, dtype=torch.float32), 1.0)
    centroid = torch.sum(torch.where(cmask, centers, 0.0), dim=0) / ncam
    dc = centers - centroid
    spread = torch.where(cam_valid, torch.sqrt(torch.sum(dc * dc, dim=-1)),
                         0.0)
    max_dist = torch.clamp_min(cfg.distance_scale * torch.amax(spread),
                               cfg.distance_floor)
    dp = points - centroid
    far_pt = torch.sqrt(torch.sum(dp * dp, dim=-1)) > max_dist

    outlier = point_valid & (behind_pt | reproj_pt | far_pt)
    new_point_valid = point_valid & ~outlier

    def cnt(m):
        return torch.sum(m, dtype=torch.int32)

    return OutlierResult(
        point_valid=new_point_valid,
        obs_valid=obs.valid & new_point_valid[point],
        n_points_before=cnt(point_valid), n_outliers=cnt(outlier),
        n_behind=cnt(point_valid & behind_pt),
        n_reproj=cnt(point_valid & reproj_pt),
        n_far=cnt(point_valid & far_pt), distance_threshold=max_dist)
