"""Batched essential-matrix RANSAC.

Port of :mod:`slam_loop_closing_tpu.ops.ransac`. A fixed batch of
hypotheses replaces OpenCV's adaptive loop (reference main.cpp:568-618):

1. :func:`sample_minimal_sets`: ``H`` 8-point minimal sets at once by
   Gumbel top-k over the validity mask, PROSAC-progressive when a match
   quality is given;
2. :func:`essential_from_samples`: all ``H`` epipolar models as one batched
   Householder-QR nullspace, all ``H x N`` Sampson errors, the best count,
   LO-RANSAC refits of the winner, then (R, t) by the cheirality vote.

Both take optional leading pair axes: the SfM loop search verifies a chunk
of candidate pairs in one pass (the JAX package's
``estimate_essential_ransac_pairs``, a vmap).

Sampling and solving are split because random numbers do not carry across
frameworks: the JAX package draws ``jax.random.gumbel`` noise and takes an
approximate top-k, the port draws its noise from a ``torch.Generator`` and
takes the exact ``torch.topk``. Tests feed the JAX package's sampled indices
into :func:`essential_from_samples`, where the two must agree.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_loop_closing_tpu_torch.config import RansacConfig
from slam_loop_closing_tpu_torch.ops import epipolar


def hypotheses_for(confidence: float, inlier_ratio: float,
                   sample_size: int = 8) -> int:
    """Minimum fixed hypothesis budget H with the classic RANSAC guarantee
    ``(1 - w^s)^H <= 1 - confidence`` (reference main.cpp:589's prob=0.999
    recast for a fixed batch)."""
    w = min(max(inlier_ratio, 1e-6), 1.0 - 1e-6)
    miss = 1.0 - w ** sample_size
    return max(1, math.ceil(math.log(max(1.0 - confidence, 1e-12))
                            / math.log(miss)))


def resolved_hypotheses(cfg: RansacConfig) -> int:
    """The hypothesis budget a config runs: an explicit ``num_hypotheses``
    wins; 0 derives it from ``confidence`` at the design inlier ratio."""
    if cfg.num_hypotheses:
        return cfg.num_hypotheses
    return hypotheses_for(cfg.confidence, cfg.design_inlier_ratio,
                          cfg.min_points)


class EssentialResult(NamedTuple):
    """Result of :func:`essential_from_samples` (all device tensors)."""

    E: torch.Tensor            # [3, 3] essential matrix
    R: torch.Tensor            # [3, 3] relative rotation (cam1 -> cam2)
    t: torch.Tensor            # [3] unit-norm relative translation
    inliers: torch.Tensor      # [N] bool Sampson-inlier mask
    num_inliers: torch.Tensor  # int32
    pose_inliers: torch.Tensor      # [N] bool inliers passing cheirality
    num_pose_inliers: torch.Tensor  # int32
    ok: torch.Tensor           # bool: reference gates (>=8 pts, >=min_inliers)


def gumbel_noise(generator: torch.Generator, num_hypotheses: int,
                 n: int, batch: tuple[int, ...] = ()) -> torch.Tensor:
    """[*batch, H, N] float32 standard Gumbel noise from ``generator``, on
    its device; drawing advances the generator on the host, with no device
    read."""
    u = torch.rand((*batch, num_hypotheses, n), generator=generator,
                   device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_minimal_sets(noise: torch.Tensor, mask: torch.Tensor,
                        sample_size: int,
                        quality: torch.Tensor | None = None) -> torch.Tensor:
    """[..., H, sample_size] distinct indices per hypothesis: the top
    ``sample_size`` of each row of ``noise`` [..., H, N] among the allowed
    entries of ``mask`` [..., N]. Without ``quality`` every valid entry is
    allowed; with it
    (higher = more confident) hypothesis h draws from the top ``m_h``
    matches by quality rank, ``m_h`` growing geometrically from 4x the
    sample size to the valid count across the batch (PROSAC, Chum & Matas
    2005, recast for a fixed batch). Ranks come from a stable sort, as
    ``jnp.argsort``'s."""
    num_h, n = noise.shape[-2:]
    dev = noise.device
    if quality is None:
        g = torch.where(mask[..., None, :], noise, -torch.inf)
    else:
        q = torch.where(mask, quality.to(torch.float32), -torch.inf)
        order = torch.argsort(-q, dim=-1, stable=True)
        rank = torch.empty(q.shape, dtype=torch.int32, device=dev).scatter_(
            -1, order, torch.arange(n, dtype=torch.int32,
                                    device=dev).expand(q.shape))
        nv = torch.sum(mask, dim=-1, dtype=torch.int32).to(
            torch.float32)[..., None, None]
        pool0 = torch.full((), 4.0 * sample_size, device=dev)
        # divisors are device tensors: CUDA divides by a host scalar as a
        # multiply by its reciprocal, which can move `pool` by an ulp
        frac = (torch.arange(num_h, dtype=torch.float32, device=dev)[:, None]
                / torch.full((), float(max(num_h - 1, 1)), device=dev))
        pool = pool0 * (torch.maximum(nv, pool0) / pool0) ** frac   # [H, 1]
        allowed = ((rank[..., None, :].to(torch.float32) < pool)
                   & mask[..., None, :])
        g = torch.where(allowed, noise, -torch.inf)
    return torch.topk(g, sample_size, dim=-1).indices


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar filled on ``device`` (no copy from host memory)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def essential_from_samples(x1: torch.Tensor, x2: torch.Tensor,
                           mask: torch.Tensor, idx: torch.Tensor,
                           focal: torch.Tensor | float,
                           cfg: RansacConfig = RansacConfig()
                           ) -> EssentialResult:
    """The RANSAC solver on given minimal sets ``idx`` [..., H, 8]: batched
    nullspace models, Sampson inlier counts (a hypothesis whose sample
    touches an invalid row scores 0), LO-RANSAC refits of the winner, the
    cheirality vote. ``x1``, ``x2`` [..., N, 2] are normalized coordinates
    and ``mask`` [..., N] their validity, with the same leading pair axes as
    ``idx``; ``focal`` is the mean focal length in pixels (converts
    ``cfg.threshold_px``; a Python float is squared in double precision, a
    tensor in float32, as in the JAX package)."""
    dev = x1.device
    num_valid = torch.sum(mask, dim=-1, dtype=torch.int32)
    if isinstance(focal, torch.Tensor):
        thresh_sq = (_f32(cfg.threshold_px, dev) / focal) ** 2
    else:
        thresh_sq = _f32((cfg.threshold_px / focal) ** 2, dev)

    idx = idx.long()
    # [..., H, 8, 2] sample points: each pair's rows at its own indices
    p1 = torch.take_along_dim(x1[..., None, :, :], idx[..., None], dim=-2)
    p2 = torch.take_along_dim(x2[..., None, :, :], idx[..., None], dim=-2)
    # minimal-sample models scored raw, not projected (only the winner is)
    Fs = epipolar.nullspace_8x9(epipolar.epipolar_design(p1, p2))
    Fs = Fs.reshape(*idx.shape[:-1], 3, 3)
    errs = epipolar.sampson_error(Fs, x1[..., None, :, :],
                                  x2[..., None, :, :])    # [..., H, N]
    inlier_mat = (errs < thresh_sq) & mask[..., None, :]
    counts = torch.sum(inlier_mat, dim=-1, dtype=torch.int32)
    sample_ok = torch.all(torch.take_along_dim(mask[..., None, :], idx,
                                               dim=-1), dim=-1)
    counts = torch.where(sample_ok, counts, 0)
    counts = torch.where(num_valid[..., None] >= cfg.min_points, counts, 0)
    best = torch.argmax(counts, dim=-1)                   # [...]

    # LO-RANSAC: iterated weighted 8-point refits from the winner's inliers;
    # the best-scoring model seen is kept, the projected raw winner included
    cur_inliers = torch.take_along_dim(inlier_mat, best[..., None, None],
                                       dim=-2)[..., 0, :]
    E = epipolar.project_to_essential(torch.take_along_dim(
        Fs, best[..., None, None, None], dim=-3)[..., 0, :, :])
    inliers = (epipolar.sampson_error(E, x1, x2) < thresh_sq) & mask
    num_inliers = torch.sum(inliers, dim=-1, dtype=torch.int32)
    for _ in range(cfg.refit_iters):
        E_r = epipolar.essential_eight_point(x1, x2,
                                             cur_inliers.to(x1.dtype))
        r_inliers = (epipolar.sampson_error(E_r, x1, x2) < thresh_sq) & mask
        r_count = torch.sum(r_inliers, dim=-1, dtype=torch.int32)
        take = r_count >= num_inliers
        E = torch.where(take[..., None, None], E_r, E)
        inliers = torch.where(take[..., None], r_inliers, inliers)
        num_inliers = torch.maximum(r_count, num_inliers)
        cur_inliers = r_inliers

    R, t, pose_inliers, num_pose = epipolar.recover_pose(E, x1, x2, inliers)
    ok = (num_valid >= cfg.min_points) & (num_inliers >= cfg.min_inliers)
    return EssentialResult(E=E, R=R, t=t, inliers=inliers,
                           num_inliers=num_inliers, pose_inliers=pose_inliers,
                           num_pose_inliers=num_pose, ok=ok)


def estimate_essential_ransac(x1: torch.Tensor, x2: torch.Tensor,
                              mask: torch.Tensor, generator: torch.Generator,
                              focal: torch.Tensor | float,
                              cfg: RansacConfig = RansacConfig(),
                              quality: torch.Tensor | None = None
                              ) -> EssentialResult:
    """Batched-RANSAC essential matrix between two normalized point sets:
    :func:`sample_minimal_sets` on noise from ``generator`` (on the points'
    device), then :func:`essential_from_samples`. Leading pair axes of
    ``x1``, ``x2`` [..., N, 2] verify many pairs at once (the JAX package's
    ``estimate_essential_ransac_pairs``)."""
    noise = gumbel_noise(generator, resolved_hypotheses(cfg), x1.shape[-2],
                         tuple(x1.shape[:-2]))
    idx = sample_minimal_sets(noise, mask, cfg.min_points, quality)
    return essential_from_samples(x1, x2, mask, idx, focal, cfg)
