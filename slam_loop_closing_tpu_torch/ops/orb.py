"""ORB: oriented-FAST keypoints + rotated-BRIEF 256-bit descriptors.

Port of :mod:`slam_loop_closing_tpu.ops.orb` over a leading batch of
frames (the JAX package vmaps a per-frame function; here the batch axis is
written out):

1. :mod:`.fast` gives NMS-suppressed FAST scores and top-K keypoints per
   pyramid level (fixed per-level budgets), plus the sigma-2 descriptor
   blur;
2. one 32x32 patch of the blurred level per keypoint
   (:func:`extract_patches_fast`, a CUDA kernel on the card);
3. the intensity-centroid angle from ONE moment product
   (:func:`orientation_from_patches`);
4. rotated BRIEF with the rotation quantized to 30 bins: per bin one
   product of the bf16 patches with the bin's +-1 difference matrix; a bit
   is ``sign(bf16(B) - bf16(A))`` (:func:`brief_from_patches_binned`).

The numpy builders (pattern, moment weights, bin matrices, level budgets)
are copies of the JAX package's, held bitwise equal by the tests.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slam_loop_closing_tpu_torch.config import OrbConfig
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import fast as fast_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops

PATCH_RADIUS = 15  # patch_size 31 -> radius 15 (cv::ORB HARRIS patchSize)
PATCH = 32         # patch side; rotated BRIEF offsets clip to the patch
PATCH_CENTER = PATCH // 2 - 1  # nominal patch center (15) of an integer keypoint


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint sets of a batch of frames (padded,
    mask-valid)."""

    xy: torch.Tensor        # [B, K, 2] float32 (x, y) in level-0 pixels
    response: torch.Tensor  # [B, K] float32 detector response
    angle: torch.Tensor     # [B, K] float32 radians
    octave: torch.Tensor    # [B, K] int32 pyramid level
    valid: torch.Tensor     # [B, K] bool


class OrbFeatures(NamedTuple):
    keypoints: Keypoints
    descriptors: torch.Tensor  # [B, K, 8] int32 packed 256-bit rBRIEF
    signed: torch.Tensor       # [B, K, 256] int8 +-1, invalid rows zero


def make_pattern(seed: int, bits: int = 256, patch_size: int = 31) -> np.ndarray:
    """Deterministic BRIEF sampling pattern: [bits, 2, 2] float32 (two (x, y)
    offsets per bit), i.i.d. Gaussian with sigma = patch/5, clipped to the
    patch (BRIEF G-II pattern)."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    lim = patch_size // 2
    pts = rng.normal(0.0, sigma, size=(bits, 2, 2))
    return np.clip(pts, -lim, lim).astype(np.float32)


def extract_patches(imgs: torch.Tensor, xy: torch.Tensor, patch: int = PATCH,
                    center: int = PATCH_CENTER):
    """[B, K, patch, patch] pixel patches of ``[B, H, W]`` frames around
    ``[B, K, 2]`` integer keypoints, the window at
    ``(clamp(x - center, 0, W - patch), clamp(y - center, 0, H - patch))``,
    plus the [B, K, 2] actual (cx, cy) center offsets (they differ from the
    nominal center only where the window clamps at a border). The plain
    gather; :func:`extract_patches_fast` runs it as a CUDA kernel."""
    b, h, w = imgs.shape
    k = xy.shape[1]
    x0 = torch.clamp(xy[..., 0].to(torch.int64) - center, 0, w - patch)
    y0 = torch.clamp(xy[..., 1].to(torch.int64) - center, 0, h - patch)
    off = torch.arange(patch, device=imgs.device)
    idx = ((y0[..., None, None] + off[:, None]) * w
           + (x0[..., None, None] + off[None, :]))          # [B, K, p, p]
    patches = torch.gather(imgs.reshape(b, h * w), 1,
                           idx.reshape(b, -1)).reshape(b, k, patch, patch)
    centers = xy - torch.stack([x0, y0], dim=-1).to(xy.dtype)
    return patches, centers


def extract_patches_fast(imgs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[B, K, 32, 32] patches through the patch-gather kernel (its plain
    version on a CPU tensor)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    return cuda_kernels.extract_patches(imgs, xy)


def _orientation_moment_weights(patch: int = PATCH,
                                radius: int = PATCH_RADIUS) -> np.ndarray:
    """[patch*patch, 2] weights such that ``patch_flat @ W = (m10, m01)``
    over the circular window centered at the nominal center."""
    offs = np.arange(patch, dtype=np.float32) - PATCH_CENTER
    dy = offs[:, None] * np.ones((1, patch), np.float32)
    dx = np.ones((patch, 1), np.float32) * offs[None, :]
    circ = (dx ** 2 + dy ** 2) <= radius ** 2
    w10 = np.where(circ, dx, 0.0).reshape(-1)
    w01 = np.where(circ, dy, 0.0).reshape(-1)
    return np.stack([w10, w01], axis=1)


def orientation_from_patches(patches: torch.Tensor, valid: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles of ``[K, P, P]`` patches: the (m10, m01)
    moments are ONE [K, P*P] @ [P*P, 2] float32 product. [K] radians, 0 for
    invalid rows."""
    m = patches.reshape(patches.shape[0], -1) @ weights
    return torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), 0.0)


def make_brief_bin_matrices(pattern: np.ndarray, num_bins: int = 30,
                            patch: int = PATCH) -> np.ndarray:
    """[num_bins, patch*patch, 512] one-hot sampling matrices: bin b's matrix
    maps a flattened patch to the 512 nearest-pixel samples of the pattern
    rotated by ``2*pi*b/num_bins``. Columns [0:256] are point A of each
    pair, [256:512] point B; rotated positions clip to the patch."""
    out = np.zeros((num_bins, patch * patch, 512), np.float32)
    for b in range(num_bins):
        th = 2.0 * np.pi * b / num_bins
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s], [s, c]], np.float32)
        pts = pattern @ rot.T
        pos = pts + PATCH_CENTER
        xi = np.clip(np.round(pos[..., 0]).astype(int), 0, patch - 1)
        yi = np.clip(np.round(pos[..., 1]).astype(int), 0, patch - 1)
        flat_idx = yi * patch + xi
        cols = np.arange(256)
        out[b, flat_idx[:, 0], cols] = 1.0
        out[b, flat_idx[:, 1], cols + 256] = 1.0
    return out


def brief_from_patches_binned(patches: torch.Tensor, angle: torch.Tensor,
                              valid: torch.Tensor,
                              D: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits of ``[K, P, P]`` patches: [K, 256] uint8. Each
    keypoint's angle picks a bin, ``round(angle / step) mod bins`` (round
    half to even, floor modulo); per bin, one bf16 product of the patches
    with the bin's difference matrix ``D[b]`` (+1 at point B, -1 at point A)
    gives ``bf16(B) - bf16(A)`` (rounded to bf16, which keeps its sign), and
    the bin mask selects among the OUTPUTS. ``bit = diff > 0``."""
    k = patches.shape[0]
    num_bins = D.shape[0]
    flat = patches.reshape(k, -1).to(torch.bfloat16)
    # a step tensor (not a Python scalar): CUDA divides by a host scalar as
    # a multiply by its reciprocal, which can round differently
    step = torch.full((), 2.0 * math.pi / num_bins, dtype=torch.float32,
                      device=angle.device)
    bins = torch.remainder(torch.round(angle / step).to(torch.int32), num_bins)
    diff = torch.zeros((k, D.shape[2]), dtype=torch.bfloat16,
                       device=patches.device)
    for b in range(num_bins):
        dot = flat @ D[b].to(torch.bfloat16)
        diff = torch.where((bins == b)[:, None], dot, diff)
    bits = (diff > 0).to(torch.uint8)
    return torch.where(valid[:, None], bits, 0).to(torch.uint8)


def _level_budgets(num_features: int, num_levels: int,
                   scale_factor: float) -> list[int]:
    """Per-level keypoint budgets proportional to 1/scale**level (the same
    geometric distribution cv::ORB uses), summing exactly to num_features."""
    inv = [scale_factor ** -i for i in range(num_levels)]
    total = sum(inv)
    budgets = [int(round(num_features * v / total)) for v in inv]
    budgets[0] += num_features - sum(budgets)
    return budgets


@functools.cache
def _brief_matrices_np(seed: int, bits: int, patch_size: int,
                       bins: int) -> np.ndarray:
    g = make_brief_bin_matrices(make_pattern(seed, bits, patch_size), bins)
    return g[..., 256:] - g[..., :256]


def brief_matrices(cfg: OrbConfig, device) -> torch.Tensor:
    """[bins, P*P, 256] float32 DIFFERENCE matrices of a config on
    ``device``: bin b's matrix has +1 at pair j's point-B pixel and -1 at its
    point-A pixel (0 where both land on one pixel: bit 0, the strict
    ``A < B`` comparison's tie)."""
    return torch.tensor(_brief_matrices_np(
        cfg.pattern_seed, cfg.descriptor_bits, cfg.patch_size,
        cfg.brief_bins), device=device)


def _detect_level(level_imgs: torch.Tensor, level: int, budget: int,
                  cfg: OrbConfig):
    """Per-level detection + patch extraction of ``[B, h, w]`` frames:
    (xy in level-0 pixels, response, octave, valid, patches). The patches
    come from the blurred level and serve both orientation and BRIEF."""
    xy, resp, valid, blurred = fast_ops.detect_with_blur(
        level_imgs, threshold=cfg.fast_threshold / 255.0, num_features=budget,
        nms_radius=cfg.nms_radius, border=cfg.border,
        grid_cell=cfg.grid_cell, blur_sigma=2.0, blur_radius=3)
    patches = extract_patches_fast(blurred, xy)
    xy0 = xy * (cfg.scale_factor ** level)
    octv = torch.full(valid.shape, level, dtype=torch.int32,
                      device=valid.device)
    return xy0, resp, octv, valid, patches


def detect_and_describe_batch(imgs: torch.Tensor, cfg: OrbConfig = OrbConfig(),
                              pattern: torch.Tensor | None = None
                              ) -> OrbFeatures:
    """Full ORB on ``[B, H, W]`` float32 frames -> fixed-size features with
    exactly ``cfg.num_features`` slots per frame. ``pattern`` is the
    :func:`brief_matrices` stack on the frames' device (built if None).
    Orientation and BRIEF run once over the concatenated all-level patch
    set."""
    if pattern is None:
        pattern = brief_matrices(cfg, imgs.device)
    levels = image_ops.pyramid(imgs, cfg.num_levels, cfg.scale_factor)
    budgets = _level_budgets(cfg.num_features, cfg.num_levels,
                             cfg.scale_factor)
    parts = [_detect_level(lv, lvl, budget, cfg)
             for lvl, (lv, budget) in enumerate(zip(levels, budgets))
             if budget > 0]
    xy, resp, octv, val, patches = (torch.cat(p, dim=1) for p in zip(*parts))
    b, k = val.shape
    flat_patches = patches.reshape(b * k, PATCH, PATCH)
    flat_val = val.reshape(-1)
    mw = torch.from_numpy(_orientation_moment_weights()).to(imgs.device)
    ang = orientation_from_patches(flat_patches, flat_val, mw)
    bits = brief_from_patches_binned(flat_patches, ang, flat_val, pattern)
    bits = bits.reshape(b, k, desc_ops.BITS)
    signed = torch.where(val[..., None], desc_ops.bits_to_signed(bits),
                         0).to(torch.int8)
    kps = Keypoints(xy=xy, response=resp, angle=ang.reshape(b, k),
                    octave=octv, valid=val)
    return OrbFeatures(keypoints=kps,
                       descriptors=desc_ops.bits_to_packed(bits),
                       signed=signed)
