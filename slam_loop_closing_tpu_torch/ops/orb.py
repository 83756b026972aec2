"""ORB: oriented-FAST keypoints + rotated-BRIEF 256-bit descriptors.

Port of :mod:`slam_loop_closing_tpu.ops.orb` over a leading batch of
frames (the JAX package vmaps a per-frame function; here the batch axis is
written out):

1. :mod:`.fast` gives NMS-suppressed FAST scores and top-K keypoints per
   pyramid level (fixed per-level budgets), plus the sigma-2 descriptor
   blur;
2. one 32x32 patch of the blurred level per keypoint
   (:func:`extract_patches_fast`, a CUDA kernel on the card);
3. the intensity-centroid angle from the moments summed in a fixed order
   (:func:`orientation_from_patches`, a CUDA kernel on the card);
4. rotated BRIEF with the rotation quantized to 30 bins: a bit is
   ``bf16(B) > bf16(A)`` at the pixel pair of the keypoint's bin
   (:func:`brief_pairs`), written as the packed and the signed descriptors
   (:func:`..cuda_kernels.brief_bits`, a CUDA kernel on the card);
   :func:`brief_from_patches_binned`, the JAX package's form (per bin one
   product of the bf16 patches with the bin's +-1 difference matrix, the
   sign of ``bf16(B) - bf16(A)``), is its oracle.

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
from slam_loop_closing_tpu_torch.utils import profiling

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


def orientation(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                patch_radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Intensity-centroid orientation of the keypoints ``xy`` [K, 2] of one
    frame ``img`` [H, W]: ``atan2(m01, m10)`` with the moments over a
    circular window of ``patch_radius`` (IC_Angle in cv::ORB), the window
    clamped into the frame. [K] float32 radians, 0 for invalid keypoints.
    The gather form; the pipeline takes the moments from the 32x32 patches
    (:func:`orientation_from_patches`)."""
    d = 2 * patch_radius + 1
    h, w = img.shape
    offs = torch.arange(-patch_radius, patch_radius + 1, dtype=torch.float32,
                        device=img.device)
    circ = (offs[:, None] ** 2 + offs[None, :] ** 2) <= patch_radius ** 2
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - patch_radius, 0, w - d)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - patch_radius, 0, h - d)
    win = torch.arange(d, device=img.device)
    patches = img[(y0[:, None] + win)[:, :, None],
                  (x0[:, None] + win)[:, None, :]]           # [K, d, d]
    pw = torch.where(circ, patches, 0.0)
    m10 = torch.sum(pw * offs[None, None, :], dim=(1, 2))   # x moment
    m01 = torch.sum(pw * offs[None, :, None], dim=(1, 2))   # y moment
    return torch.where(valid, torch.atan2(m01, m10), 0.0)


def _rotated_pattern(angle: torch.Tensor,
                     pattern: torch.Tensor) -> torch.Tensor:
    """[K, 256, 2, 2] offsets of ``pattern`` [256, 2, 2] rotated by each
    keypoint's ``angle`` [K]."""
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([c, -s], -1),
                       torch.stack([s, c], -1)], -2)        # [K, 2, 2]
    return torch.einsum("kab,pqb->kpqa", rot, pattern)


def brief_descriptors(img_blurred: torch.Tensor, xy: torch.Tensor,
                      angle: torch.Tensor, valid: torch.Tensor,
                      pattern: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits of the keypoints of one pre-blurred frame
    [H, W]: [K, 256] uint8. Every pair of ``pattern`` [256, 2, 2] is rotated
    by the keypoint's exact angle, sampled bilinearly from the frame and
    compared (``A < B``); invalid keypoints get zero bits."""
    pos = _rotated_pattern(angle, pattern) + xy[:, None, None, :]
    samples = image_ops.bilinear_sample(img_blurred, pos)   # [K, 256, 2]
    bits = (samples[..., 0] < samples[..., 1]).to(torch.uint8)
    return torch.where(valid[:, None], bits, 0).to(torch.uint8)


def brief_from_patches(patches: torch.Tensor, centers: torch.Tensor,
                       angle: torch.Tensor, valid: torch.Tensor,
                       pattern: torch.Tensor) -> torch.Tensor:
    """:func:`brief_descriptors` sampled INSIDE the per-keypoint patches
    ``patches`` [K, P, P] with their (cx, cy) ``centers`` [K, 2] (see
    :func:`extract_patches`): exact rotation, bilinear interpolation from
    four patch-local gathers. [K, 256] uint8."""
    k, p, _ = patches.shape
    pos = _rotated_pattern(angle, pattern) + centers[:, None, None, :]
    x = torch.clamp(pos[..., 0], 0.0, p - 1.001)
    y = torch.clamp(pos[..., 1], 0.0, p - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).reshape(k, -1, 2)
    fy = (y - y0).reshape(k, -1, 2)
    flat = patches.reshape(k, p * p)
    base = (y0.long() * p + x0.long()).reshape(k, -1)       # [K, 512]

    def take(off):
        return torch.gather(flat, 1, base + off).reshape(k, -1, 2)

    samples = ((1 - fy) * ((1 - fx) * take(0) + fx * take(1))
               + fy * ((1 - fx) * take(p) + fx * take(p + 1)))
    bits = (samples[..., 0] < samples[..., 1]).to(torch.uint8)
    return torch.where(valid[:, None], bits, 0).to(torch.uint8)


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
    moments against ``weights`` [P*P, 2], summed in a fixed pairwise order
    (kernel M on the card, its plain version on the CPU), so an angle's bits
    depend on its patch alone, not on K. [K] radians, 0 for invalid rows."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    return cuda_kernels.orient_moments(patches, valid, weights)


@functools.lru_cache(maxsize=8)
def _moment_weights_on(device: torch.device) -> torch.Tensor:
    """:func:`_orientation_moment_weights` on ``device``, kept (never written
    to): a copy from host memory per frame would be a host sync."""
    return torch.from_numpy(_orientation_moment_weights()).to(device)


def _brief_bin_pixels(pattern: np.ndarray, num_bins: int,
                      patch: int) -> np.ndarray:
    """[num_bins, 256, 2] flat patch indices of the nearest pixels of each
    pair's points A and B, the pattern rotated by ``2*pi*b/num_bins`` for
    bin b; rotated positions clip to the patch."""
    out = np.empty((num_bins, pattern.shape[0], 2), np.int64)
    for b in range(num_bins):
        th = 2.0 * np.pi * b / num_bins
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s], [s, c]], np.float32)
        pts = pattern @ rot.T
        pos = pts + PATCH_CENTER
        xi = np.clip(np.round(pos[..., 0]).astype(int), 0, patch - 1)
        yi = np.clip(np.round(pos[..., 1]).astype(int), 0, patch - 1)
        out[b] = yi * patch + xi
    return out


def make_brief_bin_matrices(pattern: np.ndarray, num_bins: int = 30,
                            patch: int = PATCH) -> np.ndarray:
    """[num_bins, patch*patch, 512] one-hot sampling matrices: bin b's matrix
    maps a flattened patch to the 512 nearest-pixel samples of the pattern
    rotated by ``2*pi*b/num_bins``. Columns [0:256] are point A of each
    pair, [256:512] point B; rotated positions clip to the patch."""
    out = np.zeros((num_bins, patch * patch, 512), np.float32)
    cols = np.arange(256)
    for b, flat_idx in enumerate(_brief_bin_pixels(pattern, num_bins, patch)):
        out[b, flat_idx[:, 0], cols] = 1.0
        out[b, flat_idx[:, 1], cols + 256] = 1.0
    return out


def brief_bins(angle: torch.Tensor, num_bins: int) -> torch.Tensor:
    """[K] int32 rotation bins of ``angle`` [K] float32 radians:
    ``round(angle / step) mod num_bins``, step the float32 ``2 pi /
    num_bins``, the division correctly rounded, round half to even, floor
    modulo (kernel Q computes it the same way)."""
    # a step tensor (not a Python scalar): CUDA divides by a host scalar as
    # a multiply by its reciprocal, which can round differently
    step = torch.full((), 2.0 * math.pi / num_bins, dtype=torch.float32,
                      device=angle.device)
    return torch.remainder(torch.round(angle / step).to(torch.int32),
                           num_bins)


def brief_from_patches_binned(patches: torch.Tensor, angle: torch.Tensor,
                              valid: torch.Tensor,
                              D: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits of ``[K, P, P]`` patches: [K, 256] uint8. Each
    keypoint's angle picks a bin (:func:`brief_bins`); per bin, one bf16
    product of the patches with the bin's difference matrix ``D[b]`` (+1 at
    point B, -1 at point A) gives ``bf16(B) - bf16(A)`` (rounded to bf16,
    which keeps its sign), and the bin mask selects among the OUTPUTS.
    ``bit = diff > 0``. The JAX package's form, kept as the oracle of
    :func:`..cuda_kernels.brief_bits`."""
    k = patches.shape[0]
    num_bins = D.shape[0]
    flat = patches.reshape(k, -1).to(torch.bfloat16)
    bins = brief_bins(angle, num_bins)
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
    ``A < B`` comparison's tie). Built on the host and copied from pageable
    memory: the span ``slam.orb.brief_matrices``. The operand of
    :func:`brief_from_patches_binned`; the front-end takes the pair table
    (:func:`brief_pairs`)."""
    with profiling.annotate("slam.orb.brief_matrices"):
        host = _brief_matrices_np(cfg.pattern_seed, cfg.descriptor_bits,
                                  cfg.patch_size, cfg.brief_bins)
        profiling.count("bytes", host.nbytes)
        return torch.tensor(host, device=device)


@functools.cache
def _brief_pairs_np(seed: int, bits: int, patch_size: int,
                    bins: int) -> np.ndarray:
    idx = _brief_bin_pixels(make_pattern(seed, bits, patch_size), bins,
                            PATCH)
    idx[idx[..., 0] == idx[..., 1]] = 0
    return idx.astype(np.int16)


def brief_pairs(cfg: OrbConfig, device) -> torch.Tensor:
    """[bins, 256, 2] int16 pair table of a config on ``device``: bin b's
    flat patch indices (A, B) of pair j, the pixels of
    :func:`brief_matrices`' -1 and +1 (both 0 where A and B land on one
    pixel, as the all-zero column: bit 0). Built on the host (once a
    config) and copied, 30 KB at 30 bins, under the span of the BRIEF
    tables, ``slam.orb.brief_matrices``."""
    with profiling.annotate("slam.orb.brief_matrices"):
        host = _brief_pairs_np(cfg.pattern_seed, cfg.descriptor_bits,
                               cfg.patch_size, cfg.brief_bins)
        profiling.count("bytes", host.nbytes)
        return torch.tensor(host, device=device)


def brief_pairs_from_matrices(D: torch.Tensor) -> torch.Tensor:
    """The pair table of :func:`brief_pairs` read off a ``[bins, P*P, 256]``
    difference stack ``D`` (:func:`brief_matrices`) on its device: the row
    of each column's +1 (B) and -1 (A), both 0 in an all-zero column."""
    b = torch.argmax(D, dim=1)
    a = torch.argmin(D, dim=1)
    tie = torch.gather(D, 1, b[:, None]).squeeze(1) <= 0
    pairs = torch.stack([a, b], dim=-1).masked_fill(tie[..., None], 0)
    return pairs.to(torch.int16)


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
    exactly ``cfg.num_features`` slots per frame. ``pattern`` is on the
    frames' device: the :func:`brief_pairs` table, or a
    :func:`brief_matrices` stack, read into its table
    (:func:`brief_pairs_from_matrices`); built if None. Orientation and
    BRIEF run once over the concatenated all-level patch set. Spans:
    ``slam.orb.frontend`` around the call, inside it ``slam.orb.pyramid``,
    ``slam.orb.detect`` (every level's FAST, NMS, blur, grid top-K and
    patches; inside it, at ``grid_cell > 0``, ``slam.orb.topk`` a level,
    the ranking of the cell keys) and ``slam.orb.describe`` (orientation,
    BRIEF's signed and packed descriptors; counter ``keypoints``, the rows
    described)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    with profiling.annotate("slam.orb.frontend", frames=imgs.shape[0]):
        if pattern is None:
            pattern = brief_pairs(cfg, imgs.device)
        with profiling.annotate("slam.orb.pyramid"):
            levels = image_ops.pyramid(imgs, cfg.num_levels,
                                       cfg.scale_factor)
        budgets = _level_budgets(cfg.num_features, cfg.num_levels,
                                 cfg.scale_factor)
        with profiling.annotate("slam.orb.detect"):
            parts = [_detect_level(lv, lvl, budget, cfg)
                     for lvl, (lv, budget) in enumerate(zip(levels, budgets))
                     if budget > 0]
            xy, resp, octv, val, patches = (torch.cat(p, dim=1)
                                            for p in zip(*parts))
        b, k = val.shape
        with profiling.annotate("slam.orb.describe", keypoints=b * k):
            if pattern.shape[1:] != (desc_ops.BITS, 2):
                pattern = brief_pairs_from_matrices(pattern)
            flat_patches = patches.reshape(b * k, PATCH, PATCH)
            flat_val = val.reshape(-1)
            mw = _moment_weights_on(imgs.device)
            ang = orientation_from_patches(flat_patches, flat_val, mw)
            packed, signed = cuda_kernels.brief_bits(flat_patches, ang,
                                                     flat_val, pattern)
            descriptors = packed.reshape(b, k, desc_ops.WORDS)
            signed = signed.reshape(b, k, desc_ops.BITS)
        kps = Keypoints(xy=xy, response=resp, angle=ang.reshape(b, k),
                        octave=octv, valid=val)
        return OrbFeatures(keypoints=kps, descriptors=descriptors,
                           signed=signed)


def detect_and_describe(img: torch.Tensor, cfg: OrbConfig = OrbConfig(),
                        pattern: torch.Tensor | None = None) -> OrbFeatures:
    """Full ORB on ONE grayscale ``[H, W]`` float32 frame: the features of
    :func:`detect_and_describe_batch` without the batch axis."""
    feats = detect_and_describe_batch(img[None], cfg, pattern)
    return OrbFeatures(keypoints=Keypoints(*(v[0] for v in feats.keypoints)),
                       descriptors=feats.descriptors[0],
                       signed=feats.signed[0])
