"""FAST-9/16 corner detection as dense, fixed-shape tensor ops.

Port of :mod:`slam_loop_closing_tpu.ops.fast` over a leading batch of
frames: ``[B, H, W]`` float32 in, ``[B, H, W]`` score maps and fixed-size
``[B, K]`` keypoint sets out.

Pipeline: :func:`fast_score_map` -> :func:`nms` (3x3) -> :func:`select_topk`
or :func:`select_topk_grid`. On a CUDA tensor :func:`detect_with_blur` runs
the score, the NMS and the descriptor blur through the hand-written kernel
:func:`.cuda_kernels.fast_score_nms_blur`.

Top-K ties resolve to the LOWEST flat index, as ``jax.lax.top_k`` does
(FAST scores tie often: pixels are 8-bit); ``torch.topk`` promises no
order, so selection is a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_loop_closing_tpu_torch.ops import image as image_ops

# Bresenham circle of radius 3 — the 16 FAST offsets (dy, dx), clockwise
# from 12 o'clock.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: need 9 contiguous circle pixels all brighter/darker


def _shifted_ring(imgs: torch.Tensor) -> torch.Tensor:
    """[16, B, H, W]: ``ring[k, b, y, x] = img[b, y + dy_k, x + dx_k]``,
    zero outside the frame (callers zero the border anyway)."""
    h, w = imgs.shape[-2:]
    p = F.pad(imgs, (3, 3, 3, 3))
    return torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in CIRCLE])


def _interior(h: int, w: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)


def fast_score_map(imgs: torch.Tensor,
                   threshold: float = 20.0 / 255.0) -> torch.Tensor:
    """Dense FAST-9 corner score of ``[B, H, W]`` frames (0 = not a corner):
    the max over the 16 circular 9-arcs of the min bright/dark margin, in
    float32 with the JAX package's operation order, and 0 within 3 px of
    the border."""
    ring = _shifted_ring(imgs)
    bright = ring - imgs[None] - threshold
    dark = imgs[None] - ring - threshold

    def arc_strength(margin):
        m2 = torch.cat([margin, margin[:ARC - 1]], dim=0)         # [24, ...]
        windows = torch.stack([torch.amin(m2[k:k + ARC], dim=0)
                               for k in range(16)])
        return torch.amax(windows, dim=0)

    score = torch.maximum(arc_strength(bright), arc_strength(dark))
    score = torch.clamp_min(score, 0.0)
    h, w = imgs.shape[-2:]
    return torch.where(_interior(h, w, 3, imgs.device), score, 0.0)


def nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Keep a score only where it equals the max of its (2r+1)^2 window
    (``-inf`` outside the frame)."""
    k = 2 * radius + 1
    local_max = F.max_pool2d(score[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where(score >= local_max, score, 0.0)


def _topk_lowest_index(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk(score: torch.Tensor, num_features: int, border: int = 19):
    """Top-K corners of ``[B, H, W]`` maps into fixed-size ``[B, K]`` sets:
    (xy [B, K, 2] float32 (x, y), response [B, K], valid [B, K] bool)."""
    b, h, w = score.shape
    masked = torch.where(_interior(h, w, border, score.device), score, 0.0)
    resp, idx = _topk_lowest_index(masked.reshape(b, h * w), num_features)
    y = (idx // w).to(torch.float32)
    x = (idx % w).to(torch.float32)
    return torch.stack([x, y], dim=-1), resp, resp > 0.0


def select_topk_grid(score: torch.Tensor, num_features: int, border: int = 19,
                     cell: int = 8):
    """Top-K with at most one keypoint per ``cell x cell`` cell. Each
    positive score's int32 bit pattern has its low bits replaced by the
    inverted in-cell pixel index, so one max per cell carries its own argmax
    (lowest flat index on ties); responses are re-read exactly from the map.
    Returns (xy, response, valid) like :func:`select_topk`."""
    b, h, w = score.shape
    masked = torch.where(_interior(h, w, border, score.device), score, 0.0)
    ph, pw = (-h) % cell, (-w) % cell
    if ph or pw:
        masked = F.pad(masked, (0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    hb, wb = hp // cell, wp // cell

    posbits = max(1, (cell * cell - 1).bit_length())
    posmask = (1 << posbits) - 1
    dev = score.device
    invpos = ((cell * cell - 1)
              - (torch.arange(hp, dtype=torch.int32, device=dev)[:, None]
                 % cell) * cell
              - (torch.arange(wp, dtype=torch.int32, device=dev)[None, :]
                 % cell))
    bits = masked.contiguous().view(torch.int32)
    packed = torch.where(masked > 0.0, (bits & ~posmask) | invpos, 0)
    rowmax = torch.amax(packed.reshape(b, hb, cell, wp), dim=2)     # [b, hb, wp]
    cmax = torch.amax(rowmax.reshape(b, hb, wb, cell), dim=3).reshape(b, -1)

    pk, sel = _topk_lowest_index(cmax, num_features)
    valid = pk > 0
    pos = (cell * cell - 1) - (pk & posmask)
    y = (sel // wb) * cell + pos // cell
    x = (sel % wb) * cell + pos % cell
    flat = torch.where(valid, y * w + x, 0)
    resp = torch.where(valid, torch.gather(score.reshape(b, h * w), 1, flat),
                       0.0)
    return (torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=-1),
            resp, valid)


def detect_with_blur(imgs: torch.Tensor, threshold: float = 20.0 / 255.0,
                     num_features: int = 2000, nms_radius: int = 1,
                     border: int = 19, grid_cell: int = 0,
                     blur_sigma: float = 2.0, blur_radius: int = 3):
    """FAST detection plus the descriptor-prefilter Gaussian blur of
    ``[B, H, W]`` frames: (xy, response, valid, blurred). With the 3x3 NMS
    the score, NMS and blur run as one kernel (its plain version on a CPU
    tensor); the blur pads by reflection in both paths."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    if nms_radius == 1:
        suppressed, blurred = cuda_kernels.fast_score_nms_blur(
            imgs, threshold, blur_sigma, blur_radius)
    else:
        suppressed = nms(fast_score_map(imgs, threshold), nms_radius)
        blurred = image_ops.gaussian_blur(imgs, blur_sigma, blur_radius)
    if grid_cell > 0:
        sel = select_topk_grid(suppressed, num_features, border, grid_cell)
    else:
        sel = select_topk(suppressed, num_features, border)
    return sel + (blurred,)


def detect(imgs: torch.Tensor, threshold: float = 20.0 / 255.0,
           num_features: int = 2000, nms_radius: int = 1, border: int = 19,
           grid_cell: int = 0):
    """Full FAST detection of ``[B, H, W]`` frames: score -> NMS ->
    fixed-budget top-K (``grid_cell > 0``: at most one keypoint per cell),
    as (xy, response, valid). :func:`detect_with_blur` without its blur,
    which the score kernel computes in the same pass."""
    return detect_with_blur(imgs, threshold, num_features, nms_radius,
                            border, grid_cell)[:3]
