"""FAST-9/16 corner detection as dense, fixed-shape tensor ops.

Port of :mod:`slam_loop_closing_tpu.ops.fast` over a leading batch of
frames: ``[B, H, W]`` float32 in, ``[B, H, W]`` score maps and fixed-size
``[B, K]`` keypoint sets out.

Pipeline: :func:`fast_score_map` -> :func:`nms` (3x3) -> :func:`select_topk`
or :func:`select_topk_grid` (:func:`grid_keys`, one key a cell, then
:func:`rank_grid_keys`). On a CUDA tensor :func:`detect_with_blur` runs the
score, the NMS and the descriptor blur through the hand-written kernel
:func:`.cuda_kernels.fast_score_nms_blur`; with a grid cell of
:data:`KERNEL_GRID_CELLS` the same kernel's grid mode,
:func:`.cuda_kernels.fast_grid_keys_blur`, writes the cell keys in place of
the score map.

Top-K ties resolve to the LOWEST flat index, as ``jax.lax.top_k`` does
(FAST scores tie often: pixels are 8-bit); ``torch.topk`` promises no
order, so selection is a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.utils import profiling

# Bresenham circle of radius 3 — the 16 FAST offsets (dy, dx), clockwise
# from 12 o'clock.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: need 9 contiguous circle pixels all brighter/darker
# grid cells that divide kernel A's 64 x 16 tile: its grid mode reduces them
KERNEL_GRID_CELLS = (1, 2, 4, 8, 16)


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


def select_topk_banded(score: torch.Tensor, num_features: int,
                       border: int = 19, bands: int = 16):
    """Top-K of ``[B, H, W]`` maps via horizontal bands: each band gives its
    local top-(K / bands + 32), then one small top-K merges the candidates;
    band caps also spread keypoints over the frame. Ties go to the lowest
    index at both steps. Returns (xy, response, valid) like
    :func:`select_topk`."""
    b, h, w = score.shape
    masked = torch.where(_interior(h, w, border, score.device), score, 0.0)
    pad_h = (-h) % bands
    if pad_h:
        masked = F.pad(masked, (0, 0, 0, pad_h))
    bh = (h + pad_h) // bands
    per_band = -(-num_features // bands) + 32  # slack for uneven density
    resp_b, idx_b = _topk_lowest_index(masked.reshape(b, bands, bh * w),
                                       per_band)
    band_base = (torch.arange(bands, device=score.device) * bh * w)[:, None]
    gidx = (idx_b + band_base).reshape(b, -1)
    resp, sel = _topk_lowest_index(resp_b.reshape(b, -1), num_features)
    idx = torch.gather(gidx, 1, sel)
    y = (idx // w).to(torch.float32)
    x = (idx % w).to(torch.float32)
    return torch.stack([x, y], dim=-1), resp, resp > 0.0


def _posmask(cell: int) -> int:
    """The low key bits that hold a pixel's inverted index in its cell."""
    return (1 << max(1, (cell * cell - 1).bit_length())) - 1


def grid_keys(score: torch.Tensor, border: int = 19, cell: int = 8):
    """One key and one response a ``cell x cell`` cell of ``[B, H, W]``
    maps: (keys [B, hb, wb] int32, cell_resp [B, hb, wb] float32), hb =
    ceil(H / cell), wb = ceil(W / cell). Each positive score inside the
    border has the low bits of its int32 bit pattern replaced by the
    inverted in-cell pixel index, so one max a cell carries its own argmax
    (lowest flat index on ties); elsewhere, and past a ragged edge, the key
    is 0. ``cell_resp`` is the winner's exact score (0 where the key is 0).
    Kernel A's grid mode computes the same bits."""
    b, h, w = score.shape
    masked = torch.where(_interior(h, w, border, score.device), score, 0.0)
    ph, pw = (-h) % cell, (-w) % cell
    if ph or pw:
        masked = F.pad(masked, (0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    hb, wb = hp // cell, wp // cell

    posmask = _posmask(cell)
    dev = score.device
    invpos = ((cell * cell - 1)
              - (torch.arange(hp, dtype=torch.int32, device=dev)[:, None]
                 % cell) * cell
              - (torch.arange(wp, dtype=torch.int32, device=dev)[None, :]
                 % cell))
    bits = masked.contiguous().view(torch.int32)
    packed = torch.where(masked > 0.0, (bits & ~posmask) | invpos, 0)
    rowmax = torch.amax(packed.reshape(b, hb, cell, wp), dim=2)     # [b, hb, wp]
    keys = torch.amax(rowmax.reshape(b, hb, wb, cell), dim=3)       # [b, hb, wb]

    pos = (cell * cell - 1) - (keys & posmask)
    y = torch.arange(hb, device=dev)[:, None] * cell + pos // cell
    x = torch.arange(wb, device=dev)[None, :] * cell + pos % cell
    valid = keys > 0
    flat = torch.where(valid, y * w + x, 0).reshape(b, -1)
    cell_resp = torch.where(
        valid, torch.gather(score.reshape(b, h * w), 1, flat).reshape(
            b, hb, wb), 0.0)
    return keys, cell_resp


def rank_grid_keys(keys: torch.Tensor, cell_resp: torch.Tensor,
                   num_features: int, cell: int, fused: bool = False):
    """Top-K of the cell keys of :func:`grid_keys` (``[B, hb, wb]``, or
    kernel A's grid mode) as (xy [B, K, 2] float32 (x, y), response [B, K],
    valid [B, K] bool): a stable descending sort (ties to the lowest cell),
    the winner's position decoded from its key, its response read from
    ``cell_resp``. Span ``slam.orb.topk``: counters ``cells`` (the keys
    ranked) and ``fused`` (1 where the keys came from the kernel)."""
    b, _, wb = keys.shape
    with profiling.annotate("slam.orb.topk", cells=keys.numel(),
                            fused=int(fused)):
        posmask = _posmask(cell)
        pk, sel = _topk_lowest_index(keys.reshape(b, -1), num_features)
        valid = pk > 0
        pos = (cell * cell - 1) - (pk & posmask)
        y = (sel // wb) * cell + pos // cell
        x = (sel % wb) * cell + pos % cell
        resp = torch.gather(cell_resp.reshape(b, -1), 1, sel)
        return (torch.stack([x.to(torch.float32), y.to(torch.float32)],
                            dim=-1), resp, valid)


def select_topk_grid(score: torch.Tensor, num_features: int, border: int = 19,
                     cell: int = 8):
    """Top-K with at most one keypoint per ``cell x cell`` cell:
    :func:`grid_keys` then :func:`rank_grid_keys`; responses are the
    map's exact scores. Returns (xy, response, valid) like
    :func:`select_topk`."""
    keys, cell_resp = grid_keys(score, border, cell)
    return rank_grid_keys(keys, cell_resp, num_features, cell)


def detect_with_blur(imgs: torch.Tensor, threshold: float = 20.0 / 255.0,
                     num_features: int = 2000, nms_radius: int = 1,
                     border: int = 19, grid_cell: int = 0,
                     blur_sigma: float = 2.0, blur_radius: int = 3):
    """FAST detection plus the descriptor-prefilter Gaussian blur of
    ``[B, H, W]`` frames: (xy, response, valid, blurred). With the 3x3 NMS
    the score, NMS and blur run as one kernel (its plain version on a CPU
    tensor); with a grid cell of :data:`KERNEL_GRID_CELLS` too, the
    kernel's grid mode writes the cell keys in place of the score map. The
    blur pads by reflection in every path."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    if nms_radius == 1 and grid_cell in KERNEL_GRID_CELLS:
        keys, cell_resp, blurred = cuda_kernels.fast_grid_keys_blur(
            imgs, threshold, border, grid_cell, blur_sigma, blur_radius)
        return rank_grid_keys(keys, cell_resp, num_features, grid_cell,
                              fused=imgs.is_cuda) + (blurred,)
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
