"""Plain ORB front-end: the reference that the benchmark holds the port's
front-end to.

A frozen copy, in plain PyTorch and numpy, of the plain path of the port's
front-end (``ops/image.py``'s banded bfloat16 pyramid, ``ops/fast.py``'s
FAST-9 score, 3x3 NMS and grid top-K, the reflect-padded blur, the 32x32
patch gather, the fixed-order moment tree and the 30-bin rotated BRIEF of
``ops/orb.py``). It imports nothing of the port and takes nothing the port
made: the frames in, keypoints and descriptors out. Every step runs on
whatever device its tensors are on, one elementwise or matrix operation at
a time, in the order the port's kernels promise to keep.

``dt`` is the precision of the image arithmetic. The configurations state
float32; the benchmark's control runs this same code in bfloat16.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 32
PATCH_RADIUS = 15
PATCH_CENTER = PATCH // 2 - 1
BITS = 256
WORDS = BITS // 32
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9


# -- pyramid: antialiased bilinear weights, banded, bfloat16 ---------------

@functools.cache
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of an antialiased bilinear resize
    (triangle kernel widened by the scale, columns normalised)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.cache
def resize_taps(in_size: int, out_size: int):
    """(start [out] int64, band [out, T] float32): each output's T
    bfloat16-rounded weights from input ``start``, in ascending index."""
    if in_size == out_size:
        return (np.arange(out_size, dtype=np.int64),
                np.ones((out_size, 1), np.float32))
    w = torch.from_numpy(resize_weights(in_size, out_size)).to(
        torch.bfloat16).to(torch.float32).numpy()
    nz = w != 0
    taps = max(1, int(nz.sum(0).max()))
    start = np.minimum(np.argmax(nz, axis=0), in_size - taps).astype(np.int64)
    idx = start[:, None] + np.arange(taps)
    return start, w[idx, np.arange(out_size)[:, None]]


def _banded_pass(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    start, band = resize_taps(x.shape[dim], out_size)
    start = torch.from_numpy(start).to(x.device)
    band = torch.from_numpy(band).to(x.device)
    shape = [1] * x.dim()
    shape[dim] = out_size
    acc = None
    for k in range(band.shape[1]):
        term = (x.index_select(dim, start + k).to(torch.float32)
                * band[:, k].reshape(shape))
        acc = term if acc is None else acc + term
    return acc.to(torch.bfloat16)


def resize_level(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """One pyramid level in bfloat16: rows first unless h > w, each pass in
    float32 and rounded to bfloat16."""
    h, w = imgs.shape[-2:]
    dims = [(-2, out_h), (-1, out_w)]
    if h > w:
        dims.reverse()
    out = imgs.to(torch.bfloat16)
    for dim, n in dims:
        out = _banded_pass(out, dim, n)
    return out


def pyramid(imgs: torch.Tensor, num_levels: int, scale: float, dt):
    """Level 0 is the frames; level L is level L-1 resized by 1/scale, the
    chain in bfloat16; levels returned in ``dt``."""
    levels = [imgs]
    h, w = imgs.shape[-2:]
    prev = imgs
    for lvl in range(1, num_levels):
        s = scale ** lvl
        nh, nw = max(8, int(round(h / s))), max(8, int(round(w / s)))
        prev = resize_level(prev, nh, nw)
        levels.append(prev.to(dt))
    return levels


# -- FAST-9, NMS, blur, grid top-K -----------------------------------------

def _interior(h: int, w: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (
        xs < w - border)


def fast_score(imgs: torch.Tensor, threshold: float) -> torch.Tensor:
    """Max over the 16 circular 9-arcs of the least bright or dark margin,
    clamped at 0, 0 within 3 px of the border."""
    h, w = imgs.shape[-2:]
    p = F.pad(imgs, (3, 3, 3, 3))
    ring = torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in CIRCLE])
    bright = ring - imgs[None] - threshold
    dark = imgs[None] - ring - threshold

    def arc(margin):
        m2 = torch.cat([margin, margin[:ARC - 1]], dim=0)
        return torch.amax(torch.stack([torch.amin(m2[k:k + ARC], dim=0)
                                       for k in range(16)]), dim=0)

    score = torch.clamp_min(torch.maximum(arc(bright), arc(dark)), 0.0)
    return torch.where(_interior(h, w, 3, imgs.device), score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    local = F.max_pool2d(score[:, None].float(), 3, stride=1,
                         padding=1)[:, 0].to(score.dtype)
    return torch.where(score >= local, score, 0.0)


def gaussian_taps(sigma: float, radius: int) -> list:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return [float(v) for v in k / torch.sum(k)]


def _reflect(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def blur(imgs: torch.Tensor, sigma: float = 2.0, radius: int = 3):
    """Separable blur, reflect padding, vertical then horizontal, tap by
    tap (``out = k0*x0; out = out + k_i*x_i``)."""
    k = gaussian_taps(sigma, radius)
    h, w = imgs.shape[-2:]
    x = imgs.index_select(-2, _reflect(h, radius, imgs.device))
    out = k[0] * x[..., 0:h, :]
    for i in range(1, 2 * radius + 1):
        out = out + k[i] * x[..., i:i + h, :]
    x = out.index_select(-1, _reflect(w, radius, imgs.device))
    out = k[0] * x[..., :, 0:w]
    for i in range(1, 2 * radius + 1):
        out = out + k[i] * x[..., :, i:i + w]
    return out


def _topk_lowest_index(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_grid(score: torch.Tensor, num: int, border: int, cell: int):
    """At most one keypoint a ``cell`` x ``cell`` cell, the cell's maximum
    (lowest index on ties) found by folding the inverted in-cell index into
    the low bits of the float32 score; then the ``num`` best cells, ties to
    the lowest cell. (xy [B, K, 2], response [B, K], valid [B, K])."""
    score = score.to(torch.float32)
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
    rowmax = torch.amax(packed.reshape(b, hb, cell, wp), dim=2)
    cmax = torch.amax(rowmax.reshape(b, hb, wb, cell), dim=3).reshape(b, -1)
    pk, sel = _topk_lowest_index(cmax, num)
    valid = pk > 0
    pos = (cell * cell - 1) - (pk & posmask)
    y = (sel // wb) * cell + pos // cell
    x = (sel % wb) * cell + pos % cell
    flat = torch.where(valid, y * w + x, 0)
    resp = torch.where(valid, torch.gather(score.reshape(b, h * w), 1, flat),
                       0.0)
    return (torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=-1),
            resp, valid)


# -- patches, orientation, rotated BRIEF -----------------------------------

def patches_at(imgs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[B, K, 32, 32] patches at the clamped integer keypoints."""
    b, h, w = imgs.shape
    k = xy.shape[1]
    x0 = torch.clamp(xy[..., 0].to(torch.int64) - PATCH_CENTER, 0, w - PATCH)
    y0 = torch.clamp(xy[..., 1].to(torch.int64) - PATCH_CENTER, 0, h - PATCH)
    off = torch.arange(PATCH, device=imgs.device)
    idx = ((y0[..., None, None] + off[:, None]) * w
           + (x0[..., None, None] + off[None, :]))
    return torch.gather(imgs.reshape(b, h * w), 1,
                        idx.reshape(b, -1)).reshape(b, k, PATCH, PATCH)


@functools.cache
def moment_weights() -> np.ndarray:
    """[1024, 2] weights of (m10, m01) over the circle of radius 15."""
    offs = np.arange(PATCH, dtype=np.float32) - PATCH_CENTER
    dy = offs[:, None] * np.ones((1, PATCH), np.float32)
    dx = np.ones((PATCH, 1), np.float32) * offs[None, :]
    circ = (dx ** 2 + dy ** 2) <= PATCH_RADIUS ** 2
    return np.stack([np.where(circ, dx, 0.0).reshape(-1),
                     np.where(circ, dy, 0.0).reshape(-1)], axis=1)


def orientation(patches: torch.Tensor, valid: torch.Tensor,
                rows: int = 16384) -> torch.Tensor:
    """atan2(m01, m10) with the moments summed by a pairwise tree over the
    1024 columns (each product rounded first), 0 for invalid rows."""
    k = patches.shape[0]
    flat = patches.reshape(k, -1)
    wts = torch.from_numpy(moment_weights()).to(flat.device, flat.dtype)
    m = torch.empty((k, 2), dtype=flat.dtype, device=flat.device)
    for s in range(0, k, rows):
        p = flat[s:s + rows, :, None] * wts
        h = p.shape[1]
        while h > 1:
            h //= 2
            p = p[:, :h] + p[:, h:]
        m[s:s + rows] = p[:, 0]
    return torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), 0.0)


def make_pattern(seed: int, bits: int = 256, patch_size: int = 31):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, patch_size / 5.0, size=(bits, 2, 2))
    lim = patch_size // 2
    return np.clip(pts, -lim, lim).astype(np.float32)


@functools.cache
def brief_difference(seed: int, bits: int, patch_size: int,
                     bins: int) -> np.ndarray:
    """[bins, 1024, 256]: +1 at pair j's point B, -1 at its point A, the
    pattern rotated by 2 pi b / bins and rounded to pixels of the patch."""
    pattern = make_pattern(seed, bits, patch_size)
    out = np.zeros((bins, PATCH * PATCH, 2 * bits), np.float32)
    for b in range(bins):
        th = 2.0 * np.pi * b / bins
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s], [s, c]], np.float32)
        pos = pattern @ rot.T + PATCH_CENTER
        xi = np.clip(np.round(pos[..., 0]).astype(int), 0, PATCH - 1)
        yi = np.clip(np.round(pos[..., 1]).astype(int), 0, PATCH - 1)
        flat = yi * PATCH + xi
        cols = np.arange(bits)
        out[b, flat[:, 0], cols] = 1.0
        out[b, flat[:, 1], cols + bits] = 1.0
    return out[..., bits:] - out[..., :bits]


def brief_bits(patches: torch.Tensor, angle: torch.Tensor,
               valid: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """[K, 256] uint8: per rotation bin one bfloat16 product of the patches
    with the bin's difference matrix; the keypoint's bin picks the output;
    a bit is ``B - A > 0``."""
    k = patches.shape[0]
    bins = diff.shape[0]
    flat = patches.reshape(k, -1).to(torch.bfloat16)
    step = torch.full((), 2.0 * math.pi / bins, dtype=torch.float32,
                      device=angle.device)
    b_of = torch.remainder(
        torch.round(angle.to(torch.float32) / step).to(torch.int32), bins)
    out = torch.zeros((k, diff.shape[2]), dtype=torch.bfloat16,
                      device=patches.device)
    for b in range(bins):
        dot = flat @ diff[b].to(torch.bfloat16)
        out = torch.where((b_of == b)[:, None], dot, out)
    return torch.where(valid[:, None], (out > 0).to(torch.uint8), 0).to(
        torch.uint8)


def level_budgets(num: int, levels: int, scale: float) -> list:
    inv = [scale ** -i for i in range(levels)]
    total = sum(inv)
    budgets = [int(round(num * v / total)) for v in inv]
    budgets[0] += num - sum(budgets)
    return budgets


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] {0, 1} -> [..., 8] int32 words, bit i of word w = bit
    32 w + i."""
    flat = bits.reshape(-1, WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    s = torch.sum(flat << shifts, dim=-1)
    return (s - ((s >> 31) << 32)).to(torch.int32).reshape(
        *bits.shape[:-1], WORDS)


def unpack_signed(packed: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 words -> [..., 256] int8 of +-1."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    b = ((packed[..., :, None] >> shifts) & 1).reshape(*packed.shape[:-1],
                                                       BITS)
    return (b.to(torch.int8) * 2 - 1).to(torch.int8)


def front_end(frames_u8: torch.Tensor, orb: dict, dt=torch.float32):
    """ORB of [B, H, W] uint8 frames with the settings ``orb`` (the
    configuration file's ``orb`` group): (xy [B, K, 2] float32, valid
    [B, K] bool, packed [B, K, 8] int32)."""
    imgs = (frames_u8.to(torch.float32)
            / torch.full((), 255.0, device=frames_u8.device)).to(dt)
    levels = pyramid(imgs, orb["num_levels"], orb["scale_factor"], dt)
    budgets = level_budgets(orb["num_features"], orb["num_levels"],
                            orb["scale_factor"])
    diff = torch.from_numpy(brief_difference(
        orb["pattern_seed"], orb["descriptor_bits"], orb["patch_size"],
        orb["brief_bins"])).to(frames_u8.device)
    xys, vals, pats = [], [], []
    for lvl, (img, budget) in enumerate(zip(levels, budgets)):
        if budget <= 0:
            continue
        score = nms3(fast_score(img, orb["fast_threshold"] / 255.0))
        xy, _, valid = topk_grid(score, budget, orb["border"],
                                 orb["grid_cell"])
        pats.append(patches_at(blur(img), xy))
        xys.append(xy * (orb["scale_factor"] ** lvl))
        vals.append(valid)
    xy, valid, patches = (torch.cat(p, dim=1) for p in (xys, vals, pats))
    b, k = valid.shape
    flat = patches.reshape(b * k, PATCH, PATCH)
    fval = valid.reshape(-1)
    angle = orientation(flat, fval)
    bits = brief_bits(flat, angle, fval, diff).reshape(b, k, BITS)
    return xy, valid, pack_bits(bits)
