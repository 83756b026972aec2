"""SIFT-class float front-end: DoG pyramid detector + 4x4x8
gradient-histogram descriptor, over a leading batch of frames.

Port of :mod:`slam_loop_closing_tpu.ops.sift` (the reference's
``cv::SIFT::create(4000)`` + ``detectAndCompute``, main.cpp:497-504, at
quality parity, not bit parity). The JAX package vmaps a per-frame function;
here the batch axis is written out. Per octave:

1. the Gaussian stack (S+3 chained reflect blurs) and the gated DoG
   extremum response (26-neighbour extremum, contrast, edge and border
   gates) in one call of kernel H (:func:`.cuda_kernels.gauss_stack_resp`,
   its plain version on a CPU tensor);
2. top-K keypoints per frame, ties to the lowest index (flat, or one per
   ``grid_cell`` cell), and one clamped subpixel step of a 3-D quadratic
   fit;
3. the gradient maps of the middle level and one 40x40 window of each per
   keypoint (kernel B);
4. orientation (36-bin histogram, first maximum) and the 4x4x8 descriptor
   (trilinear soft assignment, normalise, clip at 0.2, renormalise) as
   plain torch over ``[B*K, P*P]`` arrays.

Where the JAX package takes ``approx_max_k`` (a flat top-K over >= 2^20
elements), the port takes the exact top-K: on the JAX package's CPU path
the two are equal, and on the TPU ``approx_max_k`` is approximate (ROADMAP
R15).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_loop_closing_tpu_torch.config import SiftConfig
from slam_loop_closing_tpu_torch.ops import fast as fast_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops

PATCH = 40
PATCH_CENTER = PATCH // 2 - 1
# Descriptor scale cap: the |u|,|v| < 10 grid-unit window spans a rotated
# square of half-width 10*scale px; with the patch center at (19, 19) full
# coverage needs scale <= 19 / (10*sqrt(2)) (the JAX package's _SCALE_CAP).
_SCALE_CAP = (PATCH // 2 - 1) / (10.0 * math.sqrt(2.0))
_BORDER = 8  # keypoints this close to an edge are dropped


class SiftFeatures(NamedTuple):
    xy: torch.Tensor           # [B, K, 2] level-0 pixel coords
    scale: torch.Tensor        # [B, K] absolute sigma
    angle: torch.Tensor        # [B, K] radians
    response: torch.Tensor     # [B, K] |DoG|
    valid: torch.Tensor        # [B, K] bool
    descriptors: torch.Tensor  # [B, K, 128] float32, L2-normalised


def _chain_sigmas(num_scales: int, sigma0: float) -> tuple[float, ...]:
    """Incremental blur sigmas of one octave's Gaussian chain: level 0 is
    the input blurred by ``sigma0``, level s the level s-1 blurred by the
    sigma that takes it to ``sigma0 * k**s``."""
    k = 2.0 ** (1.0 / num_scales)
    out = [sigma0]
    sig_prev = sigma0
    for s in range(1, num_scales + 3):
        sig_total = sigma0 * (k ** s)
        out.append(math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 1e-6)))
        sig_prev = sig_total
    return tuple(out)


def chain_taps(sigmas) -> list[list[float]]:
    """Host float32 taps of each level of the chain
    (:func:`..image.gaussian_kernel1d`, the JAX package's float32
    operations), as Python floats."""
    return [[float(v) for v in image_ops.gaussian_kernel1d(s)]
            for s in sigmas]


def _gaussian_chain(imgs: torch.Tensor, sigmas) -> torch.Tensor:
    """[B, L, H, W] chained reflect blurs of ``[B, H, W]`` frames: the plain
    Gaussian stack (level 0 blurs the input, each next level the previous
    one)."""
    levels = [image_ops.gaussian_blur(imgs, sigmas[0])]
    for s in sigmas[1:]:
        levels.append(image_ops.gaussian_blur(levels[-1], s))
    return torch.stack(levels, dim=-3)


def _extrema_response(dog: torch.Tensor) -> torch.Tensor:
    """[..., S+2, H, W] -> response map where a pixel of an interior scale
    is a strict 26-neighbourhood extremum of the DoG stack, else 0. The
    neighbour max/min is built from separable shifted-slice passes (exact,
    so equal to comparing each neighbour)."""

    def nb(x, fill):
        op = torch.maximum if fill < 0 else torch.minimum
        px = F.pad(x, (1, 1), value=fill)
        row3 = op(op(px[..., :-2], px[..., 1:-1]), px[..., 2:])
        py = F.pad(row3, (0, 0, 1, 1), value=fill)
        full9 = op(op(py[..., :-2, :], py[..., 1:-1, :]), py[..., 2:, :])
        # the center plane without its center pixel
        excl = op(op(py[..., :-2, :], py[..., 2:, :]),
                  op(px[..., :-2], px[..., 2:]))
        return op(op(full9[..., :-2, :, :], full9[..., 2:, :, :]),
                  excl[..., 1:-1, :, :])

    inner = dog[..., 1:-1, :, :]
    is_max = inner > nb(dog, -math.inf)
    is_min = inner < nb(dog, math.inf)
    resp_in = torch.where(is_max | is_min, torch.abs(inner), 0.0)
    zero = torch.zeros_like(dog[..., :1, :, :])
    return torch.cat([zero, resp_in, zero], dim=-3)


def _edge_mask(dog_levels: torch.Tensor,
               edge_threshold: float) -> torch.Tensor:
    """Principal-curvature ratio test on the 2x2 spatial Hessian of
    ``[..., L, H, W]`` DoG planes from central differences
    (``jnp.gradient`` is ``torch.gradient`` with edge order 1):
    ``det > 0 and tr^2 r < (r+1)^2 det``."""
    gy = torch.gradient(dog_levels, dim=-2)[0]
    gx = torch.gradient(dog_levels, dim=-1)[0]
    gyy = torch.gradient(gy, dim=-2)[0]
    gxy = torch.gradient(gx, dim=-2)[0]
    gxx = torch.gradient(gx, dim=-1)[0]
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    r = edge_threshold
    return (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)


def _gates(gauss: torch.Tensor, num_scales: int, thr: float,
           edge_threshold: float, border: int = _BORDER) -> torch.Tensor:
    """[B, S, H, W] gated response of a [B, S+3, H, W] Gaussian stack: plane
    j is |DoG plane j+1| where it is a 26-neighbour extremum, ``|DoG| >=
    thr``, passes the edge test and lies ``border`` px inside the frame;
    0 elsewhere. The plain math of kernel H's gates."""
    s = num_scales
    dog = gauss[:, 1:] - gauss[:, :-1]                        # [B, S+2, H, W]
    resp = _extrema_response(dog)
    resp = torch.where(torch.abs(dog) >= thr, resp, 0.0)
    ok = _edge_mask(dog[:, 1:s + 1], edge_threshold)
    resp_in = torch.where(ok, resp[:, 1:s + 1], 0.0)          # [B, S, H, W]
    h, w = gauss.shape[-2:]
    interior = fast_ops._interior(h, w, border, gauss.device)
    return torch.where(interior, resp_in, 0.0)


def _contrast_threshold(cfg: SiftConfig) -> float:
    """``contrast_threshold / S`` rounded to float32, the value the JAX
    package compares against."""
    return float(np.float32(cfg.contrast_threshold / cfg.scales_per_octave))


def _gaussian_stack(imgs: torch.Tensor, num_scales: int,
                    sigma0: float) -> torch.Tensor:
    """One octave's Gaussian stack [B, S+3, H, W] of ``[B, H, W]`` frames:
    kernel H in its gauss-only mode (the TPU's K11)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    return cuda_kernels.gauss_stack_resp(
        imgs, _chain_sigmas(num_scales, sigma0), num_scales,
        emit_resp=False)[0]


def _gated_response(imgs: torch.Tensor, cfg: SiftConfig):
    """One octave's ``(gauss [B, S+3, H, W], resp [B, S, H, W])``: resp plane
    ``j`` is the gated |DoG| extremum response of interior DoG plane
    ``j + 1``, by one call of kernel H (the TPU's K10)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    s = cfg.scales_per_octave
    return cuda_kernels.gauss_stack_resp(
        imgs, _chain_sigmas(s, cfg.sigma0), s, _contrast_threshold(cfg),
        cfg.edge_threshold, border=_BORDER)


def _select_grid(resp: torch.Tensor, budget: int, cell: int):
    """One keypoint per ``cell x cell`` spatial cell, max over the scale
    axis too (lowest in-cell index on ties), then the top ``budget`` cells:
    (vals, level, y, x) of [B, budget]."""
    b, nl, h, w = resp.shape
    ph, pw = (-h) % cell, (-w) % cell
    rp = F.pad(resp, (0, pw, 0, ph))
    hb, wb = (h + ph) // cell, (w + pw) // cell
    cells = rp.reshape(b, nl, hb, cell, wb, cell).permute(0, 2, 4, 1, 3, 5)
    cells = cells.reshape(b, hb * wb, nl * cell * cell)
    cmax = torch.amax(cells, dim=-1)
    iota = torch.arange(nl * cell * cell, device=resp.device)
    carg = torch.amin(torch.where(cells == cmax[..., None], iota,
                                  nl * cell * cell), dim=-1)
    vals, sel = fast_ops._topk_lowest_index(cmax, budget)
    flat_in = torch.gather(carg, 1, sel)
    lvl = flat_in // (cell * cell) + 1    # resp plane j <-> DoG plane j+1
    rem = flat_in % (cell * cell)
    y = (sel // wb) * cell + rem // cell
    x = (sel % wb) * cell + rem % cell
    return vals, lvl, y, x


def _select_flat(resp: torch.Tensor, budget: int):
    """The top ``budget`` responses of each frame's whole [S, H, W] stack,
    ties to the lowest index: (vals, level, y, x) of [B, budget]."""
    b, _, h, w = resp.shape
    vals, idx = fast_ops._topk_lowest_index(resp.reshape(b, -1), budget)
    lvl = idx // (h * w) + 1              # resp plane j <-> DoG plane j+1
    rem = idx % (h * w)
    return vals, lvl, rem // w, rem % w


def _detect_octave(imgs: torch.Tensor, octave: int, budget: int,
                   cfg: SiftConfig):
    """Top-``budget`` DoG keypoints of one octave of ``[B, h, w]`` frames.
    Returns (xy level 0 [B, K, 2], sigma, response, valid, grad_mag
    [B, h, w], grad_ang, xy in the octave [B, K, 2])."""
    s = cfg.scales_per_octave
    gauss, resp = _gated_response(imgs, cfg)
    b, h, w = imgs.shape
    if cfg.grid_cell > 0:
        vals, lvl, yi, xi = _select_grid(resp, budget, cfg.grid_cell)
    else:
        vals, lvl, yi, xi = _select_flat(resp, budget)
    y = yi.to(torch.float32)
    x = xi.to(torch.float32)
    valid = vals > 0.0

    # subpixel refinement: one clamped Newton step of the 3-D quadratic fit
    # of the DoG about the extremum (cv::SIFT's adjustLocalExtrema), from
    # the 4 surrounding Gaussian planes of each keypoint ([B, K, 4, 3, 3])
    dev = imgs.device
    lc = torch.clamp(lvl, 1, s)
    yc = torch.clamp(yi, 1, h - 2)
    xc = torch.clamp(xi, 1, w - 2)
    d3 = torch.arange(-1, 2, device=dev)
    d4 = torch.arange(-1, 3, device=dev)
    g4 = gauss[torch.arange(b, device=dev)[:, None, None, None, None],
               lc[..., None, None, None] + d4[:, None, None],
               yc[..., None, None, None] + d3[None, :, None],
               xc[..., None, None, None] + d3[None, None, :]]
    c = g4[:, :, 1:] - g4[:, :, :-1]                        # [B, K, 3, 3, 3]
    gx = 0.5 * (c[..., 1, 1, 2] - c[..., 1, 1, 0])
    gy = 0.5 * (c[..., 1, 2, 1] - c[..., 1, 0, 1])
    gs = 0.5 * (c[..., 2, 1, 1] - c[..., 0, 1, 1])
    dxx = c[..., 1, 1, 2] - 2 * c[..., 1, 1, 1] + c[..., 1, 1, 0]
    dyy = c[..., 1, 2, 1] - 2 * c[..., 1, 1, 1] + c[..., 1, 0, 1]
    dss = c[..., 2, 1, 1] - 2 * c[..., 1, 1, 1] + c[..., 0, 1, 1]
    dxy = 0.25 * (c[..., 1, 2, 2] - c[..., 1, 2, 0]
                  - c[..., 1, 0, 2] + c[..., 1, 0, 0])
    dxs = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0]
                  - c[..., 0, 1, 2] + c[..., 0, 1, 0])
    dys = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1]
                  - c[..., 0, 2, 1] + c[..., 0, 0, 1])
    hm = (torch.stack([torch.stack([dxx, dxy, dxs], -1),
                       torch.stack([dxy, dyy, dys], -1),
                       torch.stack([dxs, dys, dss], -1)], -2)
          + 1e-8 * torch.eye(3, device=dev))                 # [B, K, 3, 3]
    gvec = torch.stack([gx, gy, gs], -1)
    # solve_ex: no host sync, no raise on a singular Hessian (its inf/nan
    # offsets become 0 below, as in the JAX package)
    offs = -torch.linalg.solve_ex(hm, gvec[..., None])[0][..., 0]
    offs = torch.where(torch.isfinite(offs), offs, 0.0)
    offs = torch.clamp(offs, -0.5, 0.5)                      # dx, dy, ds
    x = x + torch.where(valid, offs[..., 0], 0.0)
    y = y + torch.where(valid, offs[..., 1], 0.0)
    k = torch.full((), 2.0 ** (1.0 / s), dtype=torch.float32, device=dev)
    sigma = (cfg.sigma0
             * torch.pow(k, lvl.to(torch.float32)
                         + torch.where(valid, offs[..., 2], 0.0))
             * (2.0 ** octave))
    xy_oct = torch.stack([x, y], -1)
    xy0 = xy_oct * (2.0 ** octave)
    # gradient maps of the middle Gaussian level (the descriptor's source)
    g = gauss[:, s // 2 + 1]
    gy_m, gx_m = torch.gradient(g, dim=(-2, -1))
    mag = torch.sqrt(gx_m * gx_m + gy_m * gy_m + 1e-12)
    ang = torch.atan2(gy_m, gx_m)
    return xy0, sigma, vals, valid, mag, ang, xy_oct


def _extract_grad_patches(mag: torch.Tensor, ang: torch.Tensor,
                          xy: torch.Tensor, patch: int = PATCH):
    """One [patch, patch] window per keypoint of the magnitude and angle
    maps ``[B, h, w]`` at ``[B, K, 2]`` keypoints, through kernel B (its
    plain version on a CPU tensor), plus each keypoint's position inside
    its window: ([B, K, P, P], [B, K, P, P], [B, K, 2])."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    pc = patch // 2 - 1
    h, w = mag.shape[-2:]
    pm = cuda_kernels.extract_patches(mag, xy, patch, pc)
    pa = cuda_kernels.extract_patches(ang, xy, patch, pc)
    x0 = torch.clamp(xy[..., 0].to(torch.int64) - pc, 0, w - patch)
    y0 = torch.clamp(xy[..., 1].to(torch.int64) - pc, 0, h - patch)
    ctr = xy - torch.stack([x0, y0], dim=-1).to(xy.dtype)
    return pm, pa, ctr


def _orientation_and_descriptor(mag: torch.Tensor, ang: torch.Tensor,
                                xy: torch.Tensor, sigma_oct: torch.Tensor,
                                valid: torch.Tensor):
    """Dominant orientation + 4x4x8 descriptor of every keypoint, per
    patch pixel (Lowe's recipe): each pixel's offset is rotated into the
    descriptor frame and its gradient soft-assigned into the histograms.
    Masked sums over ``[B*K, P*P]`` arrays and one batched product per
    orientation bin (the ``kp,kpi,kpj->kij`` contraction). Returns (theta
    [B, K], desc [B, K, 128])."""
    b, kk = valid.shape
    pm, pa, ctrs = _extract_grad_patches(mag, ang, xy)
    n = b * kk
    p = pm.shape[-1]
    pmf = pm.reshape(n, p * p)
    paf = pa.reshape(n, p * p)
    ctrs = ctrs.reshape(n, 2)
    scale = torch.clamp_max(torch.clamp_min(sigma_oct.reshape(n), 1.0) * 0.5,
                            _SCALE_CAP)
    pix = torch.arange(p, dtype=torch.float32, device=mag.device)
    py_, px_ = torch.meshgrid(pix, pix, indexing="ij")
    du = px_.reshape(1, -1) - ctrs[:, 0:1]                   # [N, P*P]
    dv = py_.reshape(1, -1) - ctrs[:, 1:2]
    inv_s = 1.0 / scale[:, None]
    gu = du * inv_s
    gv = dv * inv_s

    # orientation: a 36-bin histogram over a round window
    r = 8.0
    wgt_o = torch.exp(-(gu ** 2 + gv ** 2) / (2.0 * (r * 0.5) ** 2))
    in_o = (torch.abs(gu) <= r) & (torch.abs(gv) <= r)
    mw = torch.where(in_o, pmf * wgt_o, 0.0)
    bins = torch.clamp(torch.floor((paf + math.pi) / (2 * math.pi) * 36)
                       .to(torch.int32), 0, 35)
    hist = torch.stack([torch.sum(torch.where(bins == i, mw, 0.0), dim=1)
                        for i in range(36)], dim=1)          # [N, 36]
    hist = (torch.roll(hist, 1, dims=1) + hist
            + torch.roll(hist, -1, dims=1)) / 3.0
    # argmax takes the first maximum
    theta = ((torch.argmax(hist, dim=1).to(torch.float32) + 0.5) / 36.0
             * 2 * math.pi - math.pi)                        # [N]

    # descriptor: pixels rotated into the oriented frame
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    u = c * gu + s * gv
    v = -s * gu + c * gv
    wgt_d = torch.exp(-(u ** 2 + v ** 2) / (2.0 * 8.0 ** 2))
    in_d = (torch.abs(u) < 10.0) & (torch.abs(v) < 10.0)
    mwd = torch.where(in_d, pmf * wgt_d, 0.0)
    cu = u / 4.0 + 1.5
    cv = v / 4.0 + 1.5
    af = (paf - theta[:, None] + math.pi) / (2 * math.pi) * 8.0
    af = torch.remainder(af, 8.0)      # jnp.mod: af can be negative
    cells = torch.arange(4, dtype=torch.float32, device=mag.device)
    wx = torch.clamp_min(1.0 - torch.abs(cu[:, :, None] - cells), 0.0)
    wy = torch.clamp_min(1.0 - torch.abs(cv[:, :, None] - cells), 0.0)
    parts = []
    for o in range(8):
        d = torch.abs(af - o)
        wb = torch.clamp_min(1.0 - torch.minimum(d, 8.0 - d), 0.0)
        mb = mwd * wb
        # [N, 4 cy, 4 cx] = sum over pixels of mb * wy * wx
        parts.append((mb[:, :, None] * wy).transpose(1, 2) @ wx)
    desc = torch.stack(parts, dim=-1).reshape(n, 128)   # [N, cy*cx*8]
    # normalise, clip, renormalise (illumination invariance)
    desc = desc / torch.clamp_min(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), 1e-8)
    desc = torch.clamp_max(desc, 0.2)
    desc = desc / torch.clamp_min(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), 1e-8)
    vf = valid.reshape(n)
    theta = torch.where(vf, theta, 0.0)
    desc = torch.where(vf[:, None], desc, 0.0)
    return theta.reshape(b, kk), desc.reshape(b, kk, 128)


def _level_budgets(total: int, num_octaves: int) -> list[int]:
    inv = [2.0 ** -o for o in range(num_octaves)]
    s = sum(inv)
    out = [int(round(total * v / s)) for v in inv]
    out[0] += total - sum(out)
    return out


def _detect_and_describe_frames(imgs: torch.Tensor,
                                cfg: SiftConfig) -> SiftFeatures:
    """Full SIFT on ``[B, H, W]`` float32 frames in one pass per octave
    (``cfg.num_features`` slots per frame)."""
    budgets = _level_budgets(cfg.num_features, cfg.num_octaves)
    octave_imgs = imgs
    b = imgs.shape[0]
    dev = imgs.device
    parts = []
    for o in range(cfg.num_octaves):
        h, w = octave_imgs.shape[-2:]
        # the descriptor slices a PATCH x PATCH window, so an octave must be
        # at least that tall and wide to take part
        if budgets[o] > 0 and min(h, w) >= PATCH:
            xy0, sigma, respv, valid, mag, ang, xy_oct = _detect_octave(
                octave_imgs, o, budgets[o], cfg)
            theta, desc = _orientation_and_descriptor(
                mag, ang, xy_oct, sigma / (2.0 ** o), valid)
            parts.append((xy0, sigma, theta, respv, valid, desc))
        else:
            k = max(budgets[o], 0)

            def z(*shape, dtype=torch.float32):
                return torch.zeros((b, k) + shape, dtype=dtype, device=dev)

            parts.append((z(2), z(), z(), z(), z(dtype=torch.bool), z(128)))
        octave_imgs = image_ops.resize_bilinear(octave_imgs, h // 2, w // 2)
    xy, sc, th, rv, va, de = (torch.cat(p, dim=1) for p in zip(*parts))
    return SiftFeatures(xy=xy, scale=sc, angle=th, response=rv, valid=va,
                        descriptors=de)


def detect_and_describe(img: torch.Tensor,
                        cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """Full SIFT on one ``[H, W]`` float32 frame: fixed-size features of
    ``cfg.num_features`` slots (main.cpp:502's budget), without the batch
    axis."""
    f = _detect_and_describe_frames(img[None], cfg)
    return SiftFeatures(*(a[0] for a in f))


def detect_and_describe_batch(imgs: torch.Tensor,
                              cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """SIFT on ``[B, H, W]`` float32 frames, ``cfg.batch_chunk`` frames per
    pass: the chunk bounds the transient Gaussian / DoG stacks to
    ``[chunk, S+3, H, W]``."""
    c = max(1, min(cfg.batch_chunk, imgs.shape[0]))
    outs = [_detect_and_describe_frames(imgs[i:i + c], cfg)
            for i in range(0, imgs.shape[0], c)]
    return SiftFeatures(*(torch.cat(p) for p in zip(*outs)))
