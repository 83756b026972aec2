"""Wrappers of the port's hand-written CUDA kernels — the counterpart of
:mod:`slam_loop_closing_tpu.ops.pallas_kernels`.

Each wrapper dispatches on the device of the tensors it is given:

* on the CPU it runs the kernel's plain PyTorch version (below, named
  ``*_plain``), which is what the CPU tests exercise;
* on a CUDA device it builds the kernels if needed (:mod:`..utils.cuda_build`)
  and launches its kernel on the current stream, or raises. There is no
  fallback from the kernel to the plain version.

Each launch adds one to the wrapper's entry in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.

=====================  =============================  ==========================
wrapper                source                         replaces (TPU kernel)
=====================  =============================  ==========================
fast_score_nms_blur    csrc/fast_score_nms_blur.cu    ``_fast_kernel``
extract_patches        csrc/extract_patches.cu        ``_patch_kernel``
band_count_tiles       csrc/band_counts.cu            ``_band_d1_kernel`` and
                                                      ``_band_counts_kernel``
pair_counts            csrc/band_counts.cu            ``_pair_d1_kernel``
hamming_nn             csrc/hamming_nn.cu             ``_hamming_nn_kernel``
hamming_knn2           csrc/hamming_nn.cu             ``_hamming_knn2_kernel``
motion_support         csrc/motion_support.cu         ``_support_kernel``
=====================  =============================  ==========================
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import fast as fast_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import matching
from slam_loop_closing_tpu_torch.ops import orb
from slam_loop_closing_tpu_torch.utils import cuda_build

LAUNCHES = {"fast_score_nms_blur": 0, "extract_patches": 0,
            "band_count_tiles": 0, "pair_counts": 0, "hamming_nn": 0,
            "hamming_knn2": 0, "motion_support": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cuda"


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(cuda_build.load(), f"slam_{name}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cuda_build.check(fn(*args, stream), name)
    LAUNCHES[name] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# --------------------------------------------------------------------------
# A: FAST-9 score + 3x3 NMS + descriptor blur
# --------------------------------------------------------------------------

def fast_score_nms_blur_plain(imgs: torch.Tensor,
                              threshold: float = 20.0 / 255.0,
                              blur_sigma: float = 2.0, blur_radius: int = 3):
    """(NMS-suppressed FAST score, reflect-padded Gaussian blur) of
    ``[B, H, W]`` float32 frames: :func:`..fast.fast_score_map` +
    :func:`..fast.nms` + :func:`..image.gaussian_blur`."""
    return (fast_ops.nms(fast_ops.fast_score_map(imgs, threshold)),
            image_ops.gaussian_blur(imgs, blur_sigma, blur_radius))


def fast_score_nms_blur(imgs: torch.Tensor, threshold: float = 20.0 / 255.0,
                        blur_sigma: float = 2.0, blur_radius: int = 3):
    """:func:`fast_score_nms_blur_plain` of ``[B, H, W]`` float32 frames, as
    one kernel on a CUDA tensor (blur radius 3 only). The score and the NMS
    are bitwise equal to the plain version; so is the blur (no FMA
    contraction, same tap order)."""
    _require(imgs.dim() == 3 and imgs.dtype == torch.float32,
             "imgs must be [B, H, W] float32")
    if not _on_cuda(imgs):
        return fast_score_nms_blur_plain(imgs, threshold, blur_sigma,
                                         blur_radius)
    b, h, w = imgs.shape
    _require(blur_radius == 3, "the CUDA blur has radius 3")
    _require(min(h, w) > blur_radius, "frame smaller than the blur halo")
    imgs = imgs.contiguous()
    taps = image_ops.gaussian_kernel1d(blur_sigma, blur_radius).tolist()
    score_tmp = torch.empty_like(imgs)
    score = torch.empty_like(imgs)
    blurred = torch.empty_like(imgs)
    _launch("fast_score_nms_blur", imgs.device, imgs.data_ptr(),
            score_tmp.data_ptr(), score.data_ptr(), blurred.data_ptr(),
            (ctypes.c_float * len(taps))(*taps), b, h, w, threshold)
    return score, blurred


# --------------------------------------------------------------------------
# B: patch gather
# --------------------------------------------------------------------------

def extract_patches_plain(imgs: torch.Tensor, xy: torch.Tensor,
                          patch: int = orb.PATCH,
                          center: int = orb.PATCH_CENTER) -> torch.Tensor:
    """[B, K, patch, patch] patches at clamped integer keypoints:
    :func:`..orb.extract_patches` without the centers."""
    return orb.extract_patches(imgs, xy, patch, center)[0]


def extract_patches(imgs: torch.Tensor, xy: torch.Tensor,
                    patch: int = orb.PATCH,
                    center: int = orb.PATCH_CENTER) -> torch.Tensor:
    """:func:`extract_patches_plain` of ``[B, H, W]`` float32 frames at
    ``[B, K, 2]`` float32 (x, y) keypoints; one CUDA block per keypoint on a
    CUDA tensor. Bitwise equal to the plain version (a copy)."""
    _require(imgs.dim() == 3 and imgs.dtype == torch.float32,
             "imgs must be [B, H, W] float32")
    _require(xy.dim() == 3 and xy.shape[0] == imgs.shape[0]
             and xy.shape[2] == 2 and xy.dtype == torch.float32,
             "xy must be [B, K, 2] float32")
    if not _on_cuda(imgs, xy):
        return extract_patches_plain(imgs, xy, patch, center)
    b, h, w = imgs.shape
    k = xy.shape[1]
    _require(h >= patch and w >= patch, "frame smaller than the patch")
    imgs = imgs.contiguous()
    xy = xy.contiguous()
    out = torch.empty((b, k, patch, patch), dtype=torch.float32,
                      device=imgs.device)
    _launch("extract_patches", imgs.device, imgs.data_ptr(), xy.data_ptr(),
            out.data_ptr(), b, k, h, w, patch, center)
    return out


# --------------------------------------------------------------------------
# C: banded Hamming good-match counts
# --------------------------------------------------------------------------

def band_count_tiles_plain(packed: torch.Tensor, valid: torch.Tensor,
                           qidx: torch.Tensor, tidx: torch.Tensor, block: int,
                           scale: float = 2.0) -> torch.Tensor:
    """Good-match counts of explicit band tiles: tile ``p`` pairs the
    ``block`` frames starting at ``qidx[p] * block`` (queries) with those at
    ``tidx[p] * block`` (targets). ``packed`` is [F, N, 8] int32 descriptor
    words, ``valid`` [F, N] bool, F a multiple of ``block``. Returns
    [P, block, block] int32 ([query frame, target frame]) by
    :func:`..matching.block_pair_counts_plain` per tile."""
    f, n, _ = packed.shape
    signed = desc_ops.bits_to_signed(desc_ops.packed_to_bits(packed))
    sb = signed.reshape(f // block, block, n, desc_ops.BITS)
    vb = valid.reshape(f // block, block, n)
    tiles = [matching.block_pair_counts_plain(sb[q], vb[q], sb[t], vb[t],
                                                scale)
             for q, t in zip(qidx.tolist(), tidx.tolist())]
    if not tiles:
        return torch.zeros((0, block, block), dtype=torch.int32,
                           device=packed.device)
    return torch.stack(tiles)


def band_count_tiles(packed: torch.Tensor, valid: torch.Tensor,
                     qidx: torch.Tensor, tidx: torch.Tensor, block: int,
                     scale: float = 2.0) -> torch.Tensor:
    """:func:`band_count_tiles_plain`, as one CUDA kernel on CUDA tensors
    (XOR + popcount distances, count finalize in the kernel). Counts are
    integers: bitwise equal to the plain version."""
    _require(packed.dim() == 3 and packed.shape[2] == desc_ops.WORDS
             and packed.dtype == torch.int32, "packed must be [F, N, 8] int32")
    f, n, _ = packed.shape
    _require(valid.shape == (f, n) and valid.dtype == torch.bool,
             "valid must be [F, N] bool")
    _require(f % block == 0, "frame count must be a multiple of block")
    _require(qidx.shape == tidx.shape and qidx.dim() == 1,
             "qidx and tidx must be [P]")
    if not _on_cuda(packed, valid, qidx, tidx):
        return band_count_tiles_plain(packed, valid, qidx, tidx, block, scale)
    packed = packed.contiguous()
    _require(packed.data_ptr() % 16 == 0, "packed must be 16-byte aligned")
    valid = valid.contiguous().view(torch.uint8)
    qidx = qidx.to(torch.int32).contiguous()
    tidx = tidx.to(torch.int32).contiguous()
    p_cnt = qidx.shape[0]
    out = torch.empty((p_cnt, block, block), dtype=torch.int32,
                      device=packed.device)
    _launch("band_count_tiles", packed.device, packed.data_ptr(),
            valid.data_ptr(), qidx.data_ptr(), tidx.data_ptr(),
            out.data_ptr(), p_cnt, n, block, scale)
    return out


# --------------------------------------------------------------------------
# K5: good-match counts of explicit frame pairs (kernel C's frame-pair entry)
# --------------------------------------------------------------------------

def _signed_frames(packed: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    return desc_ops.bits_to_signed(desc_ops.packed_to_bits(
        packed.index_select(0, frames)))


def pair_counts_plain(packed: torch.Tensor, valid: torch.Tensor,
                      qidx: torch.Tensor, tidx: torch.Tensor,
                      scale: float = 2.0) -> torch.Tensor:
    """[P] int32 good-match counts of the frame pairs (``qidx[p]``,
    ``tidx[p]``) of ``packed`` [F, N, 8] int32 words with validity ``valid``
    [F, N]: :func:`..matching.block_pair_counts_plain` of each query frame
    against its targets."""
    out = torch.zeros(qidx.shape[0], dtype=torch.int32, device=packed.device)
    for q in torch.unique(qidx).tolist():
        sel = torch.nonzero(qidx == q)[:, 0]
        t = tidx[sel].long()
        qf = torch.tensor([q], device=packed.device)
        out[sel] = matching.block_pair_counts_plain(
            _signed_frames(packed, qf), valid[qf], _signed_frames(packed, t),
            valid[t], scale)[0]
    return out


def pair_counts(packed: torch.Tensor, valid: torch.Tensor, qidx: torch.Tensor,
                tidx: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """:func:`pair_counts_plain`; on CUDA tensors kernel C's device code
    launched over the pair list as 1x1 tiles (one block per pair). The
    frames stay where they are: the pairs index ``packed`` directly, so the
    live scan reads the frame database in place. Bitwise equal to the plain
    version (integers)."""
    _require(packed.dim() == 3 and packed.shape[2] == desc_ops.WORDS
             and packed.dtype == torch.int32, "packed must be [F, N, 8] int32")
    f, n, _ = packed.shape
    _require(valid.shape == (f, n) and valid.dtype == torch.bool,
             "valid must be [F, N] bool")
    _require(qidx.shape == tidx.shape and qidx.dim() == 1,
             "qidx and tidx must be [P]")
    if not _on_cuda(packed, valid, qidx, tidx):
        return pair_counts_plain(packed, valid, qidx, tidx, scale)
    packed = packed.contiguous()
    _require(packed.data_ptr() % 16 == 0, "packed must be 16-byte aligned")
    valid = valid.contiguous().view(torch.uint8)
    qidx = qidx.to(torch.int32).contiguous()
    tidx = tidx.to(torch.int32).contiguous()
    out = torch.empty(qidx.shape[0], dtype=torch.int32, device=packed.device)
    _launch("pair_counts", packed.device, packed.data_ptr(), valid.data_ptr(),
            qidx.data_ptr(), tidx.data_ptr(), out.data_ptr(), qidx.shape[0],
            n, scale)
    return out


# --------------------------------------------------------------------------
# D: Hamming nearest neighbour
# --------------------------------------------------------------------------

def hamming_nn_plain(packed_q: torch.Tensor, valid_q: torch.Tensor,
                     packed_t: torch.Tensor, valid_t: torch.Tensor):
    """Nearest valid target per query row over Hamming distance: ([M] d1,
    [M] idx) int32, the lowest index on ties. A row with an invalid query,
    or with no valid target, gets d1 = 2^30 and idx 0 (the JAX package's
    reference path: :func:`..matching._mask_dist` + argmin)."""
    sq = desc_ops.bits_to_signed(desc_ops.packed_to_bits(packed_q))
    st = desc_ops.bits_to_signed(desc_ops.packed_to_bits(packed_t))
    d = matching._mask_dist(matching.hamming_matrix(sq, st), valid_q, valid_t)
    idx = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, idx[:, None])[:, 0]
    return d1.to(torch.int32), idx.to(torch.int32)


def hamming_nn(packed_q: torch.Tensor, valid_q: torch.Tensor,
               packed_t: torch.Tensor, valid_t: torch.Tensor):
    """:func:`hamming_nn_plain` of ``[M, 8]`` / ``[N, 8]`` int32 packed
    words; on CUDA tensors one kernel (a warp per query row, XOR +
    ``__popc``). Bitwise equal to the plain version.

    Unlike the TPU kernel, which leaves invalid query rows unmasked (their
    d1 is the distance to the nearest target, for the caller to mask), an
    invalid query row gets d1 = 2^30 and idx 0 here, as on the JAX
    package's reference path."""
    for w, v, name in ((packed_q, valid_q, "query"), (packed_t, valid_t,
                                                       "target")):
        _require(w.dim() == 2 and w.shape[1] == desc_ops.WORDS
                 and w.dtype == torch.int32,
                 f"{name} words must be [rows, 8] int32")
        _require(v.shape == w.shape[:1] and v.dtype == torch.bool,
                 f"{name} validity must be [rows] bool")
    if not _on_cuda(packed_q, valid_q, packed_t, valid_t):
        return hamming_nn_plain(packed_q, valid_q, packed_t, valid_t)
    packed_q = packed_q.contiguous()
    packed_t = packed_t.contiguous()
    _require(packed_q.data_ptr() % 16 == 0 and packed_t.data_ptr() % 16 == 0,
             "packed words must be 16-byte aligned")
    # converted copies stay bound until the launch returns: a temporary
    # freed inside the argument list hands its block to the next one
    valid_q = valid_q.contiguous().view(torch.uint8)
    valid_t = valid_t.contiguous().view(torch.uint8)
    m, n = packed_q.shape[0], packed_t.shape[0]
    d1 = torch.empty(m, dtype=torch.int32, device=packed_q.device)
    idx = torch.empty(m, dtype=torch.int32, device=packed_q.device)
    _launch("hamming_nn", packed_q.device, packed_q.data_ptr(),
            packed_t.data_ptr(), valid_q.data_ptr(), valid_t.data_ptr(),
            d1.data_ptr(), idx.data_ptr(), m, n)
    return d1, idx


# --------------------------------------------------------------------------
# F: Hamming top-2 of frame pairs
# --------------------------------------------------------------------------

_KNN2_PAIRS_PER_PASS = 64   # bounds the plain version's [P, N, M] block


def hamming_knn2_plain(packed_q: torch.Tensor, valid_q: torch.Tensor,
                       packed_t: torch.Tensor, valid_t: torch.Tensor,
                       qidx: torch.Tensor, tidx: torch.Tensor):
    """Hamming top-2 of the frame pairs (``qidx[p]``, ``tidx[p]``) of the
    stores ``packed_q`` [Fq, N, 8] / ``packed_t`` [Ft, M, 8] int32 with
    validity ``valid_q`` [Fq, N] / ``valid_t`` [Ft, M]: ([P, N] d1, idx, d2)
    int32, :func:`..matching.knn2` of :func:`..matching.hamming_matrix` of
    the unpacked +-1 rows (the JAX package's reference path: masked pairs at
    2^30, the first index of the minimum, d2 the minimum over the other
    columns), a bounded number of pairs at a time."""
    outs = []
    for s in range(0, qidx.shape[0], _KNN2_PAIRS_PER_PASS):
        qi = qidx[s:s + _KNN2_PAIRS_PER_PASS].long()
        ti = tidx[s:s + _KNN2_PAIRS_PER_PASS].long()
        k = matching.knn2(
            matching.hamming_matrix(_signed_frames(packed_q, qi),
                                    _signed_frames(packed_t, ti)),
            valid_q.index_select(0, qi), valid_t.index_select(0, ti))
        outs.append((k.d1, k.idx1, k.d2))
    if not outs:
        empty = torch.zeros((0, packed_q.shape[1]), dtype=torch.int32,
                            device=packed_q.device)
        return empty, empty.clone(), empty.clone()
    return tuple(torch.cat(o).to(torch.int32) for o in zip(*outs))


def hamming_knn2(packed_q: torch.Tensor, valid_q: torch.Tensor,
                 packed_t: torch.Tensor, valid_t: torch.Tensor,
                 qidx: torch.Tensor, tidx: torch.Tensor):
    """:func:`hamming_knn2_plain`; on CUDA tensors one launch of kernel F
    over the whole pair list (a warp per query row, XOR + ``__popc``). The
    pairs index the stores in place (``qidx``/``tidx`` stay on the device:
    they must lie in range, as the plain version's ``index_select`` checks).
    Bitwise equal to the plain version.

    Unlike the TPU kernel, which leaves invalid query rows unmasked, an
    invalid query row gets (2^30, 0, 2^30) here, as on the JAX package's
    reference path."""
    for w, v, name in ((packed_q, valid_q, "query"), (packed_t, valid_t,
                                                       "target")):
        _require(w.dim() == 3 and w.shape[2] == desc_ops.WORDS
                 and w.dtype == torch.int32,
                 f"{name} words must be [frames, rows, 8] int32")
        _require(v.shape == w.shape[:2] and v.dtype == torch.bool,
                 f"{name} validity must be [frames, rows] bool")
    _require(qidx.shape == tidx.shape and qidx.dim() == 1,
             "qidx and tidx must be [P]")
    if not _on_cuda(packed_q, valid_q, packed_t, valid_t, qidx, tidx):
        return hamming_knn2_plain(packed_q, valid_q, packed_t, valid_t, qidx,
                                  tidx)
    packed_q = packed_q.contiguous()
    packed_t = packed_t.contiguous()
    _require(packed_q.data_ptr() % 16 == 0 and packed_t.data_ptr() % 16 == 0,
             "packed words must be 16-byte aligned")
    # converted copies stay bound until the launch returns (see hamming_nn)
    valid_q = valid_q.contiguous().view(torch.uint8)
    valid_t = valid_t.contiguous().view(torch.uint8)
    qidx = qidx.to(torch.int32).contiguous()
    tidx = tidx.to(torch.int32).contiguous()
    p_cnt, n_q, n_t = qidx.shape[0], packed_q.shape[1], packed_t.shape[1]
    out = [torch.empty((p_cnt, n_q), dtype=torch.int32,
                       device=packed_q.device) for _ in range(3)]
    _launch("hamming_knn2", packed_q.device, packed_q.data_ptr(),
            packed_t.data_ptr(), valid_q.data_ptr(), valid_t.data_ptr(),
            qidx.data_ptr(), tidx.data_ptr(), *(o.data_ptr() for o in out),
            p_cnt, n_q, n_t)
    return tuple(out)


# --------------------------------------------------------------------------
# E: motion-coherence support
# --------------------------------------------------------------------------

def _square_f32(x: float) -> float:
    """``x`` squared once in float32 (the TPU kernel's ``jnp.square`` of the
    float32 radius), as the Python float holding it."""
    return float(np.float32(x) * np.float32(x))


def motion_support_plain(xy_q: torch.Tensor, xy_t_matched: torch.Tensor,
                         mask: torch.Tensor, radius: float,
                         tau: float) -> torch.Tensor:
    """[..., N] int32 motion-coherence support of [..., N, 2] match sets by
    the TPU kernel's direct differences: match j supports i when ``(x_i -
    x_j)^2 + (y_i - y_j)^2 < radius^2`` and the displacements ``xy_q -
    xy_t_matched`` agree within ``tau`` the same way; self-support excluded,
    0 on invalid rows. Each square is ``d * d`` and each sum one rounding,
    as in the kernel."""
    disp = xy_q - xy_t_matched
    r2, t2 = _square_f32(radius), _square_f32(tau)

    def sq_dist(a):
        ex = a[..., :, None, 0] - a[..., None, :, 0]
        ey = a[..., :, None, 1] - a[..., None, :, 1]
        return ex * ex + ey * ey

    ok = (sq_dist(xy_q) < r2) & (sq_dist(disp) < t2) & mask[..., None, :]
    s = torch.sum(ok, dim=-1, dtype=torch.int32)
    return torch.where(mask, s - 1, 0).to(torch.int32)


def motion_support(xy_q: torch.Tensor, xy_t_matched: torch.Tensor,
                   mask: torch.Tensor, radius: float,
                   tau: float) -> torch.Tensor:
    """:func:`motion_support_plain` of [N, 2] float32 points, or of a batch
    [B, N, 2] of match sets, as one kernel launch on CUDA tensors (a thread
    per query match, the match set staged in shared memory, no FMA
    contraction). Bitwise equal to the plain version."""
    _require(xy_q.dim() in (2, 3) and xy_q.shape[-1] == 2
             and xy_q.dtype == torch.float32
             and xy_t_matched.shape == xy_q.shape
             and xy_t_matched.dtype == torch.float32,
             "points must be [N, 2] or [B, N, 2] float32")
    _require(mask.shape == xy_q.shape[:-1] and mask.dtype == torch.bool,
             "mask must be [N] or [B, N] bool")
    if not _on_cuda(xy_q, xy_t_matched, mask):
        return motion_support_plain(xy_q, xy_t_matched, mask, radius, tau)
    q = torch.cat([xy_q, xy_q - xy_t_matched], dim=-1).contiguous()
    _require(q.data_ptr() % 16 == 0, "point buffer must be 16-byte aligned")
    batch = q.shape[0] if q.dim() == 3 else 1
    _require(batch <= 65535, "at most 65535 match sets per launch")
    mask = mask.contiguous().view(torch.uint8)   # bound until the launch
    out = torch.empty(q.shape[:-1], dtype=torch.int32, device=q.device)
    _launch("motion_support", q.device, q.data_ptr(), mask.data_ptr(),
            out.data_ptr(), batch, q.shape[-2], _square_f32(radius),
            _square_f32(tau))
    return out
