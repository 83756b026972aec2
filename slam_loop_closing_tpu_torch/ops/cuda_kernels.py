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

=====================  ============================  ===========================
wrapper                source                        replaces (TPU kernel)
=====================  ============================  ===========================
fast_score_nms_blur    csrc/fast_score_nms_blur.cu   ``_fast_kernel``
extract_patches        csrc/extract_patches.cu       ``_patch_kernel``
band_count_tiles       csrc/band_counts.cu           ``_band_d1_kernel`` and
                                                     ``_band_counts_kernel``
pair_counts            csrc/band_counts.cu           ``_pair_d1_kernel``
hamming_nn             csrc/hamming_nn.cu            ``_hamming_nn_kernel``
hamming_knn2           csrc/hamming_nn.cu            ``_hamming_knn2_kernel``
hamming_d1             csrc/hamming_d1.cu            ``_hamming_d1_kernel``
motion_support         csrc/motion_support.cu        ``_support_kernel``
l2_knn2                csrc/l2_knn2.cu               ``_l2_knn2_kernel``
gauss_stack_resp       csrc/gauss_stack_resp.cu      ``_gauss_stack_resp_kernel``
                                                     and ``_gauss_stack_kernel``
pyramid_level          csrc/pyramid_level.cu         none: XLA's resize matmuls
resize_f32             csrc/pyramid_level.cu         none: XLA's resize matmuls
orient_moments         csrc/orient_moments.cu        none: XLA's moment sums
segment_sums,          csrc/segment_sum.cu           none: XLA's scatter-adds
segment_sum
=====================  ============================  ===========================

``pyramid_level`` (J), its float32 mode ``resize_f32`` (the SIFT octave
halving) and ``orient_moments`` (M) replace work that the JAX package leaves
to XLA and the port first ran as cuBLAS products: they sum in a fixed order,
so the front-end's bits do not depend on its batch size. ``segment_sum``
(N) replaces the float atomics of CUDA's ``index_add_`` in the normal
equations of BA and PGO: its sums run in a fixed order, so the backend
gives the same bits at every run.

``band_count_tiles``, ``pair_counts`` and ``hamming_d1`` share one inner loop,
``csrc/hamming_mma.cuh``: the tensor cores' one-bit and-popc product on the
packed words. ``hamming_knn2`` and ``hamming_nn`` run the same product
through ``csrc/hamming_knn2.cuh``, which folds each distance and its target
row into one key for an exact top-2 (top-1 for ``hamming_nn``) with index.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import fast as fast_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import matching
from slam_loop_closing_tpu_torch.ops import orb
from slam_loop_closing_tpu_torch.ops import sift as sift_ops
from slam_loop_closing_tpu_torch.utils import cuda_build

LAUNCHES = {"fast_score_nms_blur": 0, "extract_patches": 0,
            "band_count_tiles": 0, "pair_counts": 0, "hamming_nn": 0,
            "hamming_knn2": 0, "motion_support": 0, "l2_knn2": 0,
            "gauss_stack_resp": 0, "hamming_d1": 0, "pyramid_level": 0,
            "resize_f32": 0, "orient_moments": 0, "segment_sum": 0}


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
    """Launch ``slam_<name>`` on ``device``'s current stream and, for a
    kernel of :data:`LAUNCHES`, count it. The device is made current only
    when it is not already; the stream's handle is read without building a
    ``torch.cuda.Stream`` (``probe_segment_forms.py`` times both)."""
    fn = getattr(cuda_build.load(), f"slam_{name}")
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        stream = torch._C._cuda_getCurrentRawStream(index)
        cuda_build.check(fn(*args, stream), name)
    else:
        with torch.cuda.device(index):
            stream = torch._C._cuda_getCurrentRawStream(index)
            cuda_build.check(fn(*args, stream), name)
    if name in LAUNCHES:
        LAUNCHES[name] += 1


@functools.cache
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (asked once: the
    keyframe step launches kernel G at every frame)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _target_splits(blocks: int, blocks_per_sm: int, n_t: int,
                   min_rows: int, sm_count: int) -> int:
    """Number of splits of the target rows of one launch of a kernel whose
    pair list (or batch) alone gives ``blocks`` blocks: 1 when these give
    every SM ``blocks_per_sm`` blocks, else enough to, with no split
    scanning fewer than ``min_rows`` target rows (kernels E, F, G and I)."""
    want = -(-blocks_per_sm * sm_count // max(blocks, 1))
    return max(1, min(want, n_t // min_rows))


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


@functools.cache
def _blur_taps(sigma: float, radius: int):
    """The blur's float32 taps as a C array (computed once per setting: the
    live path launches kernel A four times a frame)."""
    taps = image_ops.gaussian_kernel1d(sigma, radius).tolist()
    return (ctypes.c_float * len(taps))(*taps)


def fast_score_nms_blur(imgs: torch.Tensor, threshold: float = 20.0 / 255.0,
                        blur_sigma: float = 2.0, blur_radius: int = 3):
    """:func:`fast_score_nms_blur_plain` of ``[B, H, W]`` float32 frames, as
    one kernel launch on a CUDA tensor (blur radius 3 only). The score and
    the NMS are bitwise equal to the plain version; so is the blur (no FMA
    contraction, same tap order)."""
    _require(imgs.dim() == 3 and imgs.dtype == torch.float32,
             "imgs must be [B, H, W] float32")
    if not _on_cuda(imgs):
        return fast_score_nms_blur_plain(imgs, threshold, blur_sigma,
                                         blur_radius)
    b, h, w = imgs.shape
    _require(blur_radius == 3, "the CUDA blur has radius 3")
    _require(min(h, w) > blur_radius, "frame smaller than the blur halo")
    _require(b <= 65535, "at most 65535 frames per launch")
    imgs = imgs.contiguous()
    score = torch.empty_like(imgs)
    blurred = torch.empty_like(imgs)
    _launch("fast_score_nms_blur", imgs.device, imgs.data_ptr(),
            score.data_ptr(), blurred.data_ptr(),
            _blur_taps(float(blur_sigma), blur_radius), b, h, w, threshold)
    return score, blurred


def fast_compass_pass(imgs: torch.Tensor,
                      threshold: float = 20.0 / 255.0) -> torch.Tensor:
    """[B, H, W] bool: the pixels of ``[B, H, W]`` float32 frames that pass
    kernel A's exact compass pre-test, and so need the arc extrema. A pixel
    more than 3 px inside the frame passes when two neighbouring samples of
    the compass (ring samples 0, 4, 8, 12: 3 px up, right, down, left) both
    pass the bright test ``(r - c) - t > 0``, or both the dark test
    ``(c - r) - t > 0``, in float32. Every 9-arc of the ring holds such a
    pair, so where this is False the FAST score is exactly 0."""
    h, w = imgs.shape[-2:]
    p = torch.nn.functional.pad(imgs, (3, 3, 3, 3))
    compass = torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                           for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))])
    bright = (compass - imgs[None] - threshold) > 0.0
    dark = (imgs[None] - compass - threshold) > 0.0

    def pair(m):
        return torch.any(m & torch.roll(m, -1, dims=0), dim=0)

    return (pair(bright) | pair(dark)) & fast_ops._interior(h, w, 3,
                                                             imgs.device)


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
    (distances from the tensor cores' b1 and-popc product on the packed
    words, count finalize in the kernel). Counts are integers: bitwise equal
    to the plain version."""
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

_KNN2_PAIRS_PER_PASS = 64   # bounds the plain version's [P, N, M] block
_KNN2_SLAB = 256            # query rows a block of kernels D and F (8 x 32)
_KNN2_BLOCKS_PER_SM = 2     # blocks a target split of D and F aims for
_KNN2_MIN_SPLIT_ROWS = 64   # fewest target rows a split of D and F scans
_KNN2_MAX_ROWS = 1 << 20    # a key holds the target row in 20 bits
_KNN2_TICKETS: dict = {}    # (device, stream) -> D's and F's zeroed tickets


def _knn2_tickets(dev: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` int32 zeros on ``dev`` for the tickets of the
    split merges of kernels D and F, one buffer for each stream: a launch
    returns every ticket it takes to zero, so the buffer serves the
    stream's next launch as it is (two streams sharing one would race)."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _KNN2_TICKETS.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 64), dtype=torch.int32, device=dev)
        _KNN2_TICKETS[key] = buf
    return buf


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
    words; on CUDA tensors one launch of kernel D (kernel F's tensor-core
    block of ``csrc/hamming_knn2.cuh``, keeping each row's smallest key:
    256 query rows a block, the target rows split over blocks and each
    slab's keys merged by its last block). Bitwise equal to the plain
    version.

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
    _require(n < _KNN2_MAX_ROWS, "at most 2^20 - 1 target rows")
    dev = packed_q.device
    slabs = -(-m // _KNN2_SLAB)
    splits = _target_splits(slabs, _KNN2_BLOCKS_PER_SM, n,
                            _KNN2_MIN_SPLIT_ROWS, _sm_count(dev.index))
    # d1, idx and, with splits, the [splits, M] keys of the merge: one
    # allocation, as the live path calls this twice a frame
    buf = torch.empty((2 + (splits if splits > 1 else 0), m),
                      dtype=torch.int32, device=dev)
    tickets = _knn2_tickets(dev, slabs).data_ptr() if splits > 1 else None
    _launch("hamming_nn", dev, packed_q.data_ptr(), packed_t.data_ptr(),
            valid_q.data_ptr(), valid_t.data_ptr(), buf[0].data_ptr(),
            buf[1].data_ptr(), buf[2].data_ptr() if splits > 1 else None,
            tickets, m, n, splits)
    return buf[0], buf[1]


# --------------------------------------------------------------------------
# F: Hamming top-2 of frame pairs
# --------------------------------------------------------------------------

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
    over the whole pair list (256 query rows of a pair per block as
    tensor-core fragments, the b1 and-popc product of
    ``csrc/hamming_knn2.cuh`` with each distance folded into a (distance,
    target row) key; a short pair list splits the target rows over blocks,
    and the last block of a slab to finish merges their keys). The pairs
    index the stores in
    place (``qidx``/``tidx`` stay on the device: they must lie in range, as
    the plain version's ``index_select`` checks). Bitwise equal to the
    plain version.

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
    _require(n_t < _KNN2_MAX_ROWS, "at most 2^20 - 1 target rows a frame")
    dev = packed_q.device
    slabs = -(-n_q // _KNN2_SLAB)
    splits = _target_splits(p_cnt * slabs, _KNN2_BLOCKS_PER_SM, n_t,
                            _KNN2_MIN_SPLIT_ROWS, _sm_count(dev.index))
    # with splits, the [splits, P, N] int2 keys of the merge (first, so
    # 8-byte aligned), then d1, idx and d2: one allocation, as the keyframe
    # step calls this once a frame
    scratch = 2 * splits if splits > 1 else 0
    buf = torch.empty((scratch + 3, p_cnt, n_q), dtype=torch.int32,
                      device=dev)
    base, plane = buf.data_ptr(), 4 * p_cnt * n_q
    tickets = (_knn2_tickets(dev, p_cnt * slabs).data_ptr() if splits > 1
               else None)
    _launch("hamming_knn2", dev, packed_q.data_ptr(), packed_t.data_ptr(),
            valid_q.data_ptr(), valid_t.data_ptr(), qidx.data_ptr(),
            tidx.data_ptr(), *(base + (scratch + k) * plane for k in range(3)),
            base if splits > 1 else None, tickets, p_cnt, n_q, n_t, splits)
    return tuple(buf[scratch:].unbind(0))


# --------------------------------------------------------------------------
# I: d1-only Hamming nearest neighbour of frame pairs
# --------------------------------------------------------------------------

_D1_SLAB = 1024          # query rows per block of kernel I (8 warps x 128)
_D1_BLOCKS_PER_SM = 2     # blocks a target split of kernel I aims for
_D1_MIN_SPLIT_ROWS = 128  # fewest target rows a split of kernel I scans


def hamming_d1_pairs_plain(packed_q: torch.Tensor, packed_t: torch.Tensor,
                           valid_t: torch.Tensor, qidx: torch.Tensor,
                           tidx: torch.Tensor) -> torch.Tensor:
    """[P, N] int32 nearest-target Hamming distance of every row of the
    query frames ``qidx`` [P] of the store ``packed_q`` [Fq, N, 8] int32 to
    the valid rows of the target frames ``tidx`` of ``packed_t`` [Ft, M, 8]
    (validity ``valid_t`` [Ft, M]); 2^30 where the target frame has no valid
    row. Query validity is the caller's. The +-1 matmul of
    :func:`..matching.hamming_matrix` and a row minimum, a bounded number of
    pairs at a time."""
    outs = []
    for s in range(0, qidx.shape[0], _KNN2_PAIRS_PER_PASS):
        qi = qidx[s:s + _KNN2_PAIRS_PER_PASS].long()
        ti = tidx[s:s + _KNN2_PAIRS_PER_PASS].long()
        d = matching.hamming_matrix(_signed_frames(packed_q, qi),
                                    _signed_frames(packed_t, ti))
        d = torch.where(valid_t.index_select(0, ti)[:, None, :], d,
                        matching.BIG)
        outs.append(torch.amin(d, dim=-1))
    if not outs:
        return torch.zeros((0, packed_q.shape[1]), dtype=torch.int32,
                           device=packed_q.device)
    return torch.cat(outs).to(torch.int32)


def hamming_d1_pairs(packed_q: torch.Tensor, packed_t: torch.Tensor,
                     valid_t: torch.Tensor, qidx: torch.Tensor,
                     tidx: torch.Tensor) -> torch.Tensor:
    """:func:`hamming_d1_pairs_plain`; on CUDA tensors one launch of kernel I
    over the whole pair list (128 query rows per warp as tensor-core
    fragments in registers, target rows staged in shared memory, the b1
    and-popc product of ``csrc/hamming_mma.cuh``). The pairs index the
    stores in place (``qidx``/``tidx`` stay on the device: they must lie in
    range, as the plain version's ``index_select`` checks). Bitwise equal to
    the plain version."""
    for w, name in ((packed_q, "query"), (packed_t, "target")):
        _require(w.dim() == 3 and w.shape[2] == desc_ops.WORDS
                 and w.dtype == torch.int32,
                 f"{name} words must be [frames, rows, 8] int32")
    _require(valid_t.shape == packed_t.shape[:2]
             and valid_t.dtype == torch.bool,
             "target validity must be [frames, rows] bool")
    _require(qidx.shape == tidx.shape and qidx.dim() == 1,
             "qidx and tidx must be [P]")
    if not _on_cuda(packed_q, packed_t, valid_t, qidx, tidx):
        return hamming_d1_pairs_plain(packed_q, packed_t, valid_t, qidx, tidx)
    packed_q = packed_q.contiguous()
    packed_t = packed_t.contiguous()
    _require(packed_q.data_ptr() % 16 == 0 and packed_t.data_ptr() % 16 == 0,
             "packed words must be 16-byte aligned")
    # converted copies stay bound until the launch returns (see hamming_nn)
    valid_t = valid_t.contiguous().view(torch.uint8)
    qidx = qidx.to(torch.int32).contiguous()
    tidx = tidx.to(torch.int32).contiguous()
    p_cnt, n_q, n_t = qidx.shape[0], packed_q.shape[1], packed_t.shape[1]
    dev = packed_q.device
    splits = _target_splits(p_cnt * -(-n_q // _D1_SLAB), _D1_BLOCKS_PER_SM,
                            n_t, _D1_MIN_SPLIT_ROWS, _sm_count(dev.index))
    d1 = torch.empty((p_cnt, n_q), dtype=torch.int32, device=dev)
    partial = (torch.empty((splits, p_cnt, n_q), dtype=torch.int32,
                           device=dev) if splits > 1 else None)
    _launch("hamming_d1", dev, packed_q.data_ptr(), packed_t.data_ptr(),
            valid_t.data_ptr(), qidx.data_ptr(), tidx.data_ptr(),
            d1.data_ptr(), partial.data_ptr() if splits > 1 else None,
            p_cnt, n_q, n_t, splits)
    return d1


def hamming_nn_d1_plain(packed_q: torch.Tensor, packed_t: torch.Tensor,
                        valid_t: torch.Tensor) -> torch.Tensor:
    """[M] int32 nearest valid target distance of ``[M, 8]`` query rows
    against ``[N, 8]`` target rows: :func:`hamming_d1_pairs_plain` of the
    one pair."""
    zero = torch.zeros(1, dtype=torch.int32, device=packed_q.device)
    return hamming_d1_pairs_plain(packed_q[None], packed_t[None],
                                  valid_t[None], zero, zero)[0]


def hamming_nn_d1(packed_q: torch.Tensor, packed_t: torch.Tensor,
                  valid_t: torch.Tensor) -> torch.Tensor:
    """:func:`hamming_nn_d1_plain` through :func:`hamming_d1_pairs` with one
    pair (kernel I on CUDA tensors). The same contract as ``hamming_nn(...)
    [0]`` on valid query rows; a row with no valid target gets 2^30."""
    _require(packed_q.dim() == 2 and packed_t.dim() == 2
             and valid_t.dim() == 1, "one pair: [M, 8], [N, 8], [N]")
    zero = torch.zeros(1, dtype=torch.int32, device=packed_q.device)
    return hamming_d1_pairs(packed_q[None], packed_t[None], valid_t[None],
                            zero, zero)[0]


def hamming_tile_product_plain(packed_q: torch.Tensor,
                               packed_t: torch.Tensor) -> torch.Tensor:
    """[64, 64] int32 ``popc(q_i & t_j)`` of the first 64 rows of two
    ``[>= 64, 8]`` int32 word stores: the raw product the tensor-core
    kernels (C, K5, I) build their distances from,
    ``d = popc(q) + popc(t) - 2 popc(q & t)``."""
    both = packed_q[:64, None, :] & packed_t[None, :64, :]
    return torch.sum(desc_ops.popcount32(both), dim=-1).to(torch.int32)


def hamming_tile_product(packed_q: torch.Tensor,
                         packed_t: torch.Tensor) -> torch.Tensor:
    """:func:`hamming_tile_product_plain`; on CUDA tensors one warp through
    the fragment loads and the ``mma`` of ``csrc/hamming_mma.cuh``. A layout
    check for tests, on no path of the system: it has no launch count."""
    for w in (packed_q, packed_t):
        _require(w.dim() == 2 and w.shape[0] >= 64
                 and w.shape[1] == desc_ops.WORDS and w.dtype == torch.int32,
                 "words must be [>= 64, 8] int32")
    if not _on_cuda(packed_q, packed_t):
        return hamming_tile_product_plain(packed_q, packed_t)
    packed_q = packed_q.contiguous()
    packed_t = packed_t.contiguous()
    out = torch.empty((64, 64), dtype=torch.int32, device=packed_q.device)
    _launch("hamming_tile_product", packed_q.device, packed_q.data_ptr(),
            packed_t.data_ptr(), out.data_ptr())
    return out


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


_MS_SLAB = 512             # query matches a block of kernel E (128 x 4)
_MS_MIN_SPLIT = 32         # fewest target matches a split of kernel E counts
_MS_BLOCKS_PER_SM = 4      # blocks of 128 threads kernel E aims to give an SM


def motion_support(xy_q: torch.Tensor, xy_t_matched: torch.Tensor,
                   mask: torch.Tensor, radius: float,
                   tau: float) -> torch.Tensor:
    """:func:`motion_support_plain` of [N, 2] float32 points, or of a batch
    [B, N, 2] of match sets, as one kernel launch on CUDA tensors (4 query
    matches a thread in registers, the target matches staged in shared
    memory and, where the batch does not fill the card, split over blocks
    whose integer counts add up exactly; no FMA contraction). Bitwise equal
    to the plain version."""
    _require(xy_q.dim() in (2, 3) and xy_q.shape[-1] == 2
             and xy_q.dtype == torch.float32
             and xy_t_matched.shape == xy_q.shape
             and xy_t_matched.dtype == torch.float32,
             "points must be [N, 2] or [B, N, 2] float32")
    _require(mask.shape == xy_q.shape[:-1] and mask.dtype == torch.bool,
             "mask must be [N] or [B, N] bool")
    if not _on_cuda(xy_q, xy_t_matched, mask):
        return motion_support_plain(xy_q, xy_t_matched, mask, radius, tau)
    # converted copies stay bound until the launch returns (fault F4)
    xy_q = xy_q.contiguous()
    xy_t_matched = xy_t_matched.contiguous()
    mask = mask.contiguous().view(torch.uint8)
    batch = xy_q.shape[0] if xy_q.dim() == 3 else 1
    _require(batch <= 65535, "at most 65535 match sets per launch")
    n, dev = xy_q.shape[-2], xy_q.device
    out = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    _launch("motion_support", dev, xy_q.data_ptr(), xy_t_matched.data_ptr(),
            mask.data_ptr(), out.data_ptr(), batch, n,
            _target_splits(batch * -(-n // _MS_SLAB), _MS_BLOCKS_PER_SM, n,
                           _MS_MIN_SPLIT, _sm_count(dev.index)),
            _square_f32(radius),
            _square_f32(tau))
    return out


# --------------------------------------------------------------------------
# G: squared-L2 top-2 of frame pairs
# --------------------------------------------------------------------------

_L2_PAIRS_PER_PASS = 16   # bounds the plain version's [P, N, M] block
L2_DIM = 128
_L2_QUERY_ROWS = 128      # query rows a block of kernel G
_L2_STAGE_ROWS = 64       # target rows a stage of kernel G


def l2_knn2_plain(desc_q: torch.Tensor, valid_q: torch.Tensor,
                  desc_t: torch.Tensor, valid_t: torch.Tensor,
                  qidx: torch.Tensor, tidx: torch.Tensor):
    """Squared-L2 top-2 of the frame pairs (``qidx[p]``, ``tidx[p]``) of the
    stores ``desc_q`` [Fq, N, 128] / ``desc_t`` [Ft, M, 128] float32 with
    validity ``valid_q`` [Fq, N] / ``valid_t`` [Ft, M]: ([P, N] d1 float32,
    idx int32, d2 float32), :func:`..matching.knn2` of
    :func:`..matching.l2sq_matrix` (the JAX package's reference path:
    masked pairs at 1e30, the first index of the minimum, d2 the minimum
    over the other columns), a bounded number of pairs at a time."""
    outs = []
    for s in range(0, qidx.shape[0], _L2_PAIRS_PER_PASS):
        qi = qidx[s:s + _L2_PAIRS_PER_PASS].long()
        ti = tidx[s:s + _L2_PAIRS_PER_PASS].long()
        k = matching.knn2(
            matching.l2sq_matrix(desc_q.index_select(0, qi),
                                 desc_t.index_select(0, ti)),
            valid_q.index_select(0, qi), valid_t.index_select(0, ti))
        outs.append((k.d1, k.idx1, k.d2))
    if not outs:
        empty = torch.zeros((0, desc_q.shape[1]), dtype=torch.float32,
                            device=desc_q.device)
        return empty, empty.to(torch.int32), empty.clone()
    d1, idx, d2 = (torch.cat(o) for o in zip(*outs))
    return d1, idx.to(torch.int32), d2


def frame_extents(valid: torch.Tensor) -> torch.Tensor:
    """[F] int32 extent of each frame of a ``[F, N]`` bool validity: its
    last valid row + 1, 0 where no row is valid. Valid rows need not come
    first: rows before the extent may be invalid. The plain form of the
    extents that kernel G's blocks reduce from the validity bytes they
    read; one reduction on the tensor's device, no readback."""
    n = valid.shape[-1]
    if not n:
        return torch.zeros(valid.shape[:-1], dtype=torch.int32,
                           device=valid.device)
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=valid.device)
    return torch.amax(torch.where(valid, pos, 0), dim=-1)


def l2_knn2(desc_q: torch.Tensor, valid_q: torch.Tensor,
            desc_t: torch.Tensor, valid_t: torch.Tensor, qidx: torch.Tensor,
            tidx: torch.Tensor):
    """:func:`l2_knn2_plain`; on CUDA tensors one launch of kernel G over the
    whole pair list (128 query rows of a pair per block as tensor-core
    fragments, target rows staged in shared memory, the cross term in
    3xTF32, which keeps float32 accuracy; a short pair list splits the
    target rows over blocks and merges them in a second pass). The pairs
    index the stores in place; each block reduces the extents
    (:func:`frame_extents`) of its query rows and its target frame from the
    validity, and reads no row past them. Bitwise equal to the
    plain version on integer-valued descriptors; otherwise the dot products
    sum in another order than cuBLAS's (within 1e-5 at unit-norm
    descriptors).

    Unlike the TPU kernel, which leaves invalid query rows unmasked, an
    invalid query row gets (1e30, 0, 1e30) here, as on the JAX package's
    reference path."""
    for d, v, name in ((desc_q, valid_q, "query"), (desc_t, valid_t,
                                                     "target")):
        _require(d.dim() == 3 and d.shape[2] == L2_DIM
                 and d.dtype == torch.float32,
                 f"{name} descriptors must be [frames, rows, 128] float32")
        _require(v.shape == d.shape[:2] and v.dtype == torch.bool,
                 f"{name} validity must be [frames, rows] bool")
    _require(qidx.shape == tidx.shape and qidx.dim() == 1,
             "qidx and tidx must be [P]")
    if not _on_cuda(desc_q, valid_q, desc_t, valid_t, qidx, tidx):
        return l2_knn2_plain(desc_q, valid_q, desc_t, valid_t, qidx, tidx)
    desc_q = desc_q.contiguous()
    desc_t = desc_t.contiguous()
    _require(desc_q.data_ptr() % 16 == 0 and desc_t.data_ptr() % 16 == 0,
             "descriptors must be 16-byte aligned")
    # converted copies stay bound until the launch returns (fault F4)
    valid_q = valid_q.contiguous().view(torch.uint8)
    valid_t = valid_t.contiguous().view(torch.uint8)
    qidx = qidx.to(torch.int32).contiguous()
    tidx = tidx.to(torch.int32).contiguous()
    p_cnt, n_q, n_t = qidx.shape[0], desc_q.shape[1], desc_t.shape[1]
    dev = desc_q.device
    # kernel G runs one block an SM; no split under two stages of target
    # rows (the keyframe step's single pair: 12 query blocks would leave 120
    # SMs idle)
    splits = _target_splits(p_cnt * -(-n_q // _L2_QUERY_ROWS), 1, n_t,
                            2 * _L2_STAGE_ROWS, _sm_count(dev.index))
    d1 = torch.empty((p_cnt, n_q), dtype=torch.float32, device=dev)
    idx = torch.empty((p_cnt, n_q), dtype=torch.int32, device=dev)
    d2 = torch.empty((p_cnt, n_q), dtype=torch.float32, device=dev)
    partial = (torch.empty((3, splits, p_cnt, n_q), dtype=torch.int32,
                           device=dev) if splits > 1 else None)
    _launch("l2_knn2", dev, desc_q.data_ptr(), desc_t.data_ptr(),
            valid_q.data_ptr(), valid_t.data_ptr(), qidx.data_ptr(),
            tidx.data_ptr(),
            d1.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            partial.data_ptr() if splits > 1 else None, p_cnt, n_q, n_t,
            splits)
    return d1, idx, d2


# --------------------------------------------------------------------------
# H: one SIFT octave's Gaussian chain and gated DoG response
# --------------------------------------------------------------------------

GAUSS_MAX_RADIUS = 9
GAUSS_MAX_LEVELS = 8


def gauss_stack_resp_plain(imgs: torch.Tensor, sigmas, num_scales: int,
                           thr: float = 0.0, edge_r: float = 10.0,
                           border: int = 8, emit_resp: bool = True):
    """(gauss [B, L, H, W], resp [B, S, H, W] or None) of ``[B, H, W]``
    float32 frames: the chained reflect blurs of :func:`..sift._gaussian_chain`
    over the ``L = len(sigmas)`` chain sigmas and, with ``emit_resp``, the
    gated DoG response of :func:`..sift._gates` (``thr`` the float32
    contrast threshold, ``edge_r`` the edge ratio)."""
    gauss = sift_ops._gaussian_chain(imgs, sigmas)
    if not emit_resp:
        return gauss, None
    return gauss, sift_ops._gates(gauss, num_scales, thr, edge_r, border)


def gauss_stack_resp(imgs: torch.Tensor, sigmas, num_scales: int,
                     thr: float = 0.0, edge_r: float = 10.0, border: int = 8,
                     emit_resp: bool = True):
    """:func:`gauss_stack_resp_plain`; on a CUDA tensor one call of kernel H
    (one launch per level, one for the gates; ``emit_resp=False`` is the
    gauss-only mode). Bitwise equal to the plain version: the same reflect
    at every level, the same tap order without FMA contraction, exact gate
    comparisons."""
    _require(imgs.dim() == 3 and imgs.dtype == torch.float32,
             "imgs must be [B, H, W] float32")
    levels = len(sigmas)
    _require(not emit_resp or levels == num_scales + 3,
             "the response needs num_scales + 3 levels")
    if not _on_cuda(imgs):
        return gauss_stack_resp_plain(imgs, sigmas, num_scales, thr, edge_r,
                                      border, emit_resp)
    b, h, w = imgs.shape
    taps = sift_ops.chain_taps(sigmas)
    radii = [(len(t) - 1) // 2 for t in taps]
    _require(levels <= GAUSS_MAX_LEVELS, "at most 8 levels")
    _require(max(radii) <= GAUSS_MAX_RADIUS, "blur radius above 9")
    _require(min(h, w) > max(radii), "frame smaller than the blur halo")
    _require(not emit_resp or border >= 2, "the gates need border >= 2")
    flat = [v for t in taps
            for v in t + [0.0] * (2 * GAUSS_MAX_RADIUS + 1 - len(t))]
    imgs = imgs.contiguous()
    gauss = torch.empty((b, levels, h, w), dtype=torch.float32,
                        device=imgs.device)
    resp = (torch.empty((b, num_scales, h, w), dtype=torch.float32,
                        device=imgs.device) if emit_resp else None)
    _launch("gauss_stack_resp", imgs.device, imgs.data_ptr(),
            gauss.data_ptr(), resp.data_ptr() if emit_resp else None,
            (ctypes.c_float * len(flat))(*flat),
            (ctypes.c_int * levels)(*radii), levels, b, h, w,
            num_scales if emit_resp else 0, thr, edge_r,
            float(np.float32((edge_r + 1.0) ** 2)), border)
    return gauss, resp


# --------------------------------------------------------------------------
# J: a banded resize in a fixed tap order (an ORB level; its float32 mode,
# the SIFT octave halving)
# --------------------------------------------------------------------------

_PYR_LEVEL_TILE = (32, 64)    # output tile of a block of kernel J (bf16)
_PYR_HALF_TILE = (16, 64)     # the same in J's float32 mode
_PYR_SMEM = 200 * 1024        # kernel J's shared memory, at most


def pyramid_level_plain(x: torch.Tensor, out_h: int, out_w: int):
    """(bfloat16, float32) ``[B, out_h, out_w]`` level resized from ``[B, H,
    W]`` frames ``x`` (float32, rounded to bfloat16 first, or bfloat16) by
    :func:`..image.resize_banded`."""
    level = image_ops.resize_banded(x, out_h, out_w)
    return level, level.to(torch.float32)


def resize_f32_plain(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, out_h, out_w]`` float32 resize of ``[B, H, W]`` float32 frames
    by :func:`..image.resize_banded` at float32 (the SIFT octave
    halving)."""
    return image_ops.resize_banded(x, out_h, out_w, torch.float32)


@functools.lru_cache(maxsize=64)
def _pyramid_span(in_size: int, out_size: int, tile: int,
                  dtype: torch.dtype) -> int:
    """The most input indices that the outputs of one tile of ``tile``
    consecutive outputs read along an axis resized from ``in_size`` to
    ``out_size`` (kernel J holds a tile's whole input footprint in shared
    memory)."""
    start, band = image_ops.resize_taps(in_size, out_size, dtype)
    first = np.arange(0, out_size, tile)
    last = np.minimum(first + tile, out_size) - 1
    return int((start[last] + band.shape[1] - start[first]).max())


def _resize_args(x: torch.Tensor, out_h: int, out_w: int,
                 dtype: torch.dtype, tile: tuple[int, int]) -> tuple:
    """Kernel J's arguments after the pointers of the frames and levels:
    the tap tables of ``dtype`` (kept on the device), the sizes, the pass
    order and the footprint's spans of a ``tile`` (checked against the
    shared memory a block may use)."""
    b, h, w = x.shape
    _require(b <= 65535, "at most 65535 frames per launch")
    rs, rw = image_ops.device_taps(h, out_h, x.device, dtype)
    cs, cw = image_ops.device_taps(w, out_w, x.device, dtype)
    rows_first = not h > w
    th, tw = tile
    span_r = _pyramid_span(h, out_h, th, dtype)
    span_c = _pyramid_span(w, out_w, tw, dtype)
    tr, tc = rw.shape[1], cw.shape[1]
    words = (th * tr + tw * tc + th + tw + span_r * span_c
             + (th * span_c if rows_first else span_r * tw))
    _require(4 * words <= _PYR_SMEM,
             "a tile of this resize reads too many inputs")
    return (rs.data_ptr(), rw.data_ptr(), tr, cs.data_ptr(), cw.data_ptr(),
            tc, b, h, w, out_h, out_w, int(rows_first), span_r, span_c)


def pyramid_level(x: torch.Tensor, out_h: int, out_w: int):
    """:func:`pyramid_level_plain`; on a CUDA tensor one launch of kernel J
    (a 32 x 64 output tile a block, its input footprint and the first
    pass's bfloat16 intermediate in shared memory, every tap in ascending
    input index with no FMA), which writes both the bfloat16 and the
    float32 level. Bitwise equal to the plain version; a float32 input is
    rounded to bfloat16 on load."""
    _require(x.dim() == 3 and x.dtype in (torch.float32, torch.bfloat16),
             "x must be [B, H, W] float32 or bfloat16")
    if not _on_cuda(x):
        return pyramid_level_plain(x, out_h, out_w)
    x = x.contiguous()
    args = _resize_args(x, out_h, out_w, torch.bfloat16, _PYR_LEVEL_TILE)
    out_b = torch.empty((x.shape[0], out_h, out_w), dtype=torch.bfloat16,
                        device=x.device)
    out_f = torch.empty((x.shape[0], out_h, out_w), dtype=torch.float32,
                        device=x.device)
    _launch("pyramid_level", x.device, x.data_ptr(),
            int(x.dtype == torch.bfloat16), out_b.data_ptr(),
            out_f.data_ptr(), *args)
    return out_b, out_f


def resize_f32(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """:func:`resize_f32_plain`; on a CUDA tensor one launch of kernel J in
    its float32 mode (16 x 64 output tiles, nothing rounded but each
    product and add). Bitwise equal to the plain version."""
    _require(x.dim() == 3 and x.dtype == torch.float32,
             "x must be [B, H, W] float32")
    if not _on_cuda(x):
        return resize_f32_plain(x, out_h, out_w)
    x = x.contiguous()
    args = _resize_args(x, out_h, out_w, torch.float32, _PYR_HALF_TILE)
    out = torch.empty((x.shape[0], out_h, out_w), dtype=torch.float32,
                      device=x.device)
    _launch("resize_f32", x.device, x.data_ptr(), out.data_ptr(), *args)
    return out


# --------------------------------------------------------------------------
# M: ORB orientation moments in a fixed order
# --------------------------------------------------------------------------

_MOMENT_ROWS_PER_PASS = 16384   # bounds the plain version's [K, 1024, 2]


def moment_sums_plain(patches: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """[K, 2] float32 moments ``(m10, m01)`` of ``[K, P, P]`` float32 patches
    against ``weights`` [P*P, 2] in kernel M's fixed order: every product
    rounded to float32, then a pairwise tree over the P*P columns (``p =
    p[:, :h] + p[:, h:]`` for h = P*P/2, ..., 1), a bounded number of rows
    at a time."""
    k = patches.shape[0]
    flat = patches.reshape(k, -1)
    cols = flat.shape[1]
    _require(cols & (cols - 1) == 0, "P*P must be a power of two")
    out = torch.empty((k, 2), dtype=torch.float32, device=patches.device)
    for s in range(0, k, _MOMENT_ROWS_PER_PASS):
        p = flat[s:s + _MOMENT_ROWS_PER_PASS, :, None] * weights
        h = cols
        while h > 1:
            h //= 2
            p = p[:, :h] + p[:, h:]
        out[s:s + _MOMENT_ROWS_PER_PASS] = p[:, 0]
    return out


def orient_moments_plain(patches: torch.Tensor, valid: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """[K] float32 intensity-centroid angles of ``[K, P, P]`` float32
    patches: ``atan2(m01, m10)`` of :func:`moment_sums_plain`, 0 for
    invalid rows."""
    m = moment_sums_plain(patches, weights)
    return torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), 0.0)


def orient_moments(patches: torch.Tensor, valid: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """:func:`orient_moments_plain` of ``[K, 32, 32]`` patches; on CUDA
    tensors one launch of kernel M (a warp a keypoint: the tree's first
    five levels in each lane's registers, the last five by shuffles; no
    FMA). Bitwise equal to the plain version."""
    _require(patches.dim() == 3 and patches.shape[1:] == (orb.PATCH,
                                                          orb.PATCH)
             and patches.dtype == torch.float32,
             "patches must be [K, 32, 32] float32")
    _require(valid.shape == patches.shape[:1] and valid.dtype == torch.bool,
             "valid must be [K] bool")
    _require(weights.shape == (orb.PATCH * orb.PATCH, 2)
             and weights.dtype == torch.float32,
             "weights must be [1024, 2] float32")
    if not _on_cuda(patches, valid, weights):
        return orient_moments_plain(patches, valid, weights)
    patches = patches.contiguous()
    weights = weights.contiguous()
    _require(weights.data_ptr() % 8 == 0, "weights must be 8-byte aligned")
    # converted copies stay bound until the launch returns (see hamming_nn)
    valid = valid.contiguous().view(torch.uint8)
    angle = torch.empty(patches.shape[0], dtype=torch.float32,
                        device=patches.device)
    _launch("orient_moments", patches.device, patches.data_ptr(),
            valid.data_ptr(), weights.data_ptr(), angle.data_ptr(),
            patches.shape[0])
    return angle


# --------------------------------------------------------------------------
# N: segment sums in a fixed order (BA's and PGO's normal equations)
# --------------------------------------------------------------------------

SHORT_ROWS = 8    # a segment of more rows takes kernel N's long form
LONG_BLOCKS_PER_SM = 2   # blocks an SM at most that walk the long segments
MAX_SUMS = 3     # sums a launch
# kernel N's arguments for 0 to MAX_SUMS sums, packed as int64
# (csrc/segment_sum.cu: the plan's 7, the count, then 5 a sum)
SEGMENT_ARGS = [struct.Struct(f"<{8 + 5 * k}q") for k in range(MAX_SUMS + 1)]


class SegmentPlan(NamedTuple):
    """Rows grouped by the segment an index sends them to: ``order`` [E]
    int32, a stable argsort of the index (a segment's rows in ascending
    row order), and ``offsets`` [n + 1] int32, segment ``i``'s rows being
    ``order[offsets[i]:offsets[i + 1]]``. Index values outside [0, n)
    belong to no segment. ``long_ids`` [n] int32 lists the segments of
    more than ``short_rows`` rows first, ascending, ``long_count`` [] int32
    of them: kernel N gives those to its first ``long_blocks`` blocks (0 on
    the CPU) and the rest a thread a component."""

    order: torch.Tensor
    offsets: torch.Tensor
    long_ids: torch.Tensor
    long_count: torch.Tensor
    short_rows: int
    long_blocks: int

    @property
    def n(self) -> int:
        """The number of segments."""
        return self.offsets.shape[0] - 1


def segment_plan(index: torch.Tensor, n: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of ``index`` [E] into ``n`` segments: two
    stable sorts and a search, no host sync. Built once per problem and
    used by every :func:`segment_sums` over that index. A segment of more
    than :data:`SHORT_ROWS` rows takes the long form, which has at most
    :data:`LONG_BLOCKS_PER_SM` blocks an SM (and no more than the segments
    that could be long)."""
    _require(index.dim() == 1, "index must be [E]")
    _require(index.shape[0] < 2 ** 31 and n < 2 ** 31,
             "at most 2^31 - 1 rows and segments")
    short_rows = SHORT_ROWS
    idx = index.long()
    order = torch.argsort(idx, stable=True)
    bounds = torch.arange(n + 1, device=index.device)
    offsets = torch.searchsorted(idx[order], bounds)
    is_long = offsets.diff() > short_rows
    long_ids = torch.argsort((~is_long).to(torch.uint8), stable=True)
    long_blocks = 0
    if index.is_cuda:
        long_blocks = min(n, index.shape[0] // (short_rows + 1),
                          LONG_BLOCKS_PER_SM * _sm_count(index.get_device()))
    return SegmentPlan(order.to(torch.int32), offsets.to(torch.int32),
                       long_ids.to(torch.int32),
                       is_long.sum(dtype=torch.int32), short_rows, long_blocks)


def segment_sum_plain(values: torch.Tensor,
                      plan: SegmentPlan) -> torch.Tensor:
    """``[n, ...]`` sums of the rows of ``values`` [E, ...] float32 by
    segment, in kernel N's order: each segment's rows in ascending
    ``order`` position, added one by one from zero (an empty segment gives
    0). The rows are taken in plan order and summed on the CPU by
    ``index_add_``, whose loop over them runs in order; the sums come back
    on ``values``' device."""
    e = values.shape[0]
    n = plan.offsets.shape[0] - 1
    d = int(np.prod(values.shape[1:], dtype=np.int64))
    offsets = plan.offsets.cpu().long()
    rows = values.reshape(e, d)[
        plan.order[int(offsets[0]):int(offsets[-1])].long()].cpu()
    seg = torch.repeat_interleave(torch.arange(n), offsets.diff())
    out = torch.zeros((n, d), dtype=values.dtype)
    out.index_add_(0, seg, rows)
    return out.to(values.device).reshape(n, *values.shape[1:])


def segment_sums_plain(plan: SegmentPlan, *sums) -> list:
    """:func:`segment_sum_plain` of each sum: a tensor, or a pair of
    tensors read as their concatenation along the rows."""
    return [segment_sum_plain(torch.cat(s) if isinstance(s, tuple) else s,
                              plan) for s in sums]


def segment_sums(plan: SegmentPlan, *sums) -> list:
    """:func:`segment_sums_plain`: up to three sums over one plan, each
    ``[E, ...]`` float32 rows or a pair ``(first [E1, ...], second
    [E - E1, ...])`` of one row shape, read as their concatenation (no
    copy on the card); a list of ``[n, ...]`` sums. On CUDA tensors one
    launch of kernel N for all of them: no atomics, no FMA, no chain split
    over threads. Bitwise equal to the plain version. On the card the
    wrapper checks only what the kernel needs: BA and PGO call it at every
    step, and its host time sets the pace of a call."""
    if not plan.order.is_cuda:
        _require(1 <= len(sums) <= MAX_SUMS, "one to three sums a launch")
        for s in sums:
            parts = s if isinstance(s, tuple) else (s,)
            _require(len(parts) in (1, 2) and all(
                t.dim() >= 1 and t.dtype == torch.float32
                and not t.is_cuda and t.shape[1:] == parts[0].shape[1:]
                for t in parts)
                and sum(t.shape[0] for t in parts) == plan.order.shape[0],
                "a sum is [E, ...] float32 rows, or two parts of them")
        return segment_sums_plain(plan, *sums)
    e, index = plan.order.shape[0], plan.order.get_device()
    _require(1 <= len(sums) <= MAX_SUMS, "one to three sums a launch")
    args = [plan.order.data_ptr(), plan.offsets.data_ptr(),
            plan.long_ids.data_ptr(), plan.long_count.data_ptr(), plan.n,
            plan.short_rows, plan.long_blocks, len(sums)]
    outs, keep = [], []
    for s in sums:
        if type(s) is tuple:
            first, second = s[0].contiguous(), s[1].contiguous()
            _require(second.dtype == torch.float32
                     and second.get_device() == index
                     and second.shape[1:] == first.shape[1:]
                     and first.shape[0] + second.shape[0] == e,
                     "the two parts of a sum: [E1, ...] and [E - E1, ...] "
                     "float32 rows on the plan's device")
        else:
            first = second = s.contiguous()
            _require(first.shape[0] == e, "a sum has a row a plan entry")
        row = first.shape[1:]
        d = math.prod(row)
        _require(first.dtype == torch.float32 and first.get_device() == index
                 and 1 <= d <= 64, "a sum's rows are 1 to 64 float32 on "
                 "the plan's device")
        out = first.new_empty(plan.n, *row)
        # the converted copies stay bound until the launch returns
        keep += (first, second)
        outs.append(out)
        args += (first.data_ptr(), second.data_ptr(), first.shape[0], d,
                 out.data_ptr())
    _launch("segment_sum", plan.order.device,
            SEGMENT_ARGS[len(sums)].pack(*args))
    return outs


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """:func:`segment_sum_plain`, through :func:`segment_sums`."""
    return segment_sums(plan, values)[0]
