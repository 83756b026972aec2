"""Wrappers of the hand-written CUDA kernels of the Version-A loop detector —
the counterpart of :mod:`slam_loop_closing_tpu.ops.pallas_kernels`.

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
=====================  =============================  ==========================
"""

from __future__ import annotations

import ctypes

import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import fast as fast_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import matching
from slam_loop_closing_tpu_torch.ops import orb
from slam_loop_closing_tpu_torch.utils import cuda_build

LAUNCHES = {"fast_score_nms_blur": 0, "extract_patches": 0,
            "band_count_tiles": 0}


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
    :func:`..matching.block_pair_counts` per tile."""
    f, n, _ = packed.shape
    signed = desc_ops.bits_to_signed(desc_ops.packed_to_bits(packed))
    sb = signed.reshape(f // block, block, n, desc_ops.BITS)
    vb = valid.reshape(f // block, block, n)
    tiles = [matching.block_pair_counts(sb[q], vb[q], sb[t], vb[t], scale)
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
