"""Image operations of the ORB front-end and the calibration tool: frame
shipping, separable Gaussian blur, bilinear sampling, antialiased bilinear
resize and the ORB pyramid.

Port of :mod:`slam_loop_closing_tpu.ops.image` (the subset the port's
pipelines run). Frames are ``[..., H, W]`` float32 in [0, 1]; every
function takes a leading batch of frames where the JAX package vmaps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from slam_loop_closing_tpu_torch.utils import profiling


def ship_frames(frames, device: str | torch.device) -> torch.Tensor:
    """THE frame-shipping contract, keyed on dtype only: uint8 frames move
    to ``device`` raw and convert to [0, 1] float32 there (a quarter of the
    bytes of float32 on the host-to-device link); float frames pass through
    as float32 unchanged. Accepts numpy arrays or tensors. A copy from the
    host to a device is the span ``slam.image.upload``."""
    fr = torch.as_tensor(frames)
    if fr.device.type == "cpu" and torch.device(device).type != "cpu":
        with profiling.annotate("slam.image.upload", bytes=fr.nbytes):
            fr = fr.to(device)
    else:
        fr = fr.to(device)
    if fr.dtype == torch.uint8:
        # a tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which is 1 ulp off true division for some pixels
        return fr.to(torch.float32) / torch.full((), 255.0, device=fr.device)
    return fr.to(torch.float32)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [...] with the BT.601 weights OpenCV uses."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return img @ w


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> torch.Tensor:
    """Normalised 1-D Gaussian taps, float32 on the CPU. Computed with the
    same float32 operations as the JAX package, which gives the same bits
    (tests hold them equal)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a length-``n`` axis padded by ``pad`` on each side
    in numpy's ``reflect`` mode (edge sample not repeated)."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(imgs: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding over the last two axes:
    vertical pass, then horizontal, each accumulated tap by tap in the order
    of the JAX package (``out = k0*x0; out = out + k_i*x_i``)."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    r = (len(k) - 1) // 2
    h, w = imgs.shape[-2:]
    x = imgs.index_select(-2, reflect_index(h, r, imgs.device))
    out = k[0] * x[..., 0:h, :]
    for i in range(1, 2 * r + 1):
        out = out + k[i] * x[..., i:i + h, :]
    x = out.index_select(-1, reflect_index(w, r, imgs.device))
    out = k[0] * x[..., :, 0:w]
    for i in range(1, 2 * r + 1):
        out = out + k[i] * x[..., :, i:i + w]
    return out


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [H, W] at continuous (x, y) positions ``xy`` [..., 2]
    with bilinear interpolation and edge clamping."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def undistort_image(img: torch.Tensor, K: torch.Tensor,
                    dist: torch.Tensor) -> torch.Tensor:
    """Full-image undistortion of ``img`` [H, W]: every output pixel goes
    through the FORWARD distortion model to its source pixel, sampled
    bilinearly (the remap formulation of ``cv::undistort``). The pipelines
    undistort keypoints instead (:func:`..camera.undistort_points`); this
    gives image-level parity."""
    from slam_loop_closing_tpu_torch.ops import camera as camera_ops

    h, w = img.shape
    gv, gu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    src = camera_ops.distort_points(K, dist, torch.stack([gu, gv], dim=-1))
    return bilinear_sample(img, src)


@functools.cache
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` float32 interpolation weights of an
    antialiased bilinear resize: ``jax.image.resize``'s ``compute_weight_mat``
    (triangle kernel widened by 1/scale when downsampling, columns
    normalised, samples outside the input zeroed), reproduced with the same
    float32 operations in the same order."""
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


@functools.lru_cache(maxsize=64)
def _device_weights(in_size: int, out_size: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """:func:`resize_weights` rounded to ``dtype``, as float32 on ``device``.
    Kept (never written to): a copy from host memory per call would be a
    host sync per pyramid level on a CUDA device."""
    return torch.from_numpy(resize_weights(in_size, out_size)).to(
        device=device, dtype=dtype).to(torch.float32)


def resize_bilinear(imgs: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of ``[..., H, W]`` — the arithmetic of
    ``jax.image.resize(method="bilinear")`` at the input's dtype: weights
    rounded to that dtype, one axis contracted (float32 accumulation) and
    rounded to the dtype, then the other. The axis contracted first is the
    one with the cheaper product (rows on landscape frames), the order the
    JAX einsum picks; an axis whose size does not change is left alone."""
    h, w = imgs.shape[-2:]
    dt = imgs.dtype

    def weights(n_in, n_out):
        return _device_weights(n_in, n_out, dt, imgs.device)

    def rows(x):
        return (weights(h, out_h).T @ x.to(torch.float32)).to(dt)

    def cols(x):
        return (x.to(torch.float32) @ weights(w, out_w)).to(dt)

    steps = []
    if out_h != h:
        steps.append(rows)
    if out_w != w:
        steps.append(cols)
    if h > w:
        steps.reverse()
    out = imgs
    for step in steps:
        out = step(out)
    return out


MAX_TAPS = 8   # taps an output may have in :func:`resize_taps`


@functools.cache
def resize_taps(in_size: int, out_size: int,
                dtype: torch.dtype = torch.bfloat16
                ) -> tuple[np.ndarray, np.ndarray]:
    """The banded form of :func:`resize_weights` rounded to ``dtype``
    (bfloat16: the ORB pyramid's; float32: the weights as they are, the
    SIFT octave's): for each output index ``o``, ``start[o]`` and the ``T``
    weights of inputs ``start[o] .. start[o] + T - 1`` (``[out_size]``
    int32 and ``[out_size, T]`` float32). ``T`` is the most nonzero weights
    an output has (3 at the ORB pyramid's scale 1.2, 4 at a halving); a
    window runs from the output's first nonzero weight, moved back to end
    inside the input where it would not, so every nonzero weight lies in it
    and the rest are zeros. An axis that keeps its size gets one tap of
    1.0, which leaves its input as it is. Raises above :data:`MAX_TAPS`."""
    if in_size == out_size:
        return (np.arange(out_size, dtype=np.int32),
                np.ones((out_size, 1), np.float32))
    w = torch.from_numpy(resize_weights(in_size, out_size)).to(dtype).to(
        torch.float32).numpy()
    nz = w != 0
    taps = max(1, int(nz.sum(0).max()))
    if taps > MAX_TAPS:
        raise ValueError(f"resize {in_size} -> {out_size} needs {taps} taps "
                         f"an output, above {MAX_TAPS}")
    start = np.minimum(np.argmax(nz, axis=0), in_size - taps).astype(np.int32)
    idx = start[:, None] + np.arange(taps)
    return start, w[idx, np.arange(out_size)[:, None]]


@functools.lru_cache(maxsize=64)
def device_taps(in_size: int, out_size: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16):
    """:func:`resize_taps` on ``device``, kept (never written to): a copy
    from host memory per call would be a host sync per pyramid level."""
    start, band = resize_taps(in_size, out_size, dtype)
    return (torch.from_numpy(start).to(device),
            torch.from_numpy(band).to(device))


def _banded_pass(x: torch.Tensor, dim: int, out_size: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """One axis of :func:`resize_banded`: ``acc = w_0 * x[start]``, then
    ``acc = acc + w_k * x[start + k]`` for k = 1 .. T-1 in float32 (each
    product and add rounded on its own), rounded to ``dtype``."""
    start, band = device_taps(x.shape[dim], out_size, x.device, dtype)
    shape = [1] * x.dim()
    shape[dim] = out_size
    acc = None
    for k in range(band.shape[1]):
        term = (x.index_select(dim, start + k).to(torch.float32)
                * band[:, k].reshape(shape))
        acc = term if acc is None else acc + term
    return acc.to(dtype)


def resize_banded(imgs: torch.Tensor, out_h: int, out_w: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`resize_bilinear` of ``[..., H, W]`` frames at ``dtype`` in a
    fixed order: each axis walks only its nonzero taps
    (:func:`resize_taps`), in ascending input index, in float32; rows first
    unless ``h > w``; the input and each pass rounded to ``dtype``.

    At bfloat16 every product of two bfloat16 values is exact in float32,
    so only the order of the adds could move a bit, and it is fixed here:
    bitwise equal to the dense products on the CPU fixtures, and the plain
    version of the pyramid kernel (J). At float32 (the SIFT octave
    halving, the plain version of J's float32 mode) the products round
    too, so it is within a few ulp of the dense float32 products, whose
    order (and FMA) is the library's own."""
    h, w = imgs.shape[-2:]
    dims = [(-2, out_h), (-1, out_w)]
    if h > w:
        dims.reverse()
    out = imgs.to(dtype)
    for dim, n in dims:
        out = _banded_pass(out, dim, n, dtype)
    return out


def pyramid(imgs: torch.Tensor, num_levels: int,
            scale_factor: float) -> list[torch.Tensor]:
    """ORB pyramid of ``[B, H, W]`` float32 frames: level L is level L-1
    resized by ``1/scale_factor``, the chain run in bfloat16 as the JAX
    package runs it (level 0 is the input itself). Returns float32 levels.
    Each level is one launch of the pyramid kernel (J) on a CUDA tensor,
    :func:`resize_banded` on a CPU one: its sums are in a fixed order, so
    a level's bits do not depend on the batch size."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    levels = [imgs]
    h, w = imgs.shape[-2:]
    prev = imgs
    for lvl in range(1, num_levels):
        s = scale_factor ** lvl
        nh, nw = max(8, int(round(h / s))), max(8, int(round(w / s)))
        prev, level = cuda_kernels.pyramid_level(prev, nh, nw)
        levels.append(level)
    return levels
