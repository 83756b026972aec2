"""Image operations of the ORB front-end: frame shipping, separable Gaussian
blur, antialiased bilinear resize and the ORB pyramid.

Port of :mod:`slam_loop_closing_tpu.ops.image` (the subset the Version-A
loop detector runs). Frames are ``[..., H, W]`` float32 in [0, 1]; every
function takes a leading batch of frames where the JAX package vmaps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def ship_frames(frames, device: str | torch.device) -> torch.Tensor:
    """THE frame-shipping contract, keyed on dtype only: uint8 frames move
    to ``device`` raw and convert to [0, 1] float32 there (a quarter of the
    bytes of float32 on the host-to-device link); float frames pass through
    as float32 unchanged. Accepts numpy arrays or tensors."""
    fr = torch.as_tensor(frames, device=device)
    if fr.dtype == torch.uint8:
        # a tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which is 1 ulp off true division for some pixels
        return fr.to(torch.float32) / torch.full((), 255.0, device=fr.device)
    return fr.to(torch.float32)


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
        return torch.from_numpy(resize_weights(n_in, n_out)).to(
            device=imgs.device, dtype=dt).to(torch.float32)

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


def pyramid(imgs: torch.Tensor, num_levels: int,
            scale_factor: float) -> list[torch.Tensor]:
    """ORB pyramid of ``[B, H, W]`` float32 frames: level L is level L-1
    resized by ``1/scale_factor``, the chain run in bfloat16 as the JAX
    package runs it (level 0 is the input itself). Returns float32 levels."""
    levels = [imgs]
    h, w = imgs.shape[-2:]
    prev = imgs.to(torch.bfloat16)
    for lvl in range(1, num_levels):
        s = scale_factor ** lvl
        nh, nw = max(8, int(round(h / s))), max(8, int(round(w / s)))
        prev = resize_bilinear(prev, nh, nw)
        levels.append(prev.to(torch.float32))
    return levels
