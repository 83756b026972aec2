"""The port's image ops against the JAX package on the CPU: resize weights,
the bf16 antialiased pyramid, the Gaussian taps and blur, frame shipping."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from slam_loop_closing_tpu.ops import image as jimage
from slam_loop_closing_tpu_torch.ops import image as timage

torch.set_num_threads(1)

# separable 7-tap blur of [0, 1] frames against XLA's CPU build: 2^-22
BLUR_ATOL = 2.0 ** -22


def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between two float32 arrays in units in the last
    place (same-sign values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("n_in,n_out", [(1080, 900), (1920, 1600),
                                        (900, 750), (1333, 1111), (191, 159),
                                        (143, 119), (10, 8)])
def test_resize_weights_equal_jax(n_in, n_out):
    """jax's own weight formula in the same float32 operations. The column
    normalisation sums in numpy's order, not XLA's: float32 weights within
    2 ulp (measured maximum 2, a few entries of a million). The pyramid
    uses them rounded to bfloat16, and those are bitwise equal."""
    ref = np.asarray(jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel,
        True))
    got = timage.resize_weights(n_in, n_out)
    assert ulp_distance(got, ref) <= 2
    assert torch.equal(torch.tensor(got).to(torch.bfloat16),
                       torch.tensor(ref).to(torch.bfloat16))


@pytest.mark.parametrize("h,w", [(240, 320), (143, 191), (191, 143)])
def test_pyramid_bitwise(rng, h, w):
    """Tolerance 0: the bf16 weights, the contraction order (rows first on
    landscape frames, columns first on portrait ones: the other order
    differs in thousands of pixels) and bf16 rounding of every intermediate
    reproduce jax.image.resize's chain."""
    frames = (rng.integers(0, 256, (2, h, w)) / 255.0).astype(np.float32)
    got = timage.pyramid(torch.from_numpy(frames), 4, 1.2)
    for b in range(2):
        ref = jimage.pyramid(jnp.asarray(frames[b]), 4, 1.2)
        assert len(ref) == len(got) == 4
        for lv_ref, lv_got in zip(ref, got):
            np.testing.assert_array_equal(lv_got[b].numpy(),
                                          np.asarray(lv_ref))


@pytest.mark.parametrize("sigma,radius,ulp", [(2.0, 3, 0), (1.0, 2, 0),
                                               (1.6, None, 1)])
def test_gaussian_kernel1d(sigma, radius, ulp):
    """The descriptor blur's taps (sigma 2, radius 3) are bitwise equal;
    elsewhere torch's and XLA's float32 exp may differ by 1 ulp (measured
    at sigma 1.6)."""
    assert ulp_distance(timage.gaussian_kernel1d(sigma, radius).numpy(),
                        np.asarray(jimage.gaussian_kernel1d(sigma, radius))
                        ) <= ulp


@pytest.mark.parametrize("h,w", [(64, 96), (143, 191)])
def test_gaussian_blur_within_rounding(rng, h, w):
    """Tolerance: absolute BLUR_ATOL on frames in [0, 1] (measured maximum
    1.2e-7, i.e. 1-4 ulp of the result). The port rounds every tap's
    multiply and add, as does the CUDA kernel, which is bitwise equal to
    it; XLA's CPU compiler fuses the 7-tap chain and contracts
    multiply-adds into FMAs, which moves the last bits of about a third of
    the pixels in each pass."""
    imgs = rng.random((2, h, w)).astype(np.float32)
    got = timage.gaussian_blur(torch.from_numpy(imgs), 2.0, 3).numpy()
    for b in range(2):
        ref = np.asarray(jimage.gaussian_blur(jnp.asarray(imgs[b]), 2.0, 3))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=BLUR_ATOL)


def test_ship_frames_uint8_and_float(rng):
    u8 = rng.integers(0, 256, (2, 16, 24)).astype(np.uint8)
    np.testing.assert_array_equal(timage.ship_frames(u8, "cpu").numpy(),
                                  np.asarray(jimage.ship_frames(u8)))
    f32 = rng.random((2, 16, 24)).astype(np.float32)
    np.testing.assert_array_equal(timage.ship_frames(f32, "cpu").numpy(), f32)
