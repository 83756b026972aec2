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


def test_rgb_to_gray(rng):
    """BT.601 weights; one float32 dot of three terms: within 1 ulp."""
    rgb = rng.random((20, 30, 3)).astype(np.float32)
    ref = np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb)))
    got = timage.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    assert got.shape == (20, 30)
    assert ulp_distance(got, ref) <= 1


def test_undistort_image(rng):
    """Forward distortion of every pixel, then the port's bilinear sample:
    the JAX package's image within the blur tests' rounding bound."""
    img = rng.random((60, 80)).astype(np.float32)
    K = np.array([[100, 0, 40], [0, 100, 30], [0, 0, 1]], np.float32)
    dist = np.array([0.1, -0.05, 0.001, 0.002, 0.01], np.float32)
    ref = np.asarray(jimage.undistort_image(jnp.asarray(img), jnp.asarray(K),
                                            jnp.asarray(dist)))
    got = timage.undistort_image(torch.from_numpy(img), torch.from_numpy(K),
                                 torch.from_numpy(dist)).numpy()
    assert np.abs(ref - img).max() > 0.01             # the remap moves pixels
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# the pyramid's level-to-level axes at 1080p and 540x960 (scale 1.2), the
# SIFT octave's halving, odd sizes, and an upscale
@pytest.mark.parametrize("n_in,n_out,taps", [
    (1080, 900, 3), (900, 750, 3), (750, 625, 3), (1920, 1600, 3),
    (1600, 1333, 3), (1333, 1111, 3), (540, 450, 3), (143, 119, 3),
    (1080, 540, 4), (1920, 960, 4), (61, 30, 5), (40, 64, 2)])
def test_resize_taps_hold_every_weight(n_in, n_out, taps):
    """The tap table of kernel J against ``resize_weights`` rounded to
    bfloat16: T is the most nonzero weights of an output, every nonzero
    weight sits at its input index in its output's window, and the window
    lies inside the input."""
    start, band = timage.resize_taps(n_in, n_out)
    assert band.shape == (n_out, taps) and start.dtype == np.int32
    assert start.min() >= 0 and start.max() + taps <= n_in
    dense = torch.from_numpy(timage.resize_weights(n_in, n_out)).to(
        torch.bfloat16).to(torch.float32).numpy()
    rebuilt = np.zeros_like(dense)
    for k in range(taps):
        rebuilt[start + k, np.arange(n_out)] += band[:, k]
    np.testing.assert_array_equal(rebuilt, dense)


def test_resize_taps_identity_and_limit():
    """An axis that keeps its size is one tap of 1.0; a downscale that would
    need more than MAX_TAPS taps an output raises."""
    start, band = timage.resize_taps(8, 8)
    np.testing.assert_array_equal(start, np.arange(8))
    np.testing.assert_array_equal(band, np.ones((8, 1), np.float32))
    with pytest.raises(ValueError):
        timage.resize_taps(100, 20)


# landscape, portrait (columns first), odd sizes, the max(8, ...) floor that
# keeps an 8-row axis as it is, and a 9-row axis that still shrinks
@pytest.mark.parametrize("h,w,out_h,out_w", [
    (120, 160, 100, 133), (160, 120, 133, 100), (37, 61, 31, 51),
    (61, 37, 51, 31), (8, 40, 8, 33), (40, 8, 33, 8), (9, 50, 8, 42)])
def test_resize_banded_equals_dense(rng, h, w, out_h, out_w):
    """Tolerance 0: the banded sum (kernel J's plain version) against the
    dense products of ``resize_bilinear`` at bfloat16, on 8-bit noise and on
    smooth frames."""
    noise = rng.integers(0, 256, (2, h, w)) / 255.0
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 0.5 + 0.5 * np.sin(xx / 7.0 + yy / 11.0)
    imgs = torch.from_numpy(np.concatenate([noise, smooth[None]]).astype(
        np.float32)).to(torch.bfloat16)
    got = timage.resize_banded(imgs, out_h, out_w)
    ref = timage.resize_bilinear(imgs, out_h, out_w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)


@pytest.mark.parametrize("h,w", [(240, 320), (191, 143)])
def test_pyramid_level_plain_writes_both_levels(rng, h, w):
    """``cuda_kernels.pyramid_level`` on a CPU tensor: the bfloat16 level the
    next level reads and its float32 copy, from float32 frames (rounded to
    bfloat16 first) and from the bfloat16 level before."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    frames = torch.from_numpy((rng.integers(0, 256, (2, h, w)) / 255.0)
                              .astype(np.float32))
    lv_b, lv_f = cuda_kernels.pyramid_level(frames, 7 * h // 8, 7 * w // 8)
    ref = timage.resize_bilinear(frames.to(torch.bfloat16), 7 * h // 8,
                                 7 * w // 8)
    assert torch.equal(lv_b, ref) and torch.equal(lv_f, ref.float())
    nxt_b, _ = cuda_kernels.pyramid_level(lv_b, 3 * h // 4, 3 * w // 4)
    assert torch.equal(nxt_b, timage.resize_bilinear(lv_b, 3 * h // 4,
                                                     3 * w // 4))
