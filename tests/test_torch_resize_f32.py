"""Kernel J's float32 mode (the SIFT octave halving) on the CPU: its tap
table, its plain version against the dense float32 resize of the port and
of the JAX package, and the SIFT front-end's bits across chunk sizes.

Tolerance against ``jax.image.resize`` and the port's dense
``resize_bilinear`` at float32: 2^-22 absolute (frames in [0, 1]). Each
output of a pass rounds its 4 products and 3 adds one by one, in ascending
input index, each rounding within 2^-24 of its exact value; the dense
forms are library products (XLA's dot, MKL's GEMM) that sum the same
nonzero terms, and the zeros between them, in their own order, with FMAs.
Measured on the SIFT fixtures (144x192 orbit, 128x256 blob, a 1080p orbit
frame, 61x77 noise): at most 1.79e-7 (1.5 x 2^-23) and 4 units in the
last place from either (5 on 90x50 portrait noise, in values below 0.5),
the two dense forms as far from each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.utils.synth_video import orbit_sequence
from slam_loop_closing_tpu_torch.config import SiftConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import image as timage
from slam_loop_closing_tpu_torch.ops import sift as tsift

torch.set_num_threads(1)

ATOL = 2.0 ** -22


# the SIFT octaves of 1080p and of the fixtures, odd sizes, and the ORB
# pyramid's scale 1.2
@pytest.mark.parametrize("n_in,n_out,taps", [
    (1080, 540, 4), (1920, 960, 4), (540, 270, 4), (960, 480, 4),
    (270, 135, 4), (480, 240, 4), (135, 67, 5), (144, 72, 4), (61, 30, 5),
    (1080, 900, 3)])
def test_resize_taps_f32_hold_every_weight(n_in, n_out, taps):
    """The float32 tap table holds every weight of ``resize_weights``
    unrounded, at its input index, in a window inside the input; its
    windows are the bfloat16 table's."""
    start, band = timage.resize_taps(n_in, n_out, torch.float32)
    assert band.shape == (n_out, taps) and band.dtype == np.float32
    assert start.min() >= 0 and start.max() + taps <= n_in
    dense = timage.resize_weights(n_in, n_out)
    rebuilt = np.zeros_like(dense)
    for k in range(taps):
        rebuilt[start + k, np.arange(n_out)] += band[:, k]
    np.testing.assert_array_equal(rebuilt, dense)
    start_b, band_b = timage.resize_taps(n_in, n_out)
    np.testing.assert_array_equal(start, start_b)
    assert band_b.shape == band.shape


FIXTURES = ("orbit 144x192", "blob 128x256", "orbit 540x960", "noise 61x77",
            "noise portrait 90x50")


@functools.cache
def fixture(name: str) -> np.ndarray:
    """[B, H, W] float32 frames of one of :data:`FIXTURES`, made when a test
    first asks (not while the module is collected)."""
    rng = np.random.default_rng(0)
    if name == "blob 128x256":
        return np.array(jax.image.resize(
            jnp.asarray(rng.random((16, 32)), jnp.float32), (128, 256),
            "bilinear"))[None]
    if name.startswith("orbit"):
        h, w = map(int, name.split()[1].split("x"))
        return np.asarray(orbit_sequence(num_frames=2 if h < 200 else 1, h=h,
                                         w=w, num_points=300, seed=11),
                          np.float32)
    h, w = map(int, name.split()[-1].split("x"))
    return rng.random((2, h, w)).astype(np.float32)


@pytest.mark.parametrize("name", FIXTURES)
def test_resize_banded_f32_near_dense_and_jax(name):
    """Three octave halvings: the banded float32 resize against the port's
    dense ``resize_bilinear`` and ``jax.image.resize`` on the same input,
    each within the stated tolerance."""
    x = fixture(name)
    for _ in range(3):
        h, w = x.shape[-2:]
        if min(h, w) < 16:
            break
        got = timage.resize_banded(torch.from_numpy(x), h // 2, w // 2,
                                   torch.float32)
        assert got.dtype == torch.float32
        got = got.numpy()
        dense = timage.resize_bilinear(torch.from_numpy(x), h // 2,
                                       w // 2).numpy()
        ref = np.stack([np.asarray(jax.image.resize(
            jnp.asarray(f), (h // 2, w // 2), "bilinear")) for f in x])
        for other in (dense, ref):
            assert np.abs(got - other).max() <= ATOL
        x = ref


def test_resize_f32_plain_frame_by_frame():
    """A batch equals its frames one at a time, bitwise, and the wrapper
    runs the plain version on a CPU tensor."""
    x = torch.from_numpy(fixture("noise 61x77"))
    whole = ck.resize_f32(x, 30, 38)
    assert torch.equal(whole, ck.resize_f32_plain(x, 30, 38))
    for f in range(x.shape[0]):
        assert torch.equal(ck.resize_f32(x[f:f + 1], 30, 38)[0], whole[f])


def test_resize_f32_checks_its_input():
    with pytest.raises(ValueError):
        ck.resize_f32(torch.zeros((2, 16, 16), dtype=torch.bfloat16), 8, 8)
    with pytest.raises(ValueError):
        ck.resize_f32(torch.zeros((16, 16)), 8, 8)


@pytest.fixture(scope="module")
def sift_frames():
    return torch.from_numpy(np.asarray(orbit_sequence(
        num_frames=4, h=144, w=192, num_points=250, seed=5), np.float32))


@pytest.mark.parametrize("grid", [0, 4])
def test_sift_front_end_bitwise_across_chunks(sift_frames, grid):
    """``detect_and_describe_batch`` over 4 frames in chunks of 1, 2 and 3:
    every field bitwise equal (the octaves come from the fixed-order
    resize)."""
    outs = [tsift.detect_and_describe_batch(sift_frames, SiftConfig(
        num_features=300, num_octaves=3, grid_cell=grid, batch_chunk=c))
        for c in (1, 2, 3)]
    assert int(outs[0].valid.sum()) > 100
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
