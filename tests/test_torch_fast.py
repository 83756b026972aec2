"""The port's FAST detector against the JAX package on the CPU: score, NMS,
top-K selection (ties included), and the plain version of the fused
score+NMS+blur kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.ops import fast as jfast
from slam_loop_closing_tpu.ops import image as jimage
from slam_loop_closing_tpu.ops import pallas_kernels
from slam_loop_closing_tpu_torch.ops import cuda_kernels
from slam_loop_closing_tpu_torch.ops import fast as tfast

from test_torch_image import BLUR_ATOL

torch.set_num_threads(1)


def corner_frames(rng, b, h, w):
    """8-bit frames with bright rectangles (real corners, many tied
    scores) plus noise."""
    imgs = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(6):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
            imgs[i, y:y + rng.integers(5, 12), x:x + rng.integers(5, 12)] = \
                rng.random()
    imgs += rng.normal(0, 0.05, imgs.shape)
    return (np.clip(imgs, 0, 1) * 255).round().astype(np.float32) / 255.0


@pytest.mark.parametrize("h,w", [(64, 96), (75, 133)])
def test_score_and_nms_bitwise(rng, h, w):
    """Tolerance 0: float32 min/max/subtract in the reference's order."""
    imgs = corner_frames(rng, 2, h, w)
    score = tfast.fast_score_map(torch.from_numpy(imgs))
    sup = tfast.nms(score).numpy()
    for b in range(2):
        ref = jfast.fast_score_map(jnp.asarray(imgs[b]))
        np.testing.assert_array_equal(score[b].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(sup[b], np.asarray(jfast.nms(ref)))


def tied_map(rng, b, h, w):
    """Sparse score maps drawn from 4 values: most entries tie (0 or one of
    the levels), as FAST scores of 8-bit pixels do."""
    levels = np.array([0.0, 0.25, 0.5, 0.75], np.float32)
    return levels[rng.choice(4, (b, h, w), p=[0.7, 0.1, 0.1, 0.1])]


def assert_same_selection(got, ref):
    """Identical (xy, response, valid) rows in identical order."""
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k", [50, 700])
def test_select_topk_ties_lowest_index(rng, k):
    scores = tied_map(rng, 2, 48, 64)
    got = tfast.select_topk(torch.from_numpy(scores), k, border=5)
    for b in range(2):
        ref = jfast.select_topk(jnp.asarray(scores[b]), k, 5)
        assert_same_selection([g[b] for g in got], ref)


@pytest.mark.parametrize("h,w,cell", [(48, 64, 8), (45, 61, 8), (48, 64, 4)])
def test_select_topk_grid_ties_lowest_index(rng, h, w, cell):
    scores = tied_map(rng, 2, h, w)
    k = (h // cell) * (w // cell) // 2
    got = tfast.select_topk_grid(torch.from_numpy(scores), k, 3, cell)
    for b in range(2):
        ref = jfast.select_topk_grid(jnp.asarray(scores[b]), k, 3, cell)
        assert_same_selection([g[b] for g in got], ref)


def test_plain_fused_score_matches_xla_path(rng):
    """The kernel's plain version: score+NMS bitwise equal to the JAX XLA
    path; blur within BLUR_ATOL of it (XLA's FMA contraction, see
    test_torch_image)."""
    imgs = corner_frames(rng, 2, 64, 96)
    score, blur = cuda_kernels.fast_score_nms_blur(torch.from_numpy(imgs))
    for b in range(2):
        im = jnp.asarray(imgs[b])
        np.testing.assert_array_equal(
            score[b].numpy(), np.asarray(jfast.nms(jfast.fast_score_map(im))))
        np.testing.assert_allclose(
            blur[b].numpy(), np.asarray(jimage.gaussian_blur(im, 2.0, 3)),
            rtol=0, atol=BLUR_ATOL)


def test_plain_fused_blur_matches_pallas_interior(rng):
    """Against the TPU kernel itself (interpret mode): its blur pads with
    zeros, so only the interior (> 3 px from the border) is compared,
    within BLUR_ATOL (XLA's FMA contraction). Its score runs in bf16 and
    is not compared here."""
    imgs = rng.random((2, 48, 96)).astype(np.float32)
    _, blur = cuda_kernels.fast_score_nms_blur(torch.from_numpy(imgs))
    for b in range(2):
        _, ref = pallas_kernels.fast_score_nms_blur(jnp.asarray(imgs[b]),
                                                    interpret=True)
        np.testing.assert_allclose(blur[b, 3:-3, 3:-3].numpy(),
                                   np.asarray(ref)[3:-3, 3:-3], rtol=0,
                                   atol=BLUR_ATOL)


@pytest.mark.parametrize("grid_cell", [0, 8])
@pytest.mark.parametrize("name", ["detect", "detect_with_blur"])
def test_detect_same_keypoints(rng, name, grid_cell):
    imgs = corner_frames(rng, 2, 96, 128)
    xy, resp, valid = getattr(tfast, name)(
        torch.from_numpy(imgs), num_features=40, border=8,
        grid_cell=grid_cell)[:3]
    for b in range(2):
        ref = getattr(jfast, name)(jnp.asarray(imgs[b]), num_features=40,
                                   border=8, grid_cell=grid_cell)
        assert_same_selection([xy[b], resp[b], valid[b]], ref[:3])
    assert valid.any()


def test_plain_path_counts_no_launch(rng):
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    before = cuda_kernels.LAUNCHES["fast_score_nms_blur"]
    cuda_kernels.fast_score_nms_blur(torch.zeros((1, 16, 16)))
    assert cuda_kernels.LAUNCHES["fast_score_nms_blur"] == before


@pytest.mark.parametrize("h,w,k,bands", [(64, 96, 100, 16), (75, 133, 300, 8)])
def test_select_topk_banded_ties_lowest_index(rng, h, w, k, bands):
    """Per-band top-K then the merge, on maps full of tied scores (and a
    height that is no multiple of the band count): the JAX package's
    keypoints, responses and validity, bitwise."""
    imgs = corner_frames(rng, 2, h, w)
    score = np.asarray(jfast.nms(jfast.fast_score_map(jnp.asarray(imgs[0]))))
    score = np.stack([score, np.round(score * 8) / 8])   # many exact ties
    got = tfast.select_topk_banded(torch.from_numpy(score), k, 19, bands)
    for b in range(2):
        ref = jfast.select_topk_banded(jnp.asarray(score[b]), k, 19, bands)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
