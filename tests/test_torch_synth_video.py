"""The port's synthetic-video module against the JAX package's (both numpy
only): the point splatter, the multi-loop fixture with its truth mask, and
the command line. Frames, trajectories and masks are bitwise equal."""

import numpy as np
import pytest

from slam_loop_closing_tpu.utils import synth_video as jsynth
from slam_loop_closing_tpu_torch.utils import synth_video as tsynth
from slam_loop_closing_tpu_torch.utils.io import load_frame_gray


def test_render_frame_bitwise():
    """Points in front of and behind the camera, blobs cut by every border."""
    rng = np.random.default_rng(4)
    n = 80
    K = np.array([[120.0, 0, 80], [0, 120.0, 60], [0, 0, 1]])
    R = np.eye(3)
    t = np.array([0.1, -0.2, 0.5])
    X = rng.uniform(-3, 3, (n, 3)) + np.array([0, 0, 3.0])
    X[:5, 2] = -1.0                                   # behind the camera
    args = (K, R, t, X, rng.uniform(0.2, 1.0, n), rng.uniform(0.5, 2.0, n),
            120, 160)
    got, ref = tsynth.render_frame(*args), jsynth.render_frame(*args)
    assert got.dtype == np.float32 and got.shape == (120, 160)
    assert got.max() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("num_frames,dy", [(24, 16.0), (50, 9.0)])
def test_multi_loop_sequence_bitwise(num_frames, dy):
    kw = dict(num_frames=num_frames, h=48, w=64, num_points=100, seed=3,
              distractor_dy=dy)
    got, ref = tsynth.multi_loop_sequence(**kw), jsynth.multi_loop_sequence(**kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    frames, thetas, ys = got
    assert frames.shape == (num_frames, 48, 64) and frames.dtype == np.float32
    assert ys.max() == dy and ys[0] == 0 and ys[-1] == 0
    assert thetas[-1] > 2 * np.pi                     # wraps past the start


@pytest.mark.parametrize("min_gap", [8, 16])
def test_ground_truth_mask_bitwise_with_true_pairs_and_hard_negatives(min_gap):
    """The truth mask equals the JAX package's, holds true pairs in both
    revisit regions, and leaves out the distractor pass: pairs at the same
    angle but a fully separated height are negatives."""
    nf, dy = 96, 16.0
    _, thetas, ys = tsynth.multi_loop_sequence(num_frames=nf, h=8, w=8,
                                               num_points=100, seed=3,
                                               distractor_dy=dy)
    gt = tsynth.ground_truth_loop_pairs(thetas, ys, min_gap)
    np.testing.assert_array_equal(
        gt, jsynth.ground_truth_loop_pairs(thetas, ys, min_gap))
    q, t = np.nonzero(gt)
    assert np.all(t <= q - min_gap)
    n1, n2 = int(0.30 * nf), int(0.13 * nf)
    assert np.sum((q >= n1) & (q < n1 + n2 + 2)) >= 3   # revisit #1
    assert np.sum(q >= nf - 15) >= 3                    # revisit #2
    dth = np.abs(thetas[:, None] - thetas[None, :])
    dth = np.minimum(dth, 2 * np.pi - dth)
    dyy = np.abs(ys[:, None] - ys[None, :])
    band = np.arange(nf)[None, :] <= np.arange(nf)[:, None] - min_gap
    hard = band & (dyy >= dy - 2.0) & (dth < 0.08)
    assert hard.sum() >= 10 and not (hard & gt).any()


def test_main_writes_the_orbit(tmp_path, capsys):
    argv = ["--out", str(tmp_path / "f"), "--frames", "3", "--height", "24",
            "--width", "32", "--points", "50", "--seed", "2"]
    assert tsynth.main(argv) == 0
    assert "Wrote 3 frames" in capsys.readouterr().out
    assert jsynth.main(["--out", str(tmp_path / "j")] + argv[2:]) == 0
    for i in range(3):
        name = f"frame_{i:04d}.png"
        np.testing.assert_array_equal(load_frame_gray(tmp_path / "f" / name),
                                      load_frame_gray(tmp_path / "j" / name))
