"""The port's calibration tool against the JAX package's on the CPU, on
synthetic chessboard renders with a known K: the saddle response (1e-5),
the detected saddle points, the X-corner scores, the ordered and refined
corner grid (1e-2 px), the Gauss-Newton refinement from the same start, and
the whole calibration (K within 0.5%, RMS within 10% of the JAX result;
measured: K within 2e-5 relative, RMS within 1e-4 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.config import CalibrationConfig as JaxCalibConfig
from slam_loop_closing_tpu.models import calibration as jcal
from slam_loop_closing_tpu.ops import image as jimage
from slam_loop_closing_tpu_torch.config import CalibrationConfig
from slam_loop_closing_tpu_torch.models import calibration as tcal
from slam_loop_closing_tpu_torch.ops import image as timage
from slam_loop_closing_tpu_torch.utils.synth_video import chessboard_views

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def chessboard_set():
    """6 views of a 9x6-inner-corner board (reference geometry,
    calibrate.cpp:9-10) with known K: test_calibration.py's scene."""
    return chessboard_views()


@pytest.fixture(scope="module")
def grids(chessboard_set):
    """find_chessboard of the first view by both packages."""
    _, images = chessboard_set
    return (jcal.find_chessboard(images[0], 6, 9),
            tcal.find_chessboard(images[0], 6, 9, device="cpu"))


def test_scene_equals_jax_test_scene(chessboard_set):
    """The port's renderer draws test_calibration.py's fixture."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from test_calibration import render_chessboard

    from slam_loop_closing_tpu_torch.utils.synth_video import \
        render_chessboard as port_render

    K, _ = chessboard_set
    R = np.eye(3)
    t = np.array([-0.135, -0.09, 0.65])
    np.testing.assert_array_equal(
        port_render(K, R, t, 7, 10, 0.03, 60, 80),
        render_chessboard(K, R, t, 7, 10, 0.03, 60, 80))


def test_bilinear_sample_equals_jax(rng):
    img = rng.random((20, 30)).astype(np.float32)
    xy = rng.uniform(-3, 33, (50, 4, 2)).astype(np.float32)
    ref = np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    got = timage.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


class TestCornerDetection:
    def test_saddle_response(self, chessboard_set):
        _, images = chessboard_set
        for img in (images[0], images[3][::2, ::2]):
            img = np.ascontiguousarray(img)
            ref = np.asarray(jcal.saddle_response(jnp.asarray(img)))
            got = tcal.saddle_response(torch.from_numpy(img)).numpy()
            assert ref.max() > 1e-3
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    def test_saddle_points_and_scores(self, chessboard_set):
        _, images = chessboard_set
        img = images[1]
        xy_r, v_r, ok_r = (np.asarray(a) for a in jcal.detect_saddle_points(
            jnp.asarray(img), 162))
        xy, v, ok = (a.numpy() for a in tcal.detect_saddle_points(
            torch.from_numpy(img.copy()), 162))
        np.testing.assert_array_equal(ok, ok_r)
        np.testing.assert_allclose(v, v_r, rtol=0, atol=1e-7)
        np.testing.assert_allclose(xy[ok], xy_r[ok_r], rtol=0, atol=1e-3)
        s_r = np.asarray(jcal.xcorner_scores(jnp.asarray(img),
                                             jnp.asarray(xy_r)))
        s = tcal.xcorner_scores(torch.from_numpy(img.copy()),
                                torch.from_numpy(xy_r.copy())).numpy()
        np.testing.assert_allclose(s, s_r, rtol=0, atol=1e-6)
        assert np.sum(s > 0.25) >= 54

    def test_finds_inner_corners(self, grids):
        (g_ref, layout_ref), (g, layout) = grids
        assert g is not None, "chessboard not found"
        assert g.shape == (54, 2) and g.dtype == np.float32
        assert layout == layout_ref
        # corners after subpixel refinement: 1e-2 px (measured 5e-4)
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-2)

    def test_corner_accuracy(self, grids):
        """Detected corners are sub-pixel close to a projective grid
        (homography residual), and the host helpers equal the JAX
        package's."""
        _, (g, (r, c)) = grids
        gy, gx = np.mgrid[0:r, 0:c]
        obj = np.stack([gx.ravel() * 0.03, gy.ravel() * 0.03], 1)
        H = tcal.homography_dlt(obj, g)
        np.testing.assert_array_equal(H, jcal.homography_dlt(obj, g))
        ph = np.concatenate([obj, np.ones((len(obj), 1))], 1) @ H.T
        err = np.linalg.norm(ph[:, :2] / ph[:, 2:] - g, axis=1)
        assert np.median(err) < 1.0, f"median corner error {np.median(err)}"
        shuffled = g[np.random.default_rng(0).permutation(54)]
        np.testing.assert_array_equal(tcal.order_grid(shuffled, r, c),
                                      jcal.order_grid(shuffled, r, c))
        assert tcal.order_grid(g[:20], r, c) is None
        assert tcal._grid_plausible(g, r, c)


class TestTwoScaleRetry:
    def test_downscaled_detection(self, chessboard_set, grids):
        """Pixel-scale checkerboard noise defeats the full-resolution pass;
        the half-scale pass must find the board, as in the JAX package, and
        scale the corners back."""
        _, images = chessboard_set
        img = images[0]
        ys, xs = np.mgrid[0:img.shape[0], 0:img.shape[1]]
        noisy = np.clip(img + 0.35 * ((xs + ys) % 2) - 0.175, 0, 1
                        ).astype(np.float32)
        g, layout = tcal.find_chessboard(noisy, 6, 9, device="cpu")
        g_ref, layout_ref = jcal.find_chessboard(noisy, 6, 9)
        assert g is not None, "half-scale retry did not find the board"
        assert layout == layout_ref
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-2)
        g_clean = grids[1][0]
        err = np.linalg.norm(np.sort(g, axis=0) - np.sort(g_clean, axis=0),
                             axis=1)
        assert np.median(err) < 2.0, f"median corner error {np.median(err)}"

    def test_no_board(self):
        flat = np.full((120, 160), 0.5, np.float32)
        assert tcal.find_chessboard(flat, 6, 9, device="cpu") == (None, None)


class TestSubpixRefine:
    def test_refine_improves_perturbed_corners(self, chessboard_set, grids):
        """Corners perturbed by ~1.5 px are pulled back to sub-pixel
        accuracy, to the JAX function's result within 1e-2 px."""
        _, images = chessboard_set
        g = grids[1][0]
        pert = g + np.random.default_rng(0).uniform(-1.5, 1.5, g.shape
                                                    ).astype(np.float32)
        ref = np.asarray(jcal.refine_corners_subpix(
            jnp.asarray(images[0]), jnp.asarray(pert), 5, 30, 1e-3))
        got = tcal.refine_corners_subpix(
            torch.from_numpy(images[0].copy()), torch.from_numpy(pert),
            5, 30, 1e-3).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
        before = np.linalg.norm(pert - g, axis=1).mean()
        after = np.linalg.norm(got - g, axis=1).mean()
        assert after < 0.5 * before, f"{before:.3f} -> {after:.3f}"

    def test_flat_window_keeps_the_corner(self):
        """A singular system (no gradient in the window) leaves the corner
        where it was."""
        flat = torch.full((40, 40), 0.5)
        p = torch.tensor([[20.0, 20.0], [11.5, 30.25]])
        assert torch.equal(tcal.refine_corners_subpix(flat, p, 5, 3), p)


class TestCalibration:
    def test_zhang_host_parts_equal_jax(self, chessboard_set):
        K, _ = chessboard_set
        rng = np.random.default_rng(1)
        gy, gx = np.mgrid[0:6, 0:9]
        obj = np.stack([gx.ravel() * 0.03, gy.ravel() * 0.03], 1)
        Hs = []
        for _ in range(3):
            rv = rng.uniform(-0.3, 0.3, 3)
            R = tcal.lie.so3_exp(torch.tensor(rv)).numpy()
            t = np.array([-0.1, -0.08, rng.uniform(0.5, 0.8)])
            Hs.append(K @ np.stack([R[:, 0], R[:, 1], t], 1))
        K0 = tcal.intrinsics_from_homographies(Hs, (240, 320))
        np.testing.assert_array_equal(
            K0, jcal.intrinsics_from_homographies(Hs, (240, 320)))
        np.testing.assert_allclose(K0, K, rtol=1e-6, atol=1e-6)
        for H in Hs:
            got = tcal.extrinsics_from_homography(K0, H)
            ref = jcal.extrinsics_from_homography(K0, H)
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])

    def test_refine_calibration_equals_jax(self, chessboard_set):
        """The joint refinement from the same perturbed start on exact
        projections: the JAX result (intrinsics 1e-3 relative, distortion
        1e-4, poses 1e-4, RMS 1e-3 px), and a lower cost than the start.
        The damping is a fixed share of the normal matrix's trace, which the
        pose terms dominate: the focal lengths hardly move and the
        distortion terms absorb the error, in both packages alike."""
        rng = np.random.default_rng(3)
        gy, gx = np.mgrid[0:6, 0:9]
        obj = np.stack([gx.ravel() * 0.03, gy.ravel() * 0.03,
                        np.zeros(54)], 1).astype(np.float32)
        poses = np.concatenate([rng.uniform(-0.25, 0.25, (4, 3)),
                                np.tile([-0.12, -0.08, 0.65], (4, 1))
                                + rng.uniform(-0.02, 0.02, (4, 3))],
                               1).astype(np.float32)
        intr = np.array([300, 300, 160, 120, -0.05, 0.01, 0, 0, 0], np.float32)
        pts = tcal._project_calib(torch.from_numpy(intr),
                                  torch.from_numpy(poses),
                                  torch.from_numpy(obj)).numpy()
        intr0 = intr * np.array([1.02, 0.98, 1.01, 0.99, 0, 0, 0, 0, 0],
                                np.float32)
        poses0 = poses + rng.normal(0, 0.003, poses.shape).astype(np.float32)
        ref = jcal.refine_calibration(jnp.asarray(intr0), jnp.asarray(poses0),
                                      jnp.asarray(obj), jnp.asarray(pts), 20)
        got = tcal.refine_calibration(
            torch.from_numpy(intr0), torch.from_numpy(poses0),
            torch.from_numpy(obj), torch.from_numpy(pts), 20)
        np.testing.assert_allclose(got[0][:4].numpy(), np.asarray(ref[0])[:4],
                                   rtol=1e-3)
        np.testing.assert_allclose(got[0][4:].numpy(), np.asarray(ref[0])[4:],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=1e-4)
        assert abs(float(got[2]) - float(ref[2])) < 1e-3
        start = tcal._project_calib(torch.from_numpy(intr0),
                                    torch.from_numpy(poses0),
                                    torch.from_numpy(obj)).numpy() - pts
        assert float(got[2]) < 0.2 * np.sqrt(np.mean(start ** 2) * 2.0)

    def test_recovers_intrinsics(self, chessboard_set):
        K_gt, images = chessboard_set
        logs = []
        res = tcal.calibrate_camera(
            images, CalibrationConfig(board_cols=9, board_rows=6,
                                      square_size_m=0.03),
            log=logs.append, device="cpu")
        ref = jcal.calibrate_camera(
            images, JaxCalibConfig(board_cols=9, board_rows=6,
                                   square_size_m=0.03), log=lambda *a: None)
        assert res.num_images == ref.num_images >= 4
        assert res.rms < 1.0, f"RMS {res.rms}"
        assert abs(res.K[0, 0] - K_gt[0, 0]) / K_gt[0, 0] < 0.05
        assert abs(res.K[1, 1] - K_gt[1, 1]) / K_gt[1, 1] < 0.05
        assert abs(res.K[0, 2] - K_gt[0, 2]) < 12.0
        assert abs(res.K[1, 2] - K_gt[1, 2]) < 12.0
        # against the JAX result: K and the RMS differ by 2e-5 and 1e-4
        # (relative), held at 1e-3 and 1e-2
        np.testing.assert_allclose(res.K, ref.K, rtol=1e-3, atol=1e-9)
        assert abs(res.rms - ref.rms) < 1e-2 * ref.rms
        np.testing.assert_allclose(res.dist, ref.dist, rtol=0, atol=1e-3)
        assert len(res.per_image_poses) == res.num_images
        R, t = res.per_image_poses[0]
        np.testing.assert_allclose(R, ref.per_image_poses[0][0], atol=1e-3)
        np.testing.assert_allclose(t, ref.per_image_poses[0][1], atol=1e-3)
        assert logs[0] == "Image 0: found 6x9 corners"
        assert logs[-3].startswith("Calibration RMS reprojection error: ")

    def test_needs_two_boards(self):
        flat = np.full((120, 160), 0.5, np.float32)
        with pytest.raises(ValueError):
            tcal.calibrate_camera([flat, flat], log=lambda *a: None,
                                  device="cpu")
