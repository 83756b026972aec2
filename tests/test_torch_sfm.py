"""The port's Version-B SfM pipeline against the JAX package, on the CPU.

Module by module, the same numpy inputs from a seed go through both
packages (lie, camera with the reference's nonzero distortion, gated
triangulation, PGO dense and PCG, BA, outlier removal, one keyframe step,
the track table's duplicate-index scatter, the OBJ writer, checkpoints);
then ``SfMPipeline.run`` on test_sfm.py's 24-frame fixture, with the JAX
package's RANSAC minimal sets injected into the port (``sfm._minimal_sets``
is the port's one draw), through the host loop, ``use_scan`` and the staged
backend; and with the SIFT detector on test_sfm_sift.py's fixture, the JAX
front-end's outputs fed through the port's ``_frontend`` seam with the
draws.

Tolerances, float32 on both sides: lie within 2e-6 (5e-6 for the log),
camera within 2e-3 px for the undistortion and 5e-5 relative for a
projection (a division by the depth); triangulated points within 1e-4
relative (the normal equations square the condition number), the gates
and counters exact; PGO within 1e-4; BA within 1e-4 (cameras) and 1e-3 (points: the
port sums each camera's and point's terms in observation order, XLA in its
own order); a keyframe step
started from a converted JAX state (JAX's fused step program) within 2e-5
in the pose and 5e-3 in the new points (1.9e-3 measured, on points up to
15 units away), its discrete outcome exact; end to end the keyframes, map counts, loop pair and match /
inlier counts exact, the reprojection errors within 2e-3 relative.
"""

import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu import config as jc
from slam_loop_closing_tpu.models import sfm as jsfm
from slam_loop_closing_tpu.ops import ba as jba
from slam_loop_closing_tpu.ops import camera as jcam
from slam_loop_closing_tpu.ops import lie as jlie
from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import outliers as jout
from slam_loop_closing_tpu.ops import pgo as jpgo
from slam_loop_closing_tpu.ops import ransac as jransac
from slam_loop_closing_tpu.ops import triangulation as jtri
from slam_loop_closing_tpu.utils import checkpoint as jckpt
from slam_loop_closing_tpu.utils import io as jio
from slam_loop_closing_tpu.utils.logging import PipelineLogger as JLogger
from slam_loop_closing_tpu.utils.synth_video import orbit_sequence
from slam_loop_closing_tpu_torch import config as tc
from slam_loop_closing_tpu_torch.models import sfm as tsfm
from slam_loop_closing_tpu_torch.ops import ba as tba
from slam_loop_closing_tpu_torch.ops import camera as tcam
from slam_loop_closing_tpu_torch.ops import descriptors as tdesc
from slam_loop_closing_tpu_torch.ops import lie as tlie
from slam_loop_closing_tpu_torch.ops import matching as tmatch
from slam_loop_closing_tpu_torch.ops import outliers as tout
from slam_loop_closing_tpu_torch.ops import pgo as tpgo
from slam_loop_closing_tpu_torch.ops import ransac as transac
from slam_loop_closing_tpu_torch.ops import triangulation as ttri
from slam_loop_closing_tpu_torch.utils import checkpoint as tckpt
from slam_loop_closing_tpu_torch.utils import convert
from slam_loop_closing_tpu_torch.utils import io as tio
from slam_loop_closing_tpu_torch.utils.logging import PipelineLogger as TLogger

torch.set_num_threads(1)

STEP_FRAME = 6        # the keyframe step compared on its own
END_RTOL = 2e-3       # end-to-end reprojection errors


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, ref, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# lie, camera
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rvecs():
    """Rotation vectors: generic, near 0 (Taylor branches), near pi."""
    rng = np.random.default_rng(0)
    rv = rng.normal(size=(64, 3))
    rv[:8] *= 1e-5
    rv[8:16] *= (np.pi - 5e-4) / np.linalg.norm(rv[8:16], axis=1,
                                                keepdims=True)
    return rv.astype(np.float32)


def test_so3_exp_log_equal_jax(rvecs):
    R_ref = jlie.so3_exp_batch(jnp.asarray(rvecs))
    R = tlie.so3_exp(T(rvecs))
    close(R, R_ref, 2e-6)
    close(tlie.so3_log(T(R_ref)), jlie.so3_log_batch(R_ref), 5e-6)
    close(tlie.rotation_error(R[1:], R[:-1]),
          jax.vmap(jlie.rotation_error)(R_ref[1:], R_ref[:-1]), 5e-6)
    # the near-pi branch round-trips as the JAX package's does (its axis
    # from the diagonal of (R + I)/2 is good to ~5e-4 at 5e-4 from pi)
    rt_ref = jlie.so3_exp_batch(jlie.so3_log_batch(R_ref[8:16]))
    close(tlie.so3_exp(tlie.so3_log(R[8:16])), rt_ref, 5e-6)
    close(tlie.so3_exp(tlie.so3_log(R[8:16])), R_ref[8:16], 1e-3)


def test_poses_equal_jax(rvecs):
    rng = np.random.default_rng(1)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    p = np.concatenate([rvecs, t], axis=1)
    R_ref, t_ref = jlie.params_to_pose_batch(jnp.asarray(p))
    R, tt = tlie.params_to_pose(T(p))
    close(R, R_ref, 2e-6)
    close(tlie.pose_to_params(R, tt)[16:], jlie.pose_to_params_batch(
        R_ref, t_ref)[16:], 5e-6)
    Rc, tcmp = tlie.compose(R[1:], tt[1:], R[:-1], tt[:-1])
    Rc_ref, tc_ref = jlie.compose_batch(R_ref[1:], t_ref[1:], R_ref[:-1],
                                        t_ref[:-1])
    close(Rc, Rc_ref, 2e-6)
    close(tcmp, tc_ref, 2e-6)
    Rr, tr = tlie.relative(R[:-1], tt[:-1], R[1:], tt[1:])
    Rr_ref, tr_ref = jax.vmap(jlie.relative)(R_ref[:-1], t_ref[:-1],
                                             R_ref[1:], t_ref[1:])
    close(Rr, Rr_ref, 2e-6)
    close(tr, tr_ref, 5e-6)
    Ri, ti = tlie.invert(R, tt)
    Ri_ref, ti_ref = jax.vmap(jlie.invert)(R_ref, t_ref)
    close(Ri, Ri_ref, 2e-6)
    close(ti, ti_ref, 2e-6)
    close(tlie.camera_center(R, tt), jlie.camera_center_batch(R_ref, t_ref),
          2e-6)
    alpha = rng.random((64, 1)).astype(np.float32)
    close(tlie.slerp_rvec(T(rvecs), T(alpha)),
          jlie.slerp_rvec(jnp.asarray(rvecs), jnp.asarray(alpha)), 0.0)


def test_so3_log_jacobian_finite_at_identity():
    """The PGO Jacobians differentiate through so3_log at convergence
    (theta -> 0): finite and equal to JAX's jacfwd."""
    for R in (np.eye(3, dtype=np.float32),
              np.asarray(jlie.so3_exp(jnp.asarray([1e-6, -2e-6, 5e-7],
                                                  jnp.float32)))):
        J = torch.func.jacfwd(tlie.so3_log)(T(R))
        J_ref = jax.jacfwd(jlie.so3_log)(jnp.asarray(R))
        assert torch.isfinite(J).all()
        close(J, J_ref, 1e-6)


def test_camera_with_distortion_equal_jax():
    """The reference's iPhone intrinsics and nonzero distortion
    (CameraConfig defaults): undistortion's fixed-point loop, its inverse,
    projection and the 1e9 behind-camera error."""
    cam = tc.CameraConfig()
    assert any(cam.dist_coeffs)
    K = np.asarray(cam.K, np.float32)
    dist = np.asarray(cam.dist_coeffs, np.float32)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 2 * cam.cx, 300),
                   rng.uniform(0, 2 * cam.cy, 300)], -1).astype(np.float32)
    und_ref = jcam.undistort_points_batch(jnp.asarray(K), jnp.asarray(dist),
                                          jnp.asarray(uv))
    und = tcam.undistort_points(T(K), T(dist), T(uv))
    close(und, und_ref, 2e-3)     # pixels of a 1920-wide frame: 1e-6 rel
    close(tcam.distort_points(T(K), T(dist), und),
          jcam.distort_points_batch(jnp.asarray(K), jnp.asarray(dist),
                                    und_ref), 2e-3)
    assert np.abs(und.numpy() - uv).max() > 1.0     # distortion is real
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.asarray([0.3, -0.1, 0.5], np.float32)
    X = rng.normal(size=(300, 3)).astype(np.float32) * 2
    X[:, 2] += 4.0
    X[:20, 2] = -3.0                                # behind the camera
    close(tcam.project(T(K), T(R), T(t), T(X)),
          jcam.project_batch(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
                             jnp.asarray(X)), 1e-6, 5e-5)
    err = tcam.reproj_error(T(K), T(R), T(t), T(X), T(uv))
    close(err, jcam.reproj_error_batch(jnp.asarray(K), jnp.asarray(R),
                                       jnp.asarray(t), jnp.asarray(X),
                                       jnp.asarray(uv)), 1e-6, 5e-5)
    assert (err.numpy()[:20] == 1e9).all()


# ---------------------------------------------------------------------------
# triangulation, outliers
# ---------------------------------------------------------------------------

def _two_view_scene(rng, n=200):
    """Points seen by two posed cameras with every gate's failure mixed in:
    behind the cameras, too deep, too little parallax (at a 3-degree gate),
    pixel noise."""
    K = np.asarray([[300, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01],
                                             jnp.float32)))
    t2 = np.asarray([-1.0, 0.05, 0.02], np.float32)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 12, n)], -1)
    X[:15, 2] = -4.0                        # behind
    X[15:30, 2] = 80.0                      # beyond max depth x baseline
    X[30:45, 2] = rng.uniform(25, 45, 15)   # little parallax (< 3 deg)
    X = X.astype(np.float32)

    def view(R, t):
        Xc = X @ R.T + t
        return (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)

    x1, x2 = view(R1, t1), view(R2, t2)
    x2[45:60] += rng.normal(size=(15, 2)).astype(np.float32) * 0.05  # reproj
    uv1 = (x1 * K[[0, 1], [0, 1]] + K[:2, 2]).astype(np.float32)
    uv2 = (x2 * K[[0, 1], [0, 1]] + K[:2, 2]).astype(np.float32)
    mask = rng.random(n) > 0.05
    return K, (R1, t1, R2, t2), (x1, x2, uv1, uv2), mask


def test_triangulate_gated_equal_jax():
    K, poses, pts, mask = _two_view_scene(np.random.default_rng(3))
    ref = jtri.triangulate_gated(jnp.asarray(K), *map(jnp.asarray, poses),
                                 *map(jnp.asarray, pts), jnp.asarray(mask),
                                 jc.TriangulationConfig(min_parallax_deg=3.0))
    got = ttri.triangulate_gated(T(K), *map(T, poses), *map(T, pts), T(mask),
                                 tc.TriangulationConfig(min_parallax_deg=3.0))
    for name in ("accept", "n_input", "n_behind", "n_depth", "n_parallax",
                 "n_reproj"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert min(int(got.n_behind), int(got.n_depth), int(got.n_parallax),
               int(got.n_reproj)) > 0 and int(got.accept.sum()) > 50
    acc = got.accept.numpy()
    close(got.X[acc], np.asarray(ref.X)[acc], 1e-5, 1e-4)
    close(got.depths1[acc], np.asarray(ref.depths1)[acc], 1e-5, 1e-4)


def test_pair_batched_ransac_equals_per_pair():
    """The loop search verifies a chunk of candidate pairs in one pass (a
    leading pair axis through sampling, the solver and the cheirality
    vote): each pair's result equals its own single-pair run on the same
    noise."""
    scenes = [_two_view_scene(np.random.default_rng(s), n=120)
              for s in (20, 21, 22)]
    x1 = torch.stack([T(sc[2][0]) for sc in scenes])
    x2 = torch.stack([T(sc[2][1]) for sc in scenes])
    mask = torch.stack([T(sc[3]) for sc in scenes])
    mask[2, 40:] = False                   # pairs differ in match count
    cfg = tc.RansacConfig(num_hypotheses=64)
    g = torch.Generator().manual_seed(3)
    noise = transac.gumbel_noise(g, 64, 120, (3,))
    idx = transac.sample_minimal_sets(noise, mask, cfg.min_points)
    batched = transac.essential_from_samples(x1, x2, mask, idx, 300.0, cfg)
    for c in range(3):
        assert torch.equal(transac.sample_minimal_sets(noise[c], mask[c],
                                                       cfg.min_points),
                           idx[c])
        one = transac.essential_from_samples(x1[c], x2[c], mask[c], idx[c],
                                             300.0, cfg)
        for name in ("inliers", "num_inliers", "pose_inliers",
                     "num_pose_inliers", "ok"):
            assert torch.equal(getattr(batched, name)[c],
                               getattr(one, name)), name
        for name in ("E", "R", "t"):
            close(getattr(batched, name)[c], getattr(one, name), 1e-6)
    assert bool(batched.ok.all()) and int(batched.num_inliers.min()) > 20
    res = transac.estimate_essential_ransac(x1, x2, mask,
                                            torch.Generator().manual_seed(3),
                                            300.0, cfg)
    assert res.R.shape == (3, 3, 3) and res.inliers.shape == (3, 120)


def _ba_scene(rng, ncam=6, npts=120):
    """Cameras on an arc looking at a point cloud; noisy poses, points and
    pixels; invalid observations and an invalid point."""
    K = np.asarray([[400, 0, 200], [0, 400, 150], [0, 0, 1]], np.float32)
    params = np.zeros((ncam, 6), np.float32)
    params[:, 1] = np.linspace(-0.3, 0.3, ncam)
    params[:, 3] = np.linspace(-1.5, 1.5, ncam)
    X = np.stack([rng.uniform(-2, 2, npts), rng.uniform(-1.5, 1.5, npts),
                  rng.uniform(5, 9, npts)], -1).astype(np.float32)
    cams, pids = np.meshgrid(np.arange(ncam), np.arange(npts), indexing="ij")
    cams, pids = cams.ravel().astype(np.int32), pids.ravel().astype(np.int32)
    Rs, ts = jlie.params_to_pose_batch(jnp.asarray(params))
    uv = np.asarray(jax.vmap(lambda R, t, x: jcam.project(
        jnp.asarray(K), R, t, x)[:2])(Rs[cams], ts[cams], X[pids]))
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    valid = rng.random(cams.shape[0]) > 0.1
    noisy = params + rng.normal(size=params.shape).astype(np.float32) * 0.01
    noisy[0] = params[0]
    Xn = (X + rng.normal(size=X.shape) * 0.05).astype(np.float32)
    point_valid = np.ones(npts, bool)
    point_valid[7] = False
    return K, noisy, Xn, (cams, pids, uv, valid), point_valid


def test_remove_outliers_equal_jax():
    rng = np.random.default_rng(4)
    K, params, X, obs, pv = _ba_scene(rng)
    X[:5, 2] = -6.0                         # behind every camera
    X[5:7] += 0.8                           # large reprojection error
    X[10:12] *= 30.0                        # far from the cameras
    cam_valid = np.arange(params.shape[0]) < 5
    ref = jout.remove_outliers(jnp.asarray(K), jnp.asarray(params),
                               jnp.asarray(cam_valid), jnp.asarray(X),
                               jnp.asarray(pv),
                               jba.Observations(*map(jnp.asarray, obs)))
    got = tout.remove_outliers(T(K), T(params), T(cam_valid), T(X), T(pv),
                               tba.Observations(*map(T, obs)))
    for name in ("point_valid", "obs_valid", "n_points_before", "n_outliers",
                 "n_behind", "n_reproj", "n_far"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert min(int(got.n_behind), int(got.n_reproj), int(got.n_far)) > 0
    close(got.distance_threshold, ref.distance_threshold, 0.0, 1e-6)


# ---------------------------------------------------------------------------
# PGO, BA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pose_chain():
    """A 12-pose trajectory with drift and its loop measurement."""
    rng = np.random.default_rng(5)
    n = 12
    truth = np.zeros((n, 6), np.float32)
    truth[:, 1] = np.linspace(0, 1.2, n)
    truth[:, 3] = np.sin(np.linspace(0, 2, n))
    truth[:, 5] = np.linspace(0, 1, n)
    drift = np.cumsum(rng.normal(size=(n, 6)) * 0.01, axis=0)
    drift[0] = 0
    est = (truth + drift).astype(np.float32)
    Rt, tt = jlie.params_to_pose_batch(jnp.asarray(truth))
    R_loop, t_loop = jlie.relative(Rt[2], tt[2], Rt[n - 1], tt[n - 1])
    return est, np.asarray(R_loop), np.asarray(t_loop)


@pytest.mark.parametrize("dense", [True, False])
def test_optimize_pose_graph_equal_jax(pose_chain, dense):
    """Dense Cholesky and, with the threshold lowered, the PCG solver."""
    est, R_loop, t_loop = pose_chain
    jcfg = jc.PgoConfig(dense_solver_max_poses=1500 if dense else 4,
                        max_iterations=8)
    tcfg = tc.PgoConfig(dense_solver_max_poses=1500 if dense else 4,
                        max_iterations=8)
    gj = jpgo.build_trajectory_graph(jnp.asarray(est), jnp.asarray(2),
                                     jnp.asarray(11), jnp.asarray(R_loop),
                                     jnp.asarray(t_loop), 10.0)
    gt = tpgo.build_trajectory_graph(T(est), 2, 11, T(R_loop), T(t_loop),
                                     10.0)
    close(tpgo.residuals(T(est), gt), jpgo.residuals(jnp.asarray(est), gj),
          2e-6)
    opt_ref, costs_ref = jpgo.optimize_pose_graph(jnp.asarray(est), gj, jcfg)
    opt, costs = tpgo.optimize_pose_graph(T(est), gt, tcfg)
    assert float(costs[-1]) < 0.1 * float(costs[0])
    close(costs, costs_ref, 1e-6, 1e-4)
    close(opt, opt_ref, 1e-4)


def test_simple_pose_correction_equal_jax(pose_chain):
    est, R_loop, _ = pose_chain
    ref = jpgo.simple_pose_correction(jnp.asarray(est), jnp.asarray(2),
                                      jnp.asarray(11), jnp.asarray(R_loop))
    close(tpgo.simple_pose_correction(T(est), 2, 11, T(R_loop)), ref, 5e-6)


@pytest.fixture(scope="module")
def ba_scene():
    return _ba_scene(np.random.default_rng(6))


def test_refine_cameras_and_points_equal_jax(ba_scene):
    K, params, X, obs, pv = ba_scene
    jobs = jba.Observations(*map(jnp.asarray, obs))
    tobs = tba.Observations(*map(T, obs))
    fixed = np.arange(params.shape[0]) == 0
    cams_ref = jba.refine_cameras(jnp.asarray(K), jnp.asarray(params),
                                  jnp.asarray(X), jobs, jnp.asarray(fixed))
    cams = tba.refine_cameras(T(K), T(params), T(X), tobs, T(fixed))
    close(cams, cams_ref, 1e-4)
    assert np.array_equal(cams.numpy()[0], params[0])
    pts_ref = jba.refine_points(jnp.asarray(K), jnp.asarray(params),
                                jnp.asarray(X), jobs, jnp.asarray(pv))
    pts = tba.refine_points(T(K), T(params), T(X), tobs, T(pv))
    close(pts, pts_ref, 1e-3)
    assert np.array_equal(pts.numpy()[7], X[7])     # an invalid point stays


def test_alternating_ba_equal_jax(ba_scene):
    K, params, X, obs, pv = ba_scene
    ref = jba.alternating_ba(jnp.asarray(K), jnp.asarray(params),
                             jnp.asarray(X),
                             jba.Observations(*map(jnp.asarray, obs)),
                             jnp.asarray(pv), jc.BaConfig(),
                             outer_iterations=3)
    got = tba.alternating_ba(T(K), T(params), T(X),
                             tba.Observations(*map(T, obs)), T(pv),
                             tc.BaConfig(), outer_iterations=3)
    close(got[0], ref[0], 1e-4)
    close(got[1], ref[1], 1e-3)
    close(got[2], ref[2], 0.0, 1e-4)
    e0 = float(tba.mean_reprojection_error(T(K), T(params), T(X),
                                           tba.Observations(*map(T, obs))))
    assert float(got[2][-1]) < 0.5 * e0


# ---------------------------------------------------------------------------
# the pipeline: JAX runs with every minimal-set draw recorded by its key
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jcfg():
    """test_sfm.py's sfm_cfg."""
    cam = jc.CameraConfig(fx=0.8 * 192, fy=0.8 * 192, cx=96.0, cy=72.0,
                          k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return dataclasses.replace(
        jc.PipelineConfig(), camera=cam,
        orb=jc.OrbConfig(num_features=300, num_levels=2),
        keyframe=jc.KeyframeConfig(min_median_displacement=2.0,
                                   max_median_displacement=150.0,
                                   min_tracked_features=40,
                                   min_inlier_ratio=0.3, min_inliers=25),
        loop_verify=jc.LoopVerifyConfig(min_matches=40, min_inliers=30,
                                        min_inlier_ratio=0.5,
                                        min_pose_inliers=15),
        ransac=jc.RansacConfig(num_hypotheses=128))


@pytest.fixture(scope="module")
def tcfg(jcfg):
    return tc.PipelineConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def frames():
    return orbit_sequence(num_frames=24, h=144, w=192, num_points=250,
                          seed=5)


def _key(k) -> tuple:
    return tuple(int(a) for a in np.asarray(k).ravel())


@pytest.fixture(scope="module")
def jax_run(jcfg, frames, tmp_path_factory):
    """The JAX package's ``SfMPipeline.run`` (host loop, fused backend):
    (result, log text, {key: minimal sets drawn with it}, the keyframe
    step of frame STEP_FRAME as numpy: input state, inputs, key, output)."""
    return _jax_pipeline_run(jcfg, frames, tmp_path_factory.mktemp("jax"),
                             max_keyframes=32, max_points=8192,
                             max_obs=32768)


def _jax_pipeline_run(jcfg, frames, data_dir, **caps):
    """``SfMPipeline.run`` of the JAX package with every minimal-set draw
    recorded by its key; see :func:`jax_run`."""
    draws, step = {}, {}
    sample, sfm_step = jransac._sample_minimal_sets, jsfm._sfm_step

    def recording_sample(key, mask, num_h, size, quality=None):
        idx = sample(key, mask, num_h, size, quality)
        jax.debug.callback(
            lambda k, v: draws.setdefault(_key(k), np.asarray(v)), key, idx)
        return idx

    def recording_step(state, und, norm, valid, desc, frame_idx, key, K,
                       cfg):
        out = sfm_step(state, und, norm, valid, desc, frame_idx, key, K, cfg)
        if int(frame_idx) == STEP_FRAME:
            step.update(jax.device_get(dict(
                state=state, inputs=(und, norm, valid, desc), key=key,
                out=out)))
        return out

    jransac._sample_minimal_sets = recording_sample
    jsfm._sfm_step = recording_step
    jax.clear_caches()
    try:
        stream = io.StringIO()
        pipe = jsfm.SfMPipeline(jcfg, log=JLogger(stream=stream), **caps)
        res = pipe.run(frames, data_dir=str(data_dir))
    finally:
        jransac._sample_minimal_sets = sample
        jsfm._sfm_step = sfm_step
        jax.clear_caches()
    return res, stream.getvalue(), draws, step


class JaxDraws:
    """The port's draw seam (``sfm._minimal_sets``) fed with the JAX
    package's minimal sets: the keyframe step of frame f takes the draw of
    key ``split(PRNGKey(42), B - 1)[f - 1]``, loop candidate i that of
    ``split(PRNGKey(7), C)[i]`` (C the padded candidate count, read from
    the ``_verify_loop_scores`` call)."""

    def __init__(self, draws: dict, num_frames: int):
        self.draws = draws
        self.kf_keys = jax.random.split(jax.random.PRNGKey(42),
                                        num_frames - 1)
        self.step = 0
        self.loop_keys = None
        self.candidate = 0

    def install(self, monkeypatch):
        verify = tsfm._verify_loop_scores

        def verify_with_keys(desc, kp_valid, kp_norm, cand_q, *args,
                             **kwargs):
            self.loop_keys = jax.random.split(jax.random.PRNGKey(7),
                                              cand_q.shape[0])
            self.candidate = 0
            return verify(desc, kp_valid, kp_norm, cand_q, *args, **kwargs)

        monkeypatch.setattr(tsfm, "_minimal_sets", self)
        monkeypatch.setattr(tsfm, "_verify_loop_scores", verify_with_keys)

    def __call__(self, generator, mask, quality, cfg):
        if mask.dim() == 1:                       # a keyframe step
            self.step += 1
            return T(self.draws[_key(self.kf_keys[self.step - 1])])
        c0, self.candidate = self.candidate, self.candidate + mask.shape[0]
        return T(np.stack([self.draws[_key(self.loop_keys[i])]
                           for i in range(c0, self.candidate)]))


VARIANTS = {"host": ({}, {}), "scan": ({"use_scan": True}, {}),
            "staged": ({}, {"checkpoint": True})}


@pytest.fixture(scope="module")
def port_runs(tcfg, frames, jax_run, tmp_path_factory):
    """``SfMPipeline.run`` of the port with the JAX draws: the host loop
    with the fused backend, ``use_scan``, and the staged backend (with its
    checkpoints). {variant: (result, log text, data dir)}."""
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for name, (init_kw, run_kw) in VARIANTS.items():
            JaxDraws(jax_run[2], len(frames)).install(mp)
            stream = io.StringIO()
            pipe = tsfm.SfMPipeline(tcfg, max_keyframes=32, max_points=8192,
                                    max_obs=32768, log=TLogger(stream=stream),
                                    device="cpu", **init_kw)
            data_dir = tmp_path_factory.mktemp(name)
            res = pipe.run(frames, data_dir=str(data_dir), **run_kw)
            runs[name] = (res, stream.getvalue(), data_dir)
    finally:
        mp.undo()
    return runs


def _loop(res) -> tuple:
    lp = res.loop
    return (lp.found, lp.curr_kf, lp.past_kf, lp.num_matches, lp.num_inliers,
            lp.num_pose_inliers)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_equals_jax(jax_run, port_runs, variant):
    """Keyframes, map counts, the loop pair and its match / inlier counts
    exact; the three reprojection errors within END_RTOL."""
    jres = jax_run[0]
    res = port_runs[variant][0]
    k = int(jres.state.kf_count)
    assert int(res.state.kf_count) == k > 12
    np.testing.assert_array_equal(res.state.kf_frame[:k].numpy(),
                                  np.asarray(jres.state.kf_frame)[:k])
    assert int(res.state.point_count) == int(jres.state.point_count) > 500
    assert int(res.state.obs_count) == int(jres.state.obs_count)
    assert _loop(res) == _loop(jres) and jres.loop.found
    np.testing.assert_array_equal(
        res.state.kp_to_point[:k].numpy(),
        np.asarray(jres.state.kp_to_point)[:k])
    errs = [res.reproj_before_ba, res.reproj_after_ba, res.reproj_final]
    ref = [jres.reproj_before_ba, jres.reproj_after_ba, jres.reproj_final]
    np.testing.assert_allclose(errs, ref, rtol=END_RTOL)
    assert res.reproj_final < res.reproj_before_ba


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def test_log_lines_equal_jax(jax_run, port_runs):
    """The host loop's log, line by line: the same words and integers, and
    the printed floats within END_RTOL (the OBJ's timestamped path
    aside)."""
    _assert_logs_equal(port_runs["host"][1], jax_run[1],
                       int(jax_run[0].state.kf_count), min_lines=60)


def _assert_logs_equal(got: str, ref: str, keyframes: int,
                       min_lines: int = 20) -> None:
    got, ref = got.splitlines(), ref.splitlines()
    assert len(got) == len(ref) > min_lines
    assert sum(line.startswith("Keyframe ") for line in got) == keyframes - 1

    def parts(line):
        line = re.sub(r"Saved OBJ: \S+", "Saved OBJ: <path>", line)
        return _NUM.split(line), _NUM.findall(line)

    for a, b in zip(got, ref):
        (text_a, nums_a), (text_b, nums_b) = parts(a), parts(b)
        assert text_a == text_b, (a, b)
        for x, y in zip(nums_a, nums_b):
            if any(c in x + y for c in ".e"):
                assert abs(float(x) - float(y)) <= END_RTOL * abs(
                    float(y)) + 1e-6, (a, b)
            else:
                assert x == y, (a, b)


def test_fused_backend_matches_staged(port_runs):
    """run()'s fused backend and the staged methods (checkpoint=True): the
    same map and errors; the staged run wrote both stage checkpoints."""
    fused, staged = port_runs["host"][0], port_runs["staged"][0]
    for name in ("kf_count", "point_count", "obs_count", "point_valid",
                 "obs_valid"):
        assert torch.equal(getattr(fused.state, name),
                           getattr(staged.state, name)), name
    close(staged.state.poses, fused.state.poses, 1e-6)
    np.testing.assert_allclose(
        [staged.reproj_before_ba, staged.reproj_after_ba,
         staged.reproj_final],
        [fused.reproj_before_ba, fused.reproj_after_ba, fused.reproj_final],
        rtol=1e-6)
    data_dir = port_runs["staged"][2]
    for stage in ("frontend", "pgo"):
        assert tckpt.stage_checkpoint_path(data_dir, stage).is_file()


def test_scan_matches_host_loop(port_runs):
    """The keyframe pass without per-frame readbacks: the same map, and
    StepInfo as stacked tensors."""
    host, scan = port_runs["host"][0], port_runs["scan"][0]
    for a, b in zip(host.state, scan.state):
        assert torch.equal(a, b)
    assert isinstance(scan.infos, tsfm.StepInfo)
    assert scan.infos.accepted.shape == (23,)
    assert [bool(i.accepted) for i in host.infos] == \
        scan.infos.accepted.tolist()


def test_checkpoint_resume(port_runs, tcfg, frames, jax_run):
    """A second staged run in the same directory resumes from the
    front-end checkpoint and reaches the same map."""
    mp = pytest.MonkeyPatch()
    try:
        draws = JaxDraws(jax_run[2], len(frames))
        draws.install(mp)
        lines = []
        res = tsfm.SfMPipeline(
            tcfg, max_keyframes=32, max_points=8192, max_obs=32768,
            log=lines.append, device="cpu").run(
                frames, data_dir=str(port_runs["staged"][2]),
                write_obj=False, checkpoint=True)
    finally:
        mp.undo()
    assert lines[0].startswith("Resuming map state from") and draws.step == 0
    ref = port_runs["staged"][0]
    assert _loop(res) == _loop(ref)
    for name in ("kf_count", "point_count", "obs_count", "point_valid"):
        assert torch.equal(getattr(res.state, name), getattr(ref.state, name))


# ---------------------------------------------------------------------------
# the SIFT detector: test_sfm_sift.py's fixture
# ---------------------------------------------------------------------------

SIFT_CAPS = dict(max_keyframes=16, max_points=4096, max_obs=16384)


@pytest.fixture(scope="module")
def sift_jcfg():
    """test_sfm_sift.py's configuration."""
    cam = jc.CameraConfig(fx=0.8 * 192, fy=0.8 * 192, cx=96.0, cy=72.0,
                          k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return dataclasses.replace(
        jc.PipelineConfig(), detector="sift", camera=cam,
        sift=jc.SiftConfig(num_features=400, num_octaves=2),
        match=jc.MatchConfig(ratio_threshold=0.85),
        keyframe=jc.KeyframeConfig(min_median_displacement=2.0,
                                   max_median_displacement=150.0,
                                   min_tracked_features=25,
                                   min_inlier_ratio=0.3, min_inliers=15),
        loop_verify=jc.LoopVerifyConfig(min_matches=25, min_inliers=15,
                                        min_inlier_ratio=0.4,
                                        min_pose_inliers=8),
        ransac=jc.RansacConfig(num_hypotheses=128))


@pytest.fixture(scope="module")
def sift_frames():
    return orbit_sequence(num_frames=24, h=144, w=192, num_points=250,
                          seed=11)


@pytest.fixture(scope="module")
def sift_jax_run(sift_jcfg, sift_frames, tmp_path_factory):
    """The JAX package's SIFT run (as :func:`jax_run`) and its front-end's
    outputs as the port's tensors."""
    front = jsfm.SfMPipeline(sift_jcfg, **SIFT_CAPS)._frontend(sift_frames)
    front = tuple(T(np.asarray(a)) for a in front)
    run = _jax_pipeline_run(sift_jcfg, sift_frames,
                            tmp_path_factory.mktemp("jax_sift"), **SIFT_CAPS)
    return run + (front,)


@pytest.fixture(scope="module")
def sift_port_run(sift_jcfg, sift_frames, sift_jax_run, tmp_path_factory):
    """The port's SIFT ``run()`` with the JAX front-end's outputs (through
    the ``_frontend`` seam) and the JAX draws: (result, log text)."""
    mp = pytest.MonkeyPatch()
    try:
        JaxDraws(sift_jax_run[2], len(sift_frames)).install(mp)
        stream = io.StringIO()
        pipe = tsfm.SfMPipeline(
            tc.PipelineConfig.from_json(sift_jcfg.to_json()),
            log=TLogger(stream=stream), device="cpu", **SIFT_CAPS)
        pipe._frontend = lambda frames: sift_jax_run[4]
        res = pipe.run(sift_frames,
                       data_dir=str(tmp_path_factory.mktemp("port_sift")))
    finally:
        mp.undo()
    return res, stream.getvalue()


def test_sift_run_equals_jax(sift_jax_run, sift_port_run):
    """SIFT with the JAX front-end's outputs and draws: the keyframes, map
    counts, track table and loop (pair and counts) exact, the reprojection
    errors within END_RTOL; the descriptor store is float32 [..., 128]."""
    jres, res = sift_jax_run[0], sift_port_run[0]
    k = int(jres.state.kf_count)
    assert int(res.state.kf_count) == k >= 4
    np.testing.assert_array_equal(res.state.kf_frame[:k].numpy(),
                                  np.asarray(jres.state.kf_frame)[:k])
    assert int(res.state.point_count) == int(jres.state.point_count) > 20
    assert int(res.state.obs_count) == int(jres.state.obs_count) > 40
    np.testing.assert_array_equal(res.state.kp_to_point[:k].numpy(),
                                  np.asarray(jres.state.kp_to_point)[:k])
    assert _loop(res) == _loop(jres)
    assert res.state.desc.dtype == torch.float32
    assert res.state.desc.shape[-1] == 128
    np.testing.assert_allclose(
        [res.reproj_before_ba, res.reproj_after_ba, res.reproj_final],
        [jres.reproj_before_ba, jres.reproj_after_ba, jres.reproj_final],
        rtol=END_RTOL)


def test_sift_log_lines_equal_jax(sift_jax_run, sift_port_run):
    """The SIFT run's log, line by line (as test_log_lines_equal_jax)."""
    _assert_logs_equal(sift_port_run[1], sift_jax_run[1],
                       int(sift_jax_run[0].state.kf_count))


def test_sift_own_frontend_builds_map(sift_jcfg, sift_frames):
    """The port's own SIFT front-end and draws (test_sfm_sift.py's
    assertions): at least 4 keyframes, more than 20 points and 40
    observations, a float32 [..., 128] descriptor store."""
    pipe = tsfm.SfMPipeline(tc.PipelineConfig.from_json(sift_jcfg.to_json()),
                            log=lambda *a: None, device="cpu", **SIFT_CAPS)
    state, infos = pipe.run_frontend_and_keyframes(sift_frames)
    assert int(state.kf_count) >= 4
    assert int(state.point_count) > 20 and int(state.obs_count) > 40
    assert state.desc.dtype == torch.float32 and state.desc.shape[-1] == 128
    assert len(infos) == len(sift_frames) - 1


def test_sift_checkpoints_load_across_packages(sift_jax_run, tmp_path):
    """A SIFT map state (float32 descriptors in the ``signed`` field) written
    by the JAX package loads into the port, and back."""
    jstate = jax.device_get(sift_jax_run[0].state)
    jpath = jckpt.save_map_state(tmp_path / "jax.npz", jstate)
    state = tckpt.load_map_state(jpath, "cpu")
    assert state.desc.dtype == torch.float32
    for a, b in zip(state, convert.map_state(jstate, "cpu")):
        assert torch.equal(a, b)
    back = jckpt.load_map_state(tckpt.save_map_state(tmp_path / "port.npz",
                                                     state))
    for name in jsfm.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jstate, name)))


# ---------------------------------------------------------------------------
# one keyframe step, the track table, checkpoints, OBJ
# ---------------------------------------------------------------------------

def _port_inputs(step):
    und, norm, valid, signed = step["inputs"]
    return T(und), T(norm), T(valid), tdesc.signed_to_packed(T(signed))


def _compare_states(got: tsfm.MapState, ref, pose_atol: float,
                    point_atol: float) -> None:
    """Map arrays, the trash slots excluded: integers and masks exact."""
    ref = convert.map_state(ref, "cpu")
    for name in ("kf_count", "kf_frame", "kp_valid", "desc", "kp_to_point",
                 "point_count", "obs_count"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("point_valid", "obs_cam", "obs_point", "obs_valid"):
        assert torch.equal(getattr(got, name)[:-1],
                           getattr(ref, name)[:-1]), name
    close(got.poses, ref.poses, pose_atol)
    close(got.kp_xy, ref.kp_xy, 0.0)
    close(got.points[:-1], ref.points[:-1], point_atol)
    close(got.obs_uv[:-1], ref.obs_uv[:-1], 0.0)


def test_sfm_step_equals_jax(jax_run, tcfg, monkeypatch):
    """The keyframe step of frame STEP_FRAME from the JAX package's input
    state (convert.map_state) with its minimal sets injected: the same
    gates, counters and map writes."""
    step = jax_run[3]
    idx = T(jax_run[2][_key(step["key"])])
    monkeypatch.setattr(tsfm, "_minimal_sets", lambda *a: idx)
    state = convert.map_state(step["state"], "cpu")
    K = torch.tensor(tcfg.camera.K, dtype=torch.float32)
    out, info = tsfm._sfm_step(state, *_port_inputs(step), STEP_FRAME, K,
                               tcfg, None)
    ref_state, ref_info = step["out"]
    for name in ref_info._fields:
        if name == "median_disp":
            close(info.median_disp, ref_info.median_disp, 1e-4)
        else:
            assert int(getattr(info, name)) == int(getattr(ref_info, name))
    assert bool(info.accepted) and int(info.n_merged) > 0
    _compare_states(out, ref_state, pose_atol=2e-5, point_atol=5e-3)


def test_track_table_duplicate_targets_last_writer_wins():
    """R9: rows that share a target in the last keyframe's track table
    write in row order and the last one wins, as the JAX package's scatter
    does on its CPU backend. Query rows 5 and 7 are not matches but carry
    target indices 0 and 6 (a non-match's nearest target; an invalid row's
    0): each writes back the old -1 over the new point id an earlier row
    gave that target."""
    K = np.asarray([[100, 0, 50], [0, 100, 50], [0, 0, 1]], np.float32)
    X = np.stack([np.linspace(-1.5, 1.3, 8), 0.3 * (np.arange(8) % 3) - 0.3,
                  5.0 + 0.2 * np.arange(8)], -1).astype(np.float32)
    t_new = np.asarray([-1.0, 0.0, 0.0], np.float32)
    x1 = X[:, :2] / X[:, 2:]
    x2 = (X + t_new)[:, :2] / X[:, 2:]
    uv1, uv2 = x1 * 100 + 50, x2 * 100 + 50
    jstate = jsfm.init_map_state(4, 8, 32, 64)
    track = np.full(8, -1, np.int32)
    track[1] = 3                                   # an existing point
    jstate = jstate._replace(
        kf_count=jnp.int32(1), kp_xy=jstate.kp_xy.at[0].set(uv1),
        kp_norm=jstate.kp_norm.at[0].set(x1),
        kp_valid=jstate.kp_valid.at[0].set(True),
        kp_to_point=jstate.kp_to_point.at[0].set(track),
        points=jstate.points.at[3].set(X[1]),
        point_valid=jstate.point_valid.at[3].set(True),
        point_count=jnp.int32(4))
    idx = np.asarray([0, 1, 2, 3, 4, 0, 6, 6], np.int32)
    mask = np.asarray([1, 1, 1, 1, 1, 0, 1, 0], bool)
    jm = jmatch.Matches(idx=jnp.asarray(idx), dist=jnp.zeros(8, jnp.int32),
                        mask=jnp.asarray(mask), count=jnp.int32(mask.sum()))
    jres = jransac.EssentialResult(
        E=jnp.zeros((3, 3)), R=jnp.eye(3), t=jnp.asarray(t_new),
        inliers=jnp.ones(8, bool), num_inliers=jnp.int32(8),
        pose_inliers=jnp.ones(8, bool), num_pose_inliers=jnp.int32(8),
        ok=jnp.asarray(True))
    jcfg = jc.PipelineConfig()
    signed = jnp.ones((8, 256), jnp.int8)
    extend = jax.jit(jsfm._extend_map, static_argnames=("cfg",))
    ref, _ = extend(jstate, jnp.asarray(uv2), jnp.asarray(x2),
                    jnp.ones(8, bool), signed, jnp.int32(9), jres, jm,
                    jnp.asarray(K), cfg=jcfg, accept=jnp.asarray(True))
    ref = jax.device_get(ref)

    state = convert.map_state(jax.device_get(jstate), "cpu")
    res = transac.EssentialResult(*(T(np.asarray(a)) for a in jres))
    m = tmatch.Matches(*(T(np.asarray(a)) for a in jm))
    out, _ = tsfm._extend_map(state, T(uv2), T(x2), torch.ones(8, dtype=bool),
                              tdesc.signed_to_packed(T(np.asarray(signed))),
                              9, res, m, T(K), tc.PipelineConfig(),
                              torch.tensor(True))
    expect = np.asarray([-1, 3, 5, 6, 7, -1, -1, -1])
    np.testing.assert_array_equal(np.asarray(ref.kp_to_point)[0], expect)
    np.testing.assert_array_equal(out.kp_to_point[0].numpy(), expect)
    # rows 0 and 6 did create points 4 and 8; the new keyframe keeps them
    np.testing.assert_array_equal(out.kp_to_point[1].numpy(),
                                  [4, 3, 5, 6, 7, -1, 8, -1])
    _compare_states(out, ref, pose_atol=1e-6, point_atol=1e-4)


def test_checkpoints_load_across_packages(jax_run, tmp_path):
    """A checkpoint the JAX package writes loads into the port (descriptors
    packed from the signed field), and one the port writes loads into the
    JAX package."""
    jstate = jax_run[3]["out"][0]
    jpath = jckpt.save_map_state(tmp_path / "jax.npz", jstate)
    state = tckpt.load_map_state(jpath, "cpu")
    ref = convert.map_state(jstate, "cpu")
    for a, b in zip(state, ref):
        assert torch.equal(a, b)
    back = jckpt.load_map_state(tckpt.save_map_state(tmp_path / "port.npz",
                                                     state))
    for name in jsfm.MapState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jstate, name)))


def test_write_obj_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pv = rng.random(50) > 0.2
    Rs = np.array(jlie.so3_exp_batch(jnp.asarray(
        rng.normal(size=(6, 3)).astype(np.float32) * 0.3)))
    Rs[4] = 0.0                                  # an empty pose, skipped
    ts = rng.normal(size=(6, 3)).astype(np.float32)
    logs = {}
    for name, mod in (("jax", jio), ("port", tio)):
        lines = []
        mod.write_obj(tmp_path / f"{name}.obj", pts, Rs, ts, point_valid=pv,
                      log=lines.append)
        logs[name] = [line.split(": ", 1)[-1].split(" ", 1)[-1]
                      for line in lines]
    assert (tmp_path / "jax.obj").read_text() == \
        (tmp_path / "port.obj").read_text()
    assert logs["jax"] == logs["port"]
    path = tio.reconstruction_obj_path(str(tmp_path))
    ref = jio.reconstruction_obj_path(str(tmp_path))
    assert path.parent == ref.parent and re.fullmatch(
        r"reconstructionBundle_\d+\.obj", path.name)
