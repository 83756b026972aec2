"""The port's two-view geometry against the JAX package on the CPU: every
function of ``ops/epipolar.py`` and the RANSAC of ``ops/ransac.py`` on a
synthetic two-view scene (60 points, 0.5 px noise, 30% outliers).

Tolerances, and why: float32 throughout, and the sums run in another order
than XLA's, so values agree to a few float32 ulps scaled by the problem's
conditioning — 1e-5 relative (largest difference over largest magnitude)
for the well-conditioned quantities, 1e-4 where an SVD or a homogeneous
division sits in between. E is compared up to sign (the SVD's sign
convention differs between LAPACK builds and cuSOLVER); R and t, not
candidate indices, are compared after the cheirality vote. Integer outputs
(votes, masks, counts) are equal.

RANSAC's random numbers do not carry across frameworks, so the exact layer
feeds the JAX package's sampled minimal sets into the port's solver; the
port's own generator is checked against the scene's ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures.synthetic import two_view_scene
from slam_loop_closing_tpu import config as jconfig
from slam_loop_closing_tpu.ops import epipolar as jepi
from slam_loop_closing_tpu.ops import ransac as jransac
from slam_loop_closing_tpu_torch import config as tconfig
from slam_loop_closing_tpu_torch.ops import epipolar as tepi
from slam_loop_closing_tpu_torch.ops import ransac as transac

torch.set_num_threads(1)

N_POINTS = 60


def normalized(scene):
    K = scene["K"]
    c, f = K[:2, 2], np.array([K[0, 0], K[1, 1]])
    return (((scene["uv1"] - c) / f).astype(np.float32),
            ((scene["uv2"] - c) / f).astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    """60 points, 0.5 px noise, 30% outliers, normalized coordinates."""
    sc = two_view_scene(np.random.default_rng(0), n_points=N_POINTS,
                        noise_px=0.5, n_outliers=18)
    x1, x2 = normalized(sc)
    return dict(sc, x1=x1, x2=x2)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def err_up_to_sign(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(min(np.abs(got - ref).max(), np.abs(got + ref).max()))


def both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.tensor(np.asarray(a))) for a in arrays]


def rotation_error(R, R_ref) -> float:
    c = (np.trace(np.asarray(R, np.float64).T @ R_ref) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def test_design_and_nullspace_of_minimal_samples(scene):
    """The nullspace of a float32 8x9 system is defined to about its
    condition number times the unit roundoff: within 1e-5 relative, or
    6e-8 x the condition number where that is larger (the scene's minimal
    samples reach ~1500; measured at most 2.2e-8 x condition)."""
    rng = np.random.default_rng(1)
    idx = np.stack([rng.permutation(N_POINTS)[:8] for _ in range(64)])
    (j1, t1), (j2, t2) = both(scene["x1"][idx], scene["x2"][idx])
    A_ref = jepi.epipolar_design(j1, j2)
    A = tepi.epipolar_design(t1, t2)
    np.testing.assert_array_equal(A.numpy(), np.asarray(A_ref))
    got = tepi.nullspace_8x9(A).numpy()
    ref = np.asarray(jepi.nullspace_8x9(A_ref))
    err = np.abs(got - ref).max(1) / np.abs(ref).max(1)
    s = np.linalg.svd(np.asarray(A_ref, np.float64), compute_uv=False)
    cond = s[:, 0] / s[:, -1]
    assert np.all(err <= np.maximum(1e-5, 6e-8 * cond))


def test_eight_point_projection_and_sampson(scene):
    (j1, t1), (j2, t2), (jw, tw) = both(
        scene["x1"], scene["x2"], scene["inliers"].astype(np.float32))
    E_ref = jepi.essential_eight_point(j1, j2, jw)
    assert err_up_to_sign(tepi.essential_eight_point(t1, t2, tw),
                          E_ref) < 1e-4
    # the normal-equation solve squares the condition number (float32)
    assert err_up_to_sign(tepi.essential_eight_point_fast(t1, t2, tw),
                          jepi.essential_eight_point_fast(j1, j2, jw)) < 5e-3
    E = np.asarray(E_ref)
    assert rel_err(tepi.project_to_essential(torch.from_numpy(1.3 * E)),
                   jepi.project_to_essential(jnp.asarray(1.3 * E))) < 1e-5
    F = np.stack([E, E.T, 2.0 * E])                  # a batch of models
    got = tepi.sampson_error(torch.from_numpy(F), t1, t2)
    ref = jax.vmap(jepi.sampson_error, in_axes=(0, None, None))(
        jnp.asarray(F), j1, j2)
    assert got.shape == (3, N_POINTS)
    assert rel_err(got, ref) < 1e-5


def test_decompose_and_recover_pose(scene):
    """The four candidates as a set (the SVD may list them in another
    order), then recover_pose's R and t, pose mask and count on JAX's E."""
    (j1, t1), (j2, t2), (jm, tm) = both(scene["x1"], scene["x2"],
                                        scene["inliers"])
    E = np.asarray(jepi.essential_eight_point(
        j1, j2, jnp.asarray(scene["inliers"], jnp.float32)))
    Rs_ref, ts_ref = map(np.asarray, jepi.decompose_essential(jnp.asarray(E)))
    Rs, ts = (a.numpy() for a in tepi.decompose_essential(
        torch.from_numpy(E.copy())))
    for R, t in zip(Rs_ref, ts_ref):
        assert min(max(np.abs(R - R2).max(), np.abs(t - t2).max())
                   for R2, t2 in zip(Rs, ts)) < 1e-4
    np.testing.assert_array_equal(
        tepi.cheirality_counts(torch.tensor(Rs_ref), torch.tensor(ts_ref),
                               t1, t2, tm).numpy(),
        np.asarray(jepi.cheirality_counts(jnp.asarray(Rs_ref),
                                          jnp.asarray(ts_ref), j1, j2, jm)))
    R_ref, t_ref, pm_ref, n_ref = jepi.recover_pose(jnp.asarray(E), j1, j2, jm)
    R, t, pm, n = tepi.recover_pose(torch.from_numpy(E.copy()), t1, t2, tm)
    assert np.abs(R.numpy() - np.asarray(R_ref)).max() < 1e-4
    assert np.abs(t.numpy() - np.asarray(t_ref)).max() < 1e-4
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_ref))
    assert int(n) == int(n_ref) > 30


def test_triangulation_and_depths(scene):
    """On the points that pass the depth gates: triangulate_dlt and
    triangulate_linear within 1e-4 relative (the linear form solves normal
    equations, which square the DLT system's condition number at this
    1-unit baseline, and XLA's CPU build contracts the adjugate's products
    into FMAs: 1.5e-5 measured); depths of the same points within 1e-6;
    the 3x3 solve within 1e-5 relative."""
    R = scene["R"].astype(np.float32)
    t = (scene["t"] / np.linalg.norm(scene["t"])).astype(np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    (jx1, tx1), (jx2, tx2), (jR, tR), (jt, tt), (je, te), (jz, tz) = both(
        scene["x1"], scene["x2"], R, t, eye, zero)
    X_ref = np.asarray(jepi.triangulate_dlt(je, jz, jR, jt, jx1, jx2))
    X = tepi.triangulate_dlt(te, tz, tR, tt, tx1, tx2).numpy()
    gate = (scene["inliers"] & (X_ref[:, 2] > 0)
            & (np.linalg.norm(X_ref, axis=1) < 100.0))
    assert gate.sum() > 30
    assert rel_err(X[gate], X_ref[gate]) < 1e-4
    XL_ref = jepi.triangulate_linear(je, jz, jR, jt, jx1, jx2)
    XL = tepi.triangulate_linear(te, tz, tR, tt, tx1, tx2)
    assert rel_err(XL[gate], np.asarray(XL_ref)[gate]) < 1e-4
    assert rel_err(tepi.depths(tR, tt, torch.tensor(X_ref)),
                   jepi.depths(jR, jt, jnp.asarray(X_ref))) < 1e-6
    H = np.random.default_rng(2).normal(size=(7, 3, 3)).astype(np.float32)
    g = np.random.default_rng(3).normal(size=(7, 3)).astype(np.float32)
    assert rel_err(tepi._solve3x3(torch.from_numpy(H), torch.from_numpy(g)),
                   jepi._solve3x3(jnp.asarray(H), jnp.asarray(g))) < 1e-5


def test_gating_metrics(scene):
    rng = np.random.default_rng(4)
    p1 = rng.normal(size=(41, 2)).astype(np.float32) * 50
    p2 = p1 + rng.normal(size=(41, 2)).astype(np.float32) * 20
    for mask in (rng.random(41) > 0.3, np.zeros(41, bool)):
        (j1, t1), (j2, t2), (jm, tm) = both(p1, p2, mask)
        assert rel_err(tepi.median_displacement(t1, t2, tm),
                       jepi.median_displacement(j1, j2, jm)) < 1e-6
    X = rng.normal(size=(30, 3)).astype(np.float32) * 5
    X[0] = 0.0                                 # a ray of length 0
    C1 = np.zeros(3, np.float32)
    C2 = np.array([1.0, 0.2, -0.1], np.float32)
    (jX, tX), (jc1, tc1), (jc2, tc2) = both(X, C1, C2)
    assert rel_err(tepi.parallax_angle_deg(tc1, tc2, tX),
                   jepi.parallax_angle_deg(jc1, jc2, jX)) < 1e-5


def test_hypothesis_budget_equals_jax():
    for conf, w in [(0.999, 0.5), (0.999, 0.585), (0.99, 0.7)]:
        assert transac.hypotheses_for(conf, w, 8) == \
            jransac.hypotheses_for(conf, w, 8)
    for h in (0, 64):
        assert transac.resolved_hypotheses(
            tconfig.RansacConfig(num_hypotheses=h)) == \
            jransac.resolved_hypotheses(jconfig.RansacConfig(num_hypotheses=h))


@pytest.mark.parametrize("seed,prosac", [(0, False), (1, True), (2, True)])
def test_ransac_with_jax_samples(scene, seed, prosac):
    """The exact layer: the JAX package's minimal sets (its Gumbel noise
    and top-k, with and without a PROSAC quality) through the port's
    solver give JAX's inlier mask, pose mask and ok, and R and t within
    1e-4."""
    n = N_POINTS
    (j1, t1), (j2, t2) = both(scene["x1"], scene["x2"])
    mask = np.ones(n, bool)
    mask[-3:] = False
    quality = (jnp.asarray(np.random.default_rng(seed).random(n), jnp.float32)
               if prosac else None)
    cfg = jconfig.RansacConfig(num_hypotheses=512)
    key = jax.random.PRNGKey(seed)
    idx = jransac._sample_minimal_sets(key, jnp.asarray(mask), 512, 8, quality)
    ref = jransac.estimate_essential_ransac(j1, j2, jnp.asarray(mask), key,
                                            800.0, cfg, quality=quality)
    got = transac.essential_from_samples(
        t1, t2, torch.from_numpy(mask), torch.tensor(np.asarray(idx)),
        800.0, tconfig.RansacConfig(num_hypotheses=512))
    assert bool(got.ok) == bool(ref.ok)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(got.pose_inliers.numpy(),
                                  np.asarray(ref.pose_inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() < 1e-4
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() < 1e-4
    assert err_up_to_sign(got.E, ref.E) < 1e-4


def test_ransac_own_generator_finds_ground_truth():
    """The port's own sampling (Gumbel noise from a torch.Generator, exact
    top-k, PROSAC pool) on noise-free inliers with 30% outliers: every
    outlier rejected, rotation within 1e-3 rad of the truth. (At 0.5 px
    noise the rotation error is set by the noise: the JAX package's RANSAC
    lands 4e-3 rad off on the scene above.)"""
    sc = two_view_scene(np.random.default_rng(5), n_points=N_POINTS,
                        noise_px=0.0, n_outliers=18)
    x1, x2 = map(torch.from_numpy, normalized(sc))
    gen = torch.Generator().manual_seed(0)
    mask = torch.ones(N_POINTS, dtype=torch.bool)
    quality = torch.from_numpy(sc["inliers"].astype(np.float32))
    for q in (None, quality):
        res = transac.estimate_essential_ransac(
            x1, x2, mask, gen, 800.0, tconfig.RansacConfig(num_hypotheses=512),
            quality=q)
        assert bool(res.ok)
        np.testing.assert_array_equal(res.inliers.numpy(), sc["inliers"])
        assert rotation_error(res.R.numpy(), sc["R"]) < 1e-3


def test_prosac_sampling_draws_from_the_ranked_pool():
    """Distinct valid indices per hypothesis; the first hypothesis draws
    from the top 4 x 8 ranks, the last from every valid row; the ranks of
    equal qualities follow index order (a stable sort)."""
    n, h = 200, 64
    gen = torch.Generator().manual_seed(3)
    mask = torch.ones(n, dtype=torch.bool)
    mask[150:] = False
    quality = torch.zeros(n)
    quality[100:140] = 1.0                     # 40 tied top ranks
    idx = transac.sample_minimal_sets(transac.gumbel_noise(gen, h, n), mask,
                                      8, quality)
    assert idx.shape == (h, 8)
    assert all(len(set(r)) == 8 for r in idx.tolist())
    assert bool(mask[idx].all())
    assert set(idx[0].tolist()) <= set(range(100, 132))


def test_ransac_rejects_fewer_than_eight_points(scene):
    x1, x2 = torch.from_numpy(scene["x1"]), torch.from_numpy(scene["x2"])
    mask = torch.arange(N_POINTS) < 5
    res = transac.estimate_essential_ransac(
        x1, x2, mask, torch.Generator().manual_seed(0), 800.0,
        tconfig.RansacConfig(num_hypotheses=64))
    assert not bool(res.ok)
    assert not res.inliers[5:].any()


def test_ransac_pairs_with_jax_samples(monkeypatch):
    """``estimate_essential_ransac_pairs`` over three pairs, the JAX
    package's minimal sets of each pair's key injected at the port's one
    draw, on noise-free inliers with 30% outliers: the JAX pairs result
    (masks equal, R and t within 1e-4) and the true inlier set. Shapes
    without a pair axis are refused."""
    n, p = N_POINTS, 3
    rng = np.random.default_rng(8)
    sc = two_view_scene(np.random.default_rng(5), n_points=n, noise_px=0.0,
                        n_outliers=18)
    x1, x2 = (np.stack([x] * p) for x in normalized(sc))
    mask = np.ones((p, n), bool)
    mask[1, :4] = False
    mask[2, -5:] = False
    quality = rng.random((p, n)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), p)
    cfg = jconfig.RansacConfig(num_hypotheses=256)
    ref = jransac.estimate_essential_ransac_pairs(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), keys, 800.0, cfg,
        jnp.asarray(quality))
    idx = np.stack([np.asarray(jransac._sample_minimal_sets(
        keys[i], jnp.asarray(mask[i]), 256, 8, jnp.asarray(quality[i])))
        for i in range(p)])
    monkeypatch.setattr(transac, "sample_minimal_sets",
                        lambda *a, **k: torch.from_numpy(idx))
    t = torch.from_numpy
    got = transac.estimate_essential_ransac_pairs(
        t(x1), t(x2), t(mask), torch.Generator().manual_seed(0), 800.0,
        tconfig.RansacConfig(num_hypotheses=256), t(quality))
    assert got.R.shape == (p, 3, 3) and got.inliers.shape == (p, n)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert np.asarray(ref.ok).all()
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_array_equal(got.pose_inliers.numpy(),
                                  np.asarray(ref.pose_inliers))
    np.testing.assert_array_equal(got.inliers.numpy() & mask,
                                  np.stack([sc["inliers"]] * p) & mask)
    assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() < 1e-4
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() < 1e-4
    with pytest.raises(ValueError):
        transac.estimate_essential_ransac_pairs(
            t(x1[0]), t(x2[0]), t(mask[0]), torch.Generator().manual_seed(0),
            800.0)
