"""Kernel N's plain version (the fixed-order segment sum of BA's and PGO's
normal equations) and the BA and PGO that use it, on the CPU.

``segment_sum_plain`` adds each segment's rows in ascending row order,
from zero: the order of ``index_add_`` of the unsorted rows on the CPU and
of a Python loop over the rows, so all three are compared bitwise (every
float's bits, signed zeros too), on values whose magnitudes spread over
many orders so that any other order would show. BA and PGO are held to the JAX package within ROADMAP R10's
unchanged tolerances (PGO 1e-4; BA 1e-4 for cameras, 1e-3 for points), with
the plans built once per call, and no float sum of either left to
``index_add_``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu import config as jc
from slam_loop_closing_tpu.ops import ba as jba
from slam_loop_closing_tpu.ops import camera as jcam
from slam_loop_closing_tpu.ops import lie as jlie
from slam_loop_closing_tpu.ops import pgo as jpgo
from slam_loop_closing_tpu_torch import config as tc
from slam_loop_closing_tpu_torch.ops import ba as tba
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import pgo as tpgo

torch.set_num_threads(1)

WIDTHS = {1: (), 3: (3,), 6: (6,), 9: (3, 3), 36: (6, 6)}
PGO_ATOL = 1e-4                 # R10
BA_CAM_ATOL, BA_POINT_ATOL = 1e-4, 1e-3


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def spread_values(rng, e: int, d: int) -> np.ndarray:
    """[e, d] float32 of random sign whose magnitudes span ~1e-6 .. 1e6, so
    that the sum of a segment depends on the order of its adds."""
    mag = np.exp(rng.normal(size=(e, 1)) * 5.0)
    return (rng.normal(size=(e, d)) * mag).astype(np.float32)


def index_case(rng, case: str, n: int, e: int) -> np.ndarray:
    if case == "random":
        return rng.integers(0, n, e)
    if case == "empty segments":       # every third segment gets no row
        return rng.choice(np.flatnonzero(np.arange(n) % 3), e)
    if case == "one long segment":     # a camera seen by most observations
        idx = rng.integers(0, n, e)
        idx[rng.random(e) < 0.8] = n // 2
        return idx
    if case == "permuted":             # sorted segments, rows shuffled
        return rng.permutation(np.repeat(np.arange(n), e // n))
    raise ValueError(case)


CASES = ("random", "empty segments", "one long segment", "permuted")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", sorted(WIDTHS))
def test_segment_sum_plain_equals_sequential_index_add(d, case):
    rng = np.random.default_rng(d * 7 + CASES.index(case))
    n, e = 40, 2400
    idx = torch.from_numpy(index_case(rng, case, n, e))
    vals = torch.from_numpy(spread_values(rng, idx.shape[0], d))
    ref = torch.zeros((n, d))
    ref.index_add_(0, idx, vals)
    loop = np.zeros((n, d), np.float32)
    for row, seg in enumerate(idx.numpy()):
        loop[seg] = loop[seg] + vals.numpy()[row]
    got = ck.segment_sum(vals.reshape(-1, *WIDTHS[d]),
                         ck.segment_plan(idx, n))
    assert got.shape == (n, *WIDTHS[d])
    assert np.array_equal(bits(got.reshape(n, d)), bits(ref))
    assert np.array_equal(bits(got.reshape(n, d)), loop.view(np.int32))
    if case == "empty segments":
        assert not got.reshape(n, d)[0::3].any()


def test_segment_sum_order_matters():
    """The values are such that adding a long segment's rows backwards
    gives other bits: the comparisons above see the order."""
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(spread_values(rng, 500, 6))
    idx = torch.zeros(500, dtype=torch.int64)
    fwd = ck.segment_sum(vals, ck.segment_plan(idx, 1))
    bwd = ck.segment_sum(vals.flip(0), ck.segment_plan(idx, 1))
    assert not np.array_equal(bits(fwd), bits(bwd))


def test_segment_plan_groups_rows_stably():
    idx = torch.tensor([3, 1, 3, -1, 0, 1, 5, 3])
    plan = ck.segment_plan(idx, 4)
    assert plan.order.dtype == torch.int32 and plan.offsets.dtype == torch.int32
    # -1 sorts first and 5 last, both outside every segment
    assert plan.order.tolist() == [3, 4, 1, 5, 0, 2, 7, 6]
    assert plan.offsets.tolist() == [1, 2, 4, 4, 7]
    got = ck.segment_sum(torch.arange(8, dtype=torch.float32), plan)
    assert got.tolist() == [4.0, 6.0, 0.0, 9.0]


def test_segment_sum_signed_zeros_as_index_add():
    """A segment of -0.0 rows sums to +0.0 (from zero, as index_add_)."""
    vals = torch.tensor([-0.0, -0.0, 1.0, -0.0])
    got = ck.segment_sum(vals, ck.segment_plan(torch.tensor([0, 0, 1, 1]), 2))
    ref = torch.zeros(2).index_add_(0, torch.tensor([0, 0, 1, 1]), vals)
    assert np.array_equal(bits(got), bits(ref))
    assert not np.signbit(got.numpy()).any()


def test_segment_sum_of_no_rows():
    plan = ck.segment_plan(torch.zeros(0, dtype=torch.int64), 5)
    got = ck.segment_sum(torch.zeros((0, 6)), plan)
    assert got.shape == (5, 6) and not got.any()


def test_segment_sum_checks_its_inputs():
    plan = ck.segment_plan(torch.tensor([0, 1, 1]), 2)
    with pytest.raises(ValueError):
        ck.segment_sum(torch.zeros((3, 2), dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        ck.segment_sum(torch.zeros((4, 2)), plan)
    with pytest.raises(ValueError):
        ck.segment_plan(torch.zeros((2, 2), dtype=torch.int64), 2)


# ---------------------------------------------------------------------------
# BA and PGO against the JAX package, the plans built once per call
# ---------------------------------------------------------------------------

def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, ref, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


@pytest.fixture
def plans_built(monkeypatch):
    """The index sizes of every segment plan built while the test runs."""
    built = []
    make = ck.segment_plan

    def counted(index, n):
        built.append(n)
        return make(index, n)

    monkeypatch.setattr(ck, "segment_plan", counted)
    return built


@pytest.fixture(scope="module")
def ba_scene():
    """Cameras on an arc looking at a point cloud, observations in shuffled
    order (the camera index unsorted): noisy poses, points and pixels,
    invalid observations and an invalid point."""
    rng = np.random.default_rng(16)
    ncam, npts = 7, 150
    K = np.asarray([[420, 0, 210], [0, 420, 160], [0, 0, 1]], np.float32)
    params = np.zeros((ncam, 6), np.float32)
    params[:, 1] = np.linspace(-0.3, 0.3, ncam)
    params[:, 3] = np.linspace(-1.5, 1.5, ncam)
    X = np.stack([rng.uniform(-2, 2, npts), rng.uniform(-1.5, 1.5, npts),
                  rng.uniform(5, 9, npts)], -1).astype(np.float32)
    cams, pids = np.meshgrid(np.arange(ncam), np.arange(npts), indexing="ij")
    perm = rng.permutation(cams.size)
    cams = cams.ravel()[perm].astype(np.int32)
    pids = pids.ravel()[perm].astype(np.int32)
    Rs, ts = jlie.params_to_pose_batch(jnp.asarray(params))
    uv = np.asarray(jax.vmap(lambda R, t, x: jcam.project(
        jnp.asarray(K), R, t, x)[:2])(Rs[cams], ts[cams], X[pids]))
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    valid = rng.random(cams.shape[0]) > 0.1
    noisy = params + rng.normal(size=params.shape).astype(np.float32) * 0.01
    noisy[0] = params[0]
    Xn = (X + rng.normal(size=X.shape) * 0.05).astype(np.float32)
    point_valid = np.ones(npts, bool)
    point_valid[11] = False
    return K, noisy, Xn, (cams, pids, uv, valid), point_valid


def test_refine_cameras_equal_jax_one_plan(ba_scene, plans_built):
    K, params, X, obs, _ = ba_scene
    fixed = np.arange(params.shape[0]) == 0
    ref = jba.refine_cameras(jnp.asarray(K), jnp.asarray(params),
                             jnp.asarray(X),
                             jba.Observations(*map(jnp.asarray, obs)),
                             jnp.asarray(fixed), iterations=4)
    got = tba.refine_cameras(T(K), T(params), T(X),
                             tba.Observations(*map(T, obs)), T(fixed),
                             iterations=4)
    close(got, ref, BA_CAM_ATOL)
    assert plans_built == [params.shape[0]]


def test_refine_points_equal_jax_one_plan(ba_scene, plans_built):
    K, params, X, obs, pv = ba_scene
    ref = jba.refine_points(jnp.asarray(K), jnp.asarray(params),
                            jnp.asarray(X),
                            jba.Observations(*map(jnp.asarray, obs)),
                            jnp.asarray(pv), iterations=4)
    got = tba.refine_points(T(K), T(params), T(X),
                            tba.Observations(*map(T, obs)), T(pv),
                            iterations=4)
    close(got, ref, BA_POINT_ATOL)
    assert np.array_equal(got.numpy()[11], X[11])
    assert plans_built == [X.shape[0]]


def test_alternating_ba_equal_jax_two_plans_an_iteration(ba_scene,
                                                          plans_built):
    K, params, X, obs, pv = ba_scene
    ref = jba.alternating_ba(jnp.asarray(K), jnp.asarray(params),
                             jnp.asarray(X),
                             jba.Observations(*map(jnp.asarray, obs)),
                             jnp.asarray(pv), jc.BaConfig(),
                             outer_iterations=2)
    got = tba.alternating_ba(T(K), T(params), T(X),
                             tba.Observations(*map(T, obs)), T(pv),
                             tc.BaConfig(), outer_iterations=2)
    close(got[0], ref[0], BA_CAM_ATOL)
    close(got[1], ref[1], BA_POINT_ATOL)
    close(got[2], ref[2], 0.0, 1e-4)
    assert plans_built == [params.shape[0], X.shape[0]] * 2


@pytest.fixture(scope="module")
def loop_graph():
    """A 40-pose drifting trajectory with three loop edges, one masked."""
    rng = np.random.default_rng(8)
    n = 40
    truth = np.zeros((n, 6), np.float32)
    truth[:, 2] = np.linspace(0, 2 * np.pi * 0.9, n)
    truth[:, 3] = 5 * np.cos(truth[:, 2])
    truth[:, 4] = 5 * np.sin(truth[:, 2])
    drift = np.cumsum(rng.normal(size=(n, 6)) * 0.01, axis=0)
    drift[0] = 0
    est = (truth + drift).astype(np.float32)
    ef = np.concatenate([np.arange(n - 1), [30, 35, 5]])
    et = np.concatenate([np.arange(1, n), [2, 4, 20]])
    Rt, tt = jlie.params_to_pose_batch(jnp.asarray(truth))
    R_rel, t_rel = jax.vmap(jlie.relative)(Rt[ef], tt[ef], Rt[et], tt[et])
    w = np.where(et == ef + 1, 1.0, 10.0).astype(np.float32)
    mask = np.ones(len(ef), bool)
    mask[-1] = False
    return est, (ef, et, np.asarray(R_rel), np.asarray(t_rel), w, mask)


@pytest.mark.parametrize("dense", [True, False])
def test_optimize_pose_graph_equal_jax_plans_once(loop_graph, dense,
                                                  plans_built):
    """Dense: the edges' plan and the [N * N] blocks' plan; PCG: the
    edges' plan alone, for every iteration and CG step."""
    est, graph = loop_graph
    n = est.shape[0]
    limit = 1500 if dense else 4
    gj = jpgo.PoseGraph(*map(jnp.asarray, graph))
    gt = tpgo.PoseGraph(*(T(a).long() if i < 2 else T(a)
                          for i, a in enumerate(graph)))
    ref, costs_ref = jpgo.optimize_pose_graph(
        jnp.asarray(est), gj, jc.PgoConfig(dense_solver_max_poses=limit,
                                           max_iterations=6))
    got, costs = tpgo.optimize_pose_graph(
        T(est), gt, tc.PgoConfig(dense_solver_max_poses=limit,
                                 max_iterations=6))
    assert float(costs[-1]) < 0.1 * float(costs[0])
    close(costs, costs_ref, 1e-6, 1e-4)
    close(got, ref, PGO_ATOL)
    assert plans_built == ([n * n, n] if dense else [n])


def test_no_float_index_add_in_ba_or_pgo(ba_scene, loop_graph, monkeypatch):
    """Every float sum of BA and PGO goes through the segment sum; outside
    it (whose plain version sums with ``index_add_`` on the CPU) the
    observation counts (int32, exact in any order) are the only
    ``index_add_`` left."""
    outside, sums, inside = [], [], []
    index_add = torch.Tensor.index_add_
    plain = ck.segment_sum_plain

    def spy(self, *args, **kwargs):
        if not inside:
            outside.append(self.dtype)
        return index_add(self, *args, **kwargs)

    def summed(*args):
        inside.append(True)
        sums.append(args[0].dtype)
        try:
            return plain(*args)
        finally:
            inside.pop()

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    monkeypatch.setattr(ck, "segment_sum_plain", summed)
    K, params, X, obs, pv = ba_scene
    tba.alternating_ba(T(K), T(params), T(X), tba.Observations(*map(T, obs)),
                       T(pv), tc.BaConfig(), outer_iterations=1)
    est, graph = loop_graph
    gt = tpgo.PoseGraph(*(T(a).long() if i < 2 else T(a)
                          for i, a in enumerate(graph)))
    for limit in (1500, 4):
        tpgo.optimize_pose_graph(T(est), gt, tc.PgoConfig(
            dense_solver_max_poses=limit, max_iterations=2))
    assert outside and set(outside) == {torch.int32}
    assert len(sums) > 40 and set(sums) == {torch.float32}
