"""Kernel N's plain version (the fixed-order segment sum of BA's and PGO's
normal equations) and the BA and PGO that use it, on the CPU.

``segment_sum_plain`` adds each segment's rows in ascending row order,
from zero: the order of ``index_add_`` of the unsorted rows on the CPU and
of a Python loop over the rows, so all three are compared bitwise (every
float's bits, signed zeros too), on values whose magnitudes spread over
many orders so that any other order would show. BA and PGO are held to the JAX package within ROADMAP R10's
unchanged tolerances (PGO 1e-4; BA 1e-4 for cameras, 1e-3 for points), with
the plans built once per call, and no float sum of either left to
``index_add_``. ``segment_sums`` (several sums over one plan, a sum of
two row lists read as one) is held bitwise to separate plain sums and
``torch.cat``, the plan's list of long segments to numpy, and BA and PGO
bitwise to a composition of one sum a launch, with the launches of a
Gauss-Newton or PCG step counted.
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


# ---------------------------------------------------------------------------
# Several sums a launch, two sources a sum, the plan's long / short split
# ---------------------------------------------------------------------------

SUM_WIDTHS = {"BA cameras H, g": ((6, 6), (6,)),
              "BA points H, g": ((3, 3), (3,)),
              "PGO gradient, diagonal": ((6,), (6, 6)),
              "three sums": ((3, 3), (3,), ()),
              "one sum": ((),)}


@pytest.mark.parametrize("widths", SUM_WIDTHS.values(), ids=SUM_WIDTHS)
def test_segment_sums_equal_separate_plain_sums(widths):
    """One call over several row tensors of one plan gives, bit for bit,
    what a separate ``segment_sum_plain`` gives for each."""
    rng = np.random.default_rng(len(widths) * 11 + len(widths[0]))
    n, e = 40, 2400
    idx = torch.from_numpy(index_case(rng, "one long segment", n, e))
    plan = ck.segment_plan(idx, n)
    vals = [torch.from_numpy(spread_values(
        rng, e, int(np.prod(w)))).reshape(e, *w) for w in widths]
    got = ck.segment_sums(plan, *vals)
    assert len(got) == len(vals)
    for g, v in zip(got, vals):
        ref = ck.segment_sum_plain(v, plan)
        assert g.shape == ref.shape
        assert np.array_equal(bits(g), bits(ref))


@pytest.mark.parametrize("split", [0, 1, 1201, 2400])
def test_segment_sums_two_sources_equal_cat(split):
    """A (first, second) pair reads as the rows of ``torch.cat``; beside a
    one-source sum in the same call."""
    rng = np.random.default_rng(split)
    n, e = 40, 2400
    idx = torch.from_numpy(index_case(rng, "random", n, e))
    plan = ck.segment_plan(idx, n)
    rows = torch.from_numpy(spread_values(rng, e, 36)).reshape(e, 6, 6)
    other = torch.from_numpy(spread_values(rng, e, 6))
    pair, single = ck.segment_sums(plan, (rows[:split], rows[split:]), other)
    ref = ck.segment_sum(torch.cat([rows[:split], rows[split:]]), plan)
    assert np.array_equal(bits(pair), bits(ref))
    assert np.array_equal(bits(single),
                          bits(ck.segment_sum_plain(other, plan)))


def test_segment_sums_checks_its_inputs():
    plan = ck.segment_plan(torch.tensor([0, 1, 1]), 2)
    rows = torch.zeros((3, 6))
    with pytest.raises(ValueError, match="one to three"):
        ck.segment_sums(plan, rows, rows, rows, rows)
    with pytest.raises(ValueError, match="two parts"):
        ck.segment_sums(plan, (rows[:1], rows[:1]))
    with pytest.raises(ValueError, match="two parts"):
        ck.segment_sums(plan, (rows[:1], torch.zeros((2, 3))))
    with pytest.raises(ValueError, match="two parts"):
        ck.segment_sums(plan, (rows[:1], rows[1:], rows[:0]))


def numpy_long_split(idx: np.ndarray, n: int, short_rows: int):
    """(segment lengths, the segments of more than ``short_rows`` rows in
    ascending order) by numpy."""
    inside = idx[(idx >= 0) & (idx < n)]
    lengths = np.bincount(inside, minlength=n)[:n]
    return lengths, np.flatnonzero(lengths > short_rows)


def plan_index(rng, case: str):
    if case == "empty plan":
        return np.zeros(0, np.int64), 7
    if case == "no segments":
        return rng.integers(-3, 0, 50), 0
    if case == "empty segments":
        return index_case(rng, "empty segments", 40, 2400), 40
    if case == "camera of 5,000 rows":
        idx = rng.integers(0, 95, 20000)
        idx[rng.permutation(20000)[:5000]] = 95
        return idx, 96
    if case == "10,000 segments of degree 2":
        return rng.permutation(np.repeat(np.arange(10000), 2)), 10000
    if case == "rows outside every segment":
        idx = rng.integers(-1, 12, 300)
        idx[::7] = 40
        return idx, 12
    return index_case(rng, case, 40, 2400), 40


PLAN_CASES = ("empty plan", "no segments", "empty segments", "random",
              "one long segment", "camera of 5,000 rows",
              "10,000 segments of degree 2", "rows outside every segment")


@pytest.mark.parametrize("case", PLAN_CASES)
def test_segment_plan_long_split_equals_numpy(case, monkeypatch):
    """The plan's list of long segments (more than ``SHORT_ROWS`` rows,
    ascending, first) and their count, against numpy; at the library's
    threshold and at 0 (every non-empty segment long)."""
    rng = np.random.default_rng(PLAN_CASES.index(case))
    idx, n = plan_index(rng, case)
    for short_rows in (ck.SHORT_ROWS, 0):
        monkeypatch.setattr(ck, "SHORT_ROWS", short_rows)
        plan = ck.segment_plan(torch.from_numpy(idx), n)
        lengths, long_ids = numpy_long_split(idx, n, short_rows)
        assert plan.n == n and plan.short_rows == short_rows
        assert plan.long_blocks == 0     # a plan on the CPU
        assert plan.long_ids.dtype == torch.int32
        assert plan.long_count.dtype == torch.int32
        assert plan.long_ids.shape == (n,)
        assert int(plan.long_count) == long_ids.size
        assert np.array_equal(plan.long_ids.numpy()[:long_ids.size], long_ids)
        assert np.array_equal(np.sort(plan.long_ids.numpy()), np.arange(n))
        assert np.array_equal(plan.offsets.diff().numpy(), lengths)
    if case == "camera of 5,000 rows":
        assert long_ids.tolist() == list(range(96))
        assert int(plan.offsets[96] - plan.offsets[95]) == 5000


# ---------------------------------------------------------------------------
# BA and PGO against the composition of one sum a launch (torch.cat)
# ---------------------------------------------------------------------------

def separate_refine(K, cam_params, points, obs, argnum, movable,
                    iterations, damping, reduce):
    """``ba._refine`` with H, g and the errors each a sum of its own."""
    x0 = cam_params if argnum == 1 else points
    group = obs.cam if argnum == 1 else obs.point
    plan = ck.segment_plan(torch.where(obs.valid, group.long(), -1),
                           x0.shape[0])

    def scatter(values):
        return reduce(ck.segment_sum(values, plan))

    def args(x):
        return (x, points) if argnum == 1 else (cam_params, x)

    def errs(x):
        return scatter(tba.reprojection_errors(K, *args(x), obs) ** 2)

    x, err_x = x0, errs(x0)
    for _ in range(iterations):
        r, J = tba._per_obs_jacobians(K, *args(x), obs, argnum)
        H = scatter(torch.einsum("oik,oil->okl", J, J))
        g = scatter(torch.einsum("oik,oi->ok", J, r))
        delta = torch.where(movable[:, None],
                            tba._solve_damped(H, g, damping), 0.0)
        cand = x + delta
        err_cand = errs(cand)
        better = (err_cand <= err_x) & torch.all(torch.isfinite(cand), dim=1)
        x = torch.where(better[:, None], cand, x)
        err_x = torch.where(better, err_cand, err_x)
    return x


def cat_edge_sum(plan, from_terms, to_terms):
    return ck.segment_sum(torch.cat([from_terms, to_terms]), plan)


def separate_dense_step(params, g, plans, damping, reduce):
    """``pgo._dense_step`` with the gradient's two lists concatenated."""
    n = params.shape[0]
    r = tpgo.residuals(params, g)
    Jf, Jt = tpgo._edge_jacobians(params, g)
    grad = reduce(cat_edge_sum(plans.edges,
                                torch.einsum("eij,ei->ej", Jf, r),
                                torch.einsum("eij,ei->ej", Jt, r)))
    Hft = torch.einsum("eij,eik->ejk", Jf, Jt)
    blocks = reduce(ck.segment_sum(
        torch.cat([torch.einsum("eij,eik->ejk", Jf, Jf),
                   torch.einsum("eij,eik->ejk", Jt, Jt), Hft,
                   Hft.transpose(1, 2)]), plans.blocks))
    Hm = blocks.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(n * 6, n * 6)
    bm = grad.reshape(n * 6)
    lam = tpgo._div(damping * torch.trace(Hm), n * 6)
    eye = torch.eye(n * 6, dtype=params.dtype, device=params.device)
    Hm = Hm + lam * eye
    fix = torch.arange(n * 6, device=params.device) < 6
    Hm = torch.where(fix[:, None] | fix[None, :], eye, Hm)
    bm = torch.where(fix, 0.0, bm)
    L, _ = torch.linalg.cholesky_ex(Hm)
    return torch.cholesky_solve(-bm[:, None], L)[:, 0].reshape(n, 6)


def separate_hvp(v, g, plans, Jf, Jt, lam, reduce):
    y = (torch.einsum("eij,ej->ei", Jf, v[g.e_from])
         + torch.einsum("eij,ej->ei", Jt, v[g.e_to]))
    out = reduce(cat_edge_sum(plans.edges, torch.einsum("eij,ei->ej", Jf, y),
                               torch.einsum("eij,ei->ej", Jt, y))) + lam * v
    first = (torch.arange(v.shape[0], device=v.device) == 0)[:, None]
    return torch.where(first, v, out)


def separate_pcg_step(params, g, plans, damping, cg_iterations, reduce):
    """``pgo._pcg_step`` with a sum a launch and the lists concatenated."""
    n = params.shape[0]
    r = tpgo.residuals(params, g)
    Jf, Jt = tpgo._edge_jacobians(params, g)
    grad = reduce(cat_edge_sum(plans.edges,
                                torch.einsum("eij,ei->ej", Jf, r),
                                torch.einsum("eij,ei->ej", Jt, r)))
    diag = reduce(cat_edge_sum(plans.edges,
                                torch.einsum("eij,eik->ejk", Jf, Jf),
                                torch.einsum("eij,eik->ejk", Jt, Jt)))
    tr = torch.sum(torch.diagonal(diag, dim1=-2, dim2=-1))
    lam = tpgo._div(damping * tr, n * 6)
    eye6 = torch.eye(6, dtype=params.dtype, device=params.device)
    first = (torch.arange(n, device=params.device) == 0)
    Minv = torch.linalg.inv_ex(diag + lam * eye6)[0]
    Minv = torch.where(first[:, None, None], eye6, Minv)
    b = torch.where(first[:, None], 0.0, -grad)

    def precond(x):
        return torch.einsum("nij,nj->ni", Minv, x)

    tiny = torch.full((), 1e-20, dtype=params.dtype, device=params.device)
    x = torch.zeros_like(b)
    res = b - separate_hvp(x, g, plans, Jf, Jt, lam, reduce)
    z = precond(res)
    p = z
    for _ in range(cg_iterations):
        Ap = separate_hvp(p, g, plans, Jf, Jt, lam, reduce)
        rz = torch.sum(res * z)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x = x + alpha * p
        res = res - alpha * Ap
        z_new = precond(res)
        beta = torch.sum(res * z_new) / torch.maximum(rz, tiny)
        p = z_new + beta * p
        z = z_new
    return x


@pytest.fixture
def separate_sums(monkeypatch):
    """Puts BA's and PGO's steps with one sum a launch, the two edge lists
    concatenated, in place of the current ones."""
    def use():
        monkeypatch.setattr(tba, "_refine", separate_refine)
        monkeypatch.setattr(tpgo, "_dense_step", separate_dense_step)
        monkeypatch.setattr(tpgo, "_pcg_step", separate_pcg_step)
    return use


def ba_inputs(ba_scene):
    K, params, X, obs, pv = ba_scene
    return T(K), T(params), T(X), tba.Observations(*map(T, obs)), T(pv)


def same_bits(a, b) -> None:
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert np.array_equal(bits(x), bits(y))


BA_CALLS = {
    "refine_cameras": lambda K, p, X, obs, pv: tba.refine_cameras(
        K, p, X, obs, torch.arange(p.shape[0]) == 0, iterations=4),
    "refine_points": lambda K, p, X, obs, pv: tba.refine_points(
        K, p, X, obs, pv, iterations=4),
    "alternating_ba": lambda K, p, X, obs, pv: tba.alternating_ba(
        K, p, X, obs, pv, tc.BaConfig(), outer_iterations=2),
}


@pytest.mark.parametrize("name", BA_CALLS)
def test_ba_equals_separate_sums(ba_scene, separate_sums, name):
    """H and g summed in one call give the bits of separate sums."""
    args = ba_inputs(ba_scene)
    got = BA_CALLS[name](*args)
    separate_sums()
    same_bits(got, BA_CALLS[name](*args))


@pytest.mark.parametrize("dense", [True, False])
def test_optimize_pose_graph_equals_separate_sums(loop_graph,
                                                 separate_sums, dense):
    """The two-source sums (no ``torch.cat``) and the gradient and diagonal
    in one call give the bits of separate sums, poses and costs."""
    est, graph = loop_graph
    gt = tpgo.PoseGraph(*(T(a).long() if i < 2 else T(a)
                          for i, a in enumerate(graph)))
    cfg = tc.PgoConfig(dense_solver_max_poses=1500 if dense else 4,
                       max_iterations=4, cg_iterations=12)
    got = tpgo.optimize_pose_graph(T(est), gt, cfg)
    separate_sums()
    same_bits(got, tpgo.optimize_pose_graph(T(est), gt, cfg))


@pytest.fixture
def launches(monkeypatch):
    """The number of sums of each ``segment_sums`` call (one launch of
    kernel N on the card) while the test runs."""
    calls = []
    sums = ck.segment_sums

    def counted(plan, *args):
        calls.append(len(args))
        return sums(plan, *args)

    monkeypatch.setattr(ck, "segment_sums", counted)
    return calls


@pytest.mark.parametrize("argnum", [1, 2])
def test_ba_launches_per_gauss_newton_step(ba_scene, launches, argnum):
    """A refine of i iterations: 1 + 2 i launches (the errors at the start,
    then each step's H and g together and the candidate's errors)."""
    K, p, X, obs, pv = ba_inputs(ba_scene)
    if argnum == 1:
        tba.refine_cameras(K, p, X, obs, iterations=5)
    else:
        tba.refine_points(K, p, X, obs, pv, iterations=5)
    assert launches == [1] + [2, 1] * 5


@pytest.mark.parametrize("dense", [True, False])
def test_pgo_launches_per_step(loop_graph, launches, dense):
    """Dense: a step's gradient, then its [N * N] blocks; PCG: the gradient
    and the diagonal together, then one Hessian-vector product before CG
    and one a CG iteration."""
    est, graph = loop_graph
    gt = tpgo.PoseGraph(*(T(a).long() if i < 2 else T(a)
                          for i, a in enumerate(graph)))
    cg = 7
    tpgo.optimize_pose_graph(T(est), gt, tc.PgoConfig(
        dense_solver_max_poses=1500 if dense else 4, max_iterations=3,
        cg_iterations=cg))
    step = [1, 1] if dense else [2] + [1] * (cg + 1)
    assert launches == step * 3
