"""Kernel S's plain version (the batched one-sided Jacobi SVD of the
two-view geometry's 3 x 3, 4 x 4 and 9 x 9 matrices) on the CPU.

``svd_small_plain`` is held to numpy's float64 SVD of the same float32
matrices (random, ill-conditioned to cond 1e6, rank-deficient, zero, and
with sigma1 = sigma2 as a projected essential matrix has), and at the four
call sites of ``ops/epipolar.py`` to ``jnp.linalg.svd`` (singular values
directly, vectors up to sign, ``decompose_essential``'s candidates as a
set). Tolerances, and why: each rotation rounds to float32, and a sweep
makes n(n - 1)/2 of them, so singular values agree to 4e-6 sigma1 (about
32 float32 ulps; the measured worst case is 2e-6 sigma1 at n = 9), V is
orthogonal to 4e-6, and U diag(S) Vh = A to 4e-6 sigma1. The 3 x 3
contract (det U = +1, no NaN at sigma = 0) is exact, and the result of a
matrix does not depend on its batch: bitwise across batch sizes 1, 7 and
2,000.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures.synthetic import two_view_scene
from slam_loop_closing_tpu.ops import epipolar as jepi
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import epipolar as tepi

torch.set_num_threads(1)

SIZES = (3, 4, 9)
KINDS = ("random", "ill-conditioned", "rank-deficient", "zero", "sigma1=sigma2")
S_RTOL = 4e-6       # singular values, and the reconstruction, times sigma1
ORTH_ATOL = 4e-6    # V^T V = I, U^T U = I
SITE_RTOL = 1e-5    # against XLA's SVD at the call sites, times sigma1
VEC_ATOL = 1e-4     # a singular vector up to sign: its error is about
                    # eps sigma1 / gap, 6e-5 at a gap of 2e-3 sigma1


def orthogonal(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, n)))
    return q * np.sign(np.diag(r))


def make(kind: str, n: int, batch: int, seed: int) -> np.ndarray:
    """[batch, n, n] float32 matrices of ``kind``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        if kind == "random":
            a = rng.normal(size=(n, n)) * 10.0 ** rng.uniform(-2, 2)
        elif kind == "zero":
            a = np.zeros((n, n))
        else:
            if kind == "ill-conditioned":
                d = np.logspace(0, -6, n)
            elif kind == "rank-deficient":
                d = np.r_[rng.uniform(0.5, 2.0, n - 2), 0.0, 0.0]
            else:                           # a projected E: (s, s, 0, ...)
                d = np.r_[1.0, 1.0, rng.uniform(0.0, 0.5, n - 2)]
                d[-1] = 0.0
            a = orthogonal(rng, n) @ np.diag(d) @ orthogonal(rng, n).T
        out.append(a)
    return np.stack(out).astype(np.float32)


def reference_s(a: np.ndarray) -> np.ndarray:
    return np.linalg.svd(a.astype(np.float64), compute_uv=False)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_against_numpy_float64(n, kind):
    """Singular values (descending), V orthogonal, the rotated columns A V
    orthogonal with norms S, and for n = 3 U diag(S) Vh = A with U
    orthogonal."""
    a = make(kind, n, 64, seed=n * 10 + KINDS.index(kind))
    u, s, vh = (x if x is None else x.double().numpy()
                for x in ck.svd_small(torch.from_numpy(a), n == 3))
    scale = np.maximum(reference_s(a)[:, :1], 1e-30)
    assert np.all(np.diff(s, axis=1) <= 0)
    assert np.abs(s - reference_s(a)).max(initial=0.0) <= S_RTOL * scale.max()
    assert np.all(np.abs(s - reference_s(a)) <= S_RTOL * scale)
    eye = np.eye(n)
    assert np.abs(vh @ vh.transpose(0, 2, 1) - eye).max() <= ORTH_ATOL
    av = a.astype(np.float64) @ vh.transpose(0, 2, 1)       # A V = U S
    gram = av.transpose(0, 2, 1) @ av
    assert np.all(np.abs(gram - s[:, None, :] * s[:, :, None] * eye)
                  <= 2 * S_RTOL * scale[:, :, None] ** 2)
    if n == 3:
        assert np.abs(u.transpose(0, 2, 1) @ u - eye).max() <= ORTH_ATOL
        rec = u @ (s[:, :, None] * vh)
        assert np.all(np.abs(rec - a) <= S_RTOL * scale[:, :, None])
    if kind == "zero":
        assert np.all(s == 0) and np.all(vh == eye)
        assert n != 3 or np.all(u == eye)


def jax_svd(a: np.ndarray):
    u, s, vh = jnp.linalg.svd(jnp.asarray(a))
    return np.asarray(u), np.asarray(s), np.asarray(vh)


def vectors_up_to_sign(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest difference of matching rows (singular vectors) of [..., k, n]
    arrays, each row's sign chosen to agree."""
    sign = np.sign(np.sum(got * ref, axis=-1, keepdims=True))
    return float(np.abs(got * sign - ref).max())


@pytest.fixture(scope="module")
def scene():
    """60 points, 0.5 px noise, 30% outliers, normalized coordinates."""
    sc = two_view_scene(np.random.default_rng(0), n_points=60,
                        noise_px=0.5, n_outliers=18)
    K = sc["K"]
    c, f = K[:2, 2], np.array([K[0, 0], K[1, 1]])
    return dict(sc, x1=((sc["uv1"] - c) / f).astype(np.float32),
                x2=((sc["uv2"] - c) / f).astype(np.float32))


def site_matrices(site: str, scene) -> np.ndarray:
    """The matrices a call site of ops/epipolar.py gives its SVD, from the
    scene."""
    x1, x2, inl = scene["x1"], scene["x2"], scene["inliers"]
    if site == "essential_eight_point":       # 9 x 9 R of the weighted QR
        rng = np.random.default_rng(3)
        w = np.stack([inl, inl & (rng.random(inl.shape) < 0.7)]).astype(
            np.float32)                       # the inliers; a LO refit's
        design = np.asarray(jepi.epipolar_design(jnp.asarray(x1),
                                                 jnp.asarray(x2)))
        return np.linalg.qr(design[None] * w[..., None], mode="r")
    E = np.array(jepi.essential_eight_point(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(inl, jnp.float32)))
    if site == "project_to_essential":        # raw 3 x 3 models
        rng = np.random.default_rng(4)
        return (E[None] + 0.05 * rng.normal(size=(8, 3, 3))).astype(
            np.float32)
    if site == "decompose_essential":         # projected E: sigma3 ~ 0
        return E[None]
    rows = tepi._dlt_rows(torch.eye(3), torch.zeros(3),        # 4 x 4 DLT
                          torch.from_numpy(scene["R"].astype(np.float32)),
                          torch.from_numpy(scene["t"].astype(np.float32)),
                          torch.from_numpy(x1), torch.from_numpy(x2))
    return rows.numpy()


@pytest.mark.parametrize("site", ["project_to_essential",
                                  "essential_eight_point",
                                  "decompose_essential", "triangulate_dlt"])
def test_against_jax_at_call_sites(site, scene):
    """Singular values equal XLA's; the vectors each site reads equal XLA's
    up to sign where their singular value is apart from the others; then
    the site's own output against the JAX package's."""
    a = site_matrices(site, scene)
    n = a.shape[-1]
    u, s, vh = ck.svd_small(torch.from_numpy(a), n == 3)
    ju, js, jvh = jax_svd(a)
    scale = js[..., :1]
    assert np.all(np.abs(s.numpy() - js) <= SITE_RTOL * scale)
    if site == "triangulate_dlt" or site == "essential_eight_point":
        # the last row of Vh: the smallest singular value's vector
        assert np.all(js[:, -2] - js[:, -1] > 2e-3 * js[:, 0])
        assert vectors_up_to_sign(vh.numpy()[:, -1:], jvh[:, -1:]) < VEC_ATOL
    if site == "project_to_essential":
        got = tepi.project_to_essential(torch.from_numpy(a)).numpy()
        ref = np.asarray(jax.vmap(jepi.project_to_essential)(jnp.asarray(a)))
        assert np.abs(got - ref).max() < SITE_RTOL * 10 * np.abs(ref).max()
    if site == "decompose_essential":
        Rs, ts = (x.numpy() for x in tepi.decompose_essential(
            torch.from_numpy(a[0])))
        jRs, jts = map(np.asarray, jepi.decompose_essential(
            jnp.asarray(a[0])))
        for R, t in zip(jRs, jts):
            assert min(max(np.abs(R - R2).max(), np.abs(t - t2).max())
                       for R2, t2 in zip(Rs, ts)) < VEC_ATOL
        for R in Rs:
            assert abs(np.linalg.det(R.astype(np.float64)) - 1.0) < 1e-5
    if site == "triangulate_dlt":
        R = torch.from_numpy(scene["R"].astype(np.float32))
        t = torch.from_numpy(scene["t"].astype(np.float32))
        x1, x2 = torch.from_numpy(scene["x1"]), torch.from_numpy(scene["x2"])
        got = tepi.triangulate_dlt(torch.eye(3), torch.zeros(3), R, t, x1,
                                   x2).numpy()
        ref = np.asarray(jepi.triangulate_dlt(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(R.numpy()),
            jnp.asarray(t.numpy()), jnp.asarray(x1.numpy()),
            jnp.asarray(x2.numpy())))
        front = scene["inliers"]
        assert np.abs(got[front] - ref[front]).max() < VEC_ATOL * np.abs(
            ref[front]).max()


def test_eight_point_solve_with_eight_points(scene):
    """With 8 points the QR's R is 8 x 9; the port pads it with a zero row
    for kernel S, whose 9 x 9 SVD has the same right singular vectors: E
    equals the JAX package's (its SVD of the 8 x 9 R) up to sign."""
    x1, x2 = scene["x1"][:8], scene["x2"][:8]
    w = np.ones(8, np.float32)
    got = tepi.essential_eight_point(torch.from_numpy(x1),
                                     torch.from_numpy(x2),
                                     torch.from_numpy(w)).numpy()
    ref = np.asarray(jepi.essential_eight_point(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    assert vectors_up_to_sign(got.reshape(1, 9), ref.reshape(1, 9)) < VEC_ATOL


@pytest.mark.parametrize("kind", ["rank-deficient", "rank one", "zero"])
def test_u_contract_at_n3(kind):
    """det U = +1 exactly as a rotation, U diag(S) Vh = A, and no NaN where
    sigma2 or sigma3 (or all) are 0: U is completed from the identity's
    columns."""
    rng = np.random.default_rng(7)
    a = make("rank-deficient" if kind != "zero" else "zero", 3, 32, 7)
    if kind == "rank one":
        a = np.einsum("bi,bj->bij", rng.normal(size=(32, 3)),
                      rng.normal(size=(32, 3))).astype(np.float32)
        a[0] = np.outer([0, 0, 2], [1, 0, 0])   # sigma2 = sigma3 = 0 exactly
    u, s, vh = ck.svd_small(torch.from_numpy(a), compute_u=True)
    u, s, vh = u.double().numpy(), s.double().numpy(), vh.double().numpy()
    assert np.isfinite(u).all() and np.isfinite(s).all()
    assert np.isfinite(vh).all()
    assert np.abs(np.linalg.det(u) - 1.0).max() < 1e-6
    assert np.abs(u.transpose(0, 2, 1) @ u - np.eye(3)).max() <= ORTH_ATOL
    rec = u @ (s[:, :, None] * vh)
    assert np.abs(rec - a).max() <= S_RTOL * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("n", SIZES)
def test_result_does_not_depend_on_the_batch(n):
    """Matrix by matrix the same bits alone, in a batch of 7 and in one of
    2,000 with other neighbours (F9's fault was a result that did)."""
    big = np.concatenate([make(k, n, 400, seed=n + i)
                          for i, k in enumerate(KINDS)])
    rng = np.random.default_rng(n)
    big = big[rng.permutation(big.shape[0])]
    full = ck.svd_small(torch.from_numpy(big), n == 3)
    picks = rng.choice(big.shape[0], 7, replace=False)
    seven = ck.svd_small(torch.from_numpy(big[picks]), n == 3)
    for got, ref in zip(seven, full):
        if got is not None:
            np.testing.assert_array_equal(bits(got), bits(ref[picks]))
    for i in picks[:3]:
        one = ck.svd_small(torch.from_numpy(big[i:i + 1]), n == 3)
        for got, ref in zip(one, full):
            if got is not None:
                np.testing.assert_array_equal(bits(got[0]), bits(ref[i]))
    # leading axes are a batch too
    lead = ck.svd_small(torch.from_numpy(big[:60].reshape(3, 4, 5, n, n)),
                        n == 3)
    np.testing.assert_array_equal(bits(lead[2].reshape(60, n, n)),
                                  bits(full[2][:60]))


def scalar_svd(a: np.ndarray):
    """Kernel S for one matrix in Python floats (IEEE float64; ``math.sqrt``
    and ``/`` correctly rounded, as CUDA's ``__dsqrt_rn`` and ``__ddiv_rn``),
    line by line as ``csrc/svd_small.cu`` computes it: (U or None, S, Vh)
    as float32 numpy arrays."""
    n = a.shape[0]
    g = [[float(a[r, c]) for r in range(n)] for c in range(n)]
    v = [[float(r == c) for r in range(n)] for c in range(n)]
    rounds = ck.svd_rounds(n)
    for _ in range(ck.SVD_SWEEPS):
        rotated = False
        for pairs in rounds:
            for i, j in pairs:
                al, be, ga = g[i][0] * g[i][0], g[j][0] * g[j][0], \
                    g[i][0] * g[j][0]
                for k in range(1, n):
                    al += g[i][k] * g[i][k]
                    be += g[j][k] * g[j][k]
                    ga += g[i][k] * g[j][k]
                if not ga * ga > ck.SVD_TOL2 * al * be:
                    continue
                rotated = True
                zeta = (be - al) / (ga + ga)
                t = math.copysign(1.0 / (abs(zeta) + math.sqrt(
                    1.0 + zeta * zeta)), zeta)
                c = 1.0 / math.sqrt(1.0 + t * t)
                s = c * t
                for m in (g, v):
                    for k in range(n):
                        x, y = m[i][k], m[j][k]
                        m[i][k], m[j][k] = c * x - s * y, s * x + c * y
        if not rotated:
            break
    sig = []
    for col in g:
        ss = col[0] * col[0]
        for k in range(1, n):
            ss += col[k] * col[k]
        sig.append(math.sqrt(ss))
    key = [x if x == x else -1.0 for x in sig]
    rank = [sum(key[d] > key[c] or (d < c and key[d] == key[c])
                for d in range(n)) for c in range(n)]
    order = sorted(range(n), key=lambda c: rank[c])
    vh = [list(v[c]) for c in order]
    u = None
    if n == 3:
        gs, sg = [g[c] for c in order], [sig[c] for c in order]
        u1 = [x / sg[0] for x in gs[0]] if sg[0] > 0 else [1.0, 0.0, 0.0]
        if sg[1] > 0:
            u2 = [x / sg[1] for x in gs[1]]
        else:
            kk = 1 if abs(u1[1]) < abs(u1[0]) else 0
            kk = 2 if abs(u1[2]) < abs(u1[kk]) else kk
            w = [float(k == kk) - u1[kk] * u1[k] for k in range(3)]
            nrm = math.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
            u2 = [x / nrm for x in w]
        u3 = [u1[1] * u2[2] - u1[2] * u2[1], u1[2] * u2[0] - u1[0] * u2[2],
              u1[0] * u2[1] - u1[1] * u2[0]]
        if gs[2][0] * u3[0] + gs[2][1] * u3[1] + gs[2][2] * u3[2] < 0:
            vh[2] = [-x for x in vh[2]]
        u = np.array([u1, u2, u3], np.float64).T.astype(np.float32)
    return (u, np.array([sig[c] for c in order]).astype(np.float32),
            np.array(vh).astype(np.float32))


@pytest.mark.parametrize("n", SIZES)
def test_plain_equals_the_kernels_arithmetic_in_python_floats(n):
    """svd_small_plain's bits are those of the kernel's arithmetic written
    out in Python floats (every add, product, division and square root
    correctly rounded, as on the card): so torch's own float64 division
    and square root on this CPU round as the card's do."""
    a = np.concatenate([make(k, n, 4, seed=5 * n + i)
                        for i, k in enumerate(KINDS)])
    got = ck.svd_small_plain(torch.from_numpy(a), n == 3)
    for b in range(a.shape[0]):
        ref = scalar_svd(a[b])
        for g, r in zip(got, ref):
            if r is not None:
                np.testing.assert_array_equal(bits(g[b]),
                                              r.view(np.int32))


@pytest.mark.parametrize("n", SIZES)
def test_round_robin_schedule(n):
    """Every pair of columns once a sweep, the pairs of a round disjoint
    (so a round is one batched step), n - 1 rounds (n for odd n)."""
    rounds = ck.svd_rounds(n)
    assert len(rounds) == n - 1 + (n & 1)
    pairs = [p for r in rounds for p in r]
    assert sorted(pairs) == [(i, j) for i in range(n)
                             for j in range(i + 1, n)]
    for r in rounds:
        cols = [c for p in r for c in p]
        assert len(cols) == len(set(cols))


@pytest.mark.parametrize("n", SIZES)
def test_sweeps_stop_after_a_quiet_sweep(n):
    """Each matrix stops after its first sweep that rotates nothing, well
    inside the cap; a stopped matrix's bits do not move however long its
    batch runs on."""
    a = torch.from_numpy(np.concatenate([make(k, n, 16, seed=2 * n)
                                         for k in KINDS]))
    w, sweeps, rotations = ck.svd_jacobi_plain(a)
    assert int(sweeps.max()) <= 12 < ck.SVD_SWEEPS
    assert int(sweeps.min()) >= 1
    zero = KINDS.index("zero") * 16
    assert torch.all(sweeps[zero:zero + 16] == 1)
    # one matrix alone stops at its own count, with the batch's bits
    i = int(torch.argmin(sweeps))
    w1, s1, r1 = ck.svd_jacobi_plain(a[i:i + 1])
    assert int(s1[0]) == int(sweeps[i]) and int(r1[0]) == int(rotations[i])
    assert int(rotations[zero]) == 0
    assert torch.all(rotations <= sweeps * (n * (n - 1) // 2))
    np.testing.assert_array_equal(bits(w1[0]), bits(w[i]))


@pytest.mark.parametrize("bad", ["n=5", "float64", "not square",
                                 "U at n=4"])
def test_rejects_what_the_kernel_does_not_take(bad):
    a = {"n=5": torch.zeros(2, 5, 5), "float64": torch.zeros(2, 3, 3,
                                                             dtype=torch.float64),
         "not square": torch.zeros(2, 3, 4),
         "U at n=4": torch.zeros(2, 4, 4)}[bad]
    with pytest.raises(ValueError):
        ck.svd_small(a, compute_u=bad == "U at n=4")


def test_no_linalg_svd_left_on_the_main_paths():
    """The port's ops and models call kernel S for every SVD of a tensor
    (numpy's SVDs in models/calibration.py are host code)."""
    from pathlib import Path

    import slam_loop_closing_tpu_torch as pkg

    root = Path(pkg.__file__).parent
    hits = [f"{p.relative_to(root)}:{i}"
            for sub in ("ops", "models") for p in (root / sub).glob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if "torch.linalg.svd(" in line]
    assert hits == []


# --------------------------------------------------------------------------
# The lane schedule of kernel S (a group of n // 2 lanes a matrix, a lane a
# pair of each round), on the CPU
# --------------------------------------------------------------------------

def lane_pairs(n: int) -> list[list[tuple[int, int]]]:
    """Kernel S's lane schedule by its closed form (``lane_pair`` in
    csrc/svd_small.cu): for each round, the pair ``(i, j)`` of each of its
    ``n // 2`` lanes. Lane ``p`` takes the ``p``-th of the round's position
    pairs ``(k, m - 1 - k)``, in ascending ``k``, that does not hold the
    padding column ``m - 1`` of an odd ``n``; that column sits at position
    ``r`` of round ``r >= 1`` and at ``m - 1`` of round 0."""
    m = n + (n & 1)

    def slot(r, p):
        return 0 if p == 0 else 1 + (p - 1 - r) % (m - 1)

    out = []
    for r in range(m - 1):
        q = m - 1 if r == 0 else r
        pad = min(q, m - 1 - q)
        row = []
        for p in range(n // 2):
            k = p + 1 if n & 1 and p >= pad else p
            x, y = slot(r, k), slot(r, m - 1 - k)
            row.append((min(x, y), max(x, y)))
        out.append(row)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_lane_pairs_are_the_rounds(n):
    """Kernel S's closed form gives each round n // 2 lanes, their pairs
    those of ``svd_rounds`` in the same order: every pair of columns once a
    sweep, the pairs of a round disjoint (so the lanes of a round may run
    at once)."""
    lanes = lane_pairs(n)
    assert lanes == ck.svd_rounds(n)
    assert all(len(r) == n // 2 for r in lanes)
    pairs = [p for r in lanes for p in r]
    assert sorted(pairs) == [(i, j) for i in range(n)
                             for j in range(i + 1, n)]
    for r in lanes:
        cols = [c for p in r for c in p]
        assert len(cols) == len(set(cols)) and all(i < j for i, j in r)


@pytest.mark.parametrize("n", range(2, 17))
def test_lane_pairs_closed_form_at_every_size(n):
    """The closed form (where the padding column of an odd n sits) holds
    beyond the kernel's sizes too: 2 to 16 columns."""
    assert lane_pairs(n) == ck.svd_rounds(n)


def lane_order_jacobi(a: np.ndarray, rng):
    """Kernel S's sweeps on one matrix in Python floats, a round at a time
    as its group of lanes runs them: every lane reads its columns as they
    stood at the round's start, and the lanes finish in ``rng``'s order.
    Returns (G and V as ``svd_jacobi_plain``'s ``w`` row by row, sweeps)."""
    n = a.shape[0]
    g = [[float(a[r, c]) for r in range(n)] for c in range(n)]
    v = [[float(r == c) for r in range(n)] for c in range(n)]
    sweeps = 0
    for _ in range(ck.SVD_SWEEPS):
        sweeps += 1
        rotated = False
        for pairs in ck.svd_rounds(n):
            start = {c: (list(g[c]), list(v[c])) for p in pairs for c in p}
            order = list(range(len(pairs)))
            rng.shuffle(order)
            for lane in order:
                i, j = pairs[lane]
                (gi, vi), (gj, vj) = start[i], start[j]
                al, be, ga = gi[0] * gi[0], gj[0] * gj[0], gi[0] * gj[0]
                for k in range(1, n):
                    al += gi[k] * gi[k]
                    be += gj[k] * gj[k]
                    ga += gi[k] * gj[k]
                if not ga * ga > ck.SVD_TOL2 * al * be:
                    continue
                rotated = True
                zeta = (be - al) / (ga + ga)
                t = math.copysign(1.0 / (abs(zeta) + math.sqrt(
                    1.0 + zeta * zeta)), zeta)
                c = 1.0 / math.sqrt(1.0 + t * t)
                s = c * t
                g[i] = [c * x - s * y for x, y in zip(gi, gj)]
                g[j] = [s * x + c * y for x, y in zip(gi, gj)]
                v[i] = [c * x - s * y for x, y in zip(vi, vj)]
                v[j] = [s * x + c * y for x, y in zip(vi, vj)]
        if not rotated:
            break
    return np.array([gc + vc for gc, vc in zip(g, v)]), sweeps


@pytest.mark.parametrize("n", SIZES)
def test_lanes_in_any_order_give_the_plain_bits(n):
    """Whatever order the lanes of a round finish in, a matrix's G, V and
    sweeps are ``svd_jacobi_plain``'s, bit for bit: on random,
    rank-deficient, zero and widely scaled (1e-30 to 1e30) matrices."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=20, deadline=None, derandomize=True,
              database=None)
    @given(kind=st.sampled_from(("random", "rank-deficient", "zero",
                                 "scaled")),
           seed=st.integers(0, 2 ** 31 - 1),
           scale=st.integers(-30, 30), rng=st.randoms(use_true_random=False))
    def check(kind, seed, scale, rng):
        if kind == "scaled":
            a = make("random", n, 1, seed)[0].astype(np.float64)
            a = (a / np.abs(a).max() * 10.0 ** scale).astype(np.float32)
        else:
            a = make(kind, n, 1, seed)[0]
        w, sweeps, _ = ck.svd_jacobi_plain(torch.from_numpy(a[None]))
        got, got_sweeps = lane_order_jacobi(a, rng)
        assert got_sweeps == int(sweeps[0])
        np.testing.assert_array_equal(got.view(np.int64),
                                      w[0].numpy().view(np.int64))

    check()
