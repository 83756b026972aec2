"""The arithmetic forms of the redesigned kernels A (FAST score + NMS + blur)
and G (squared-L2 top-2), modelled in torch on the CPU, where no kernel
runs: A's arc extrema by doubling and its compass pre-test against the
plain score map, bitwise; G's 3xTF32 split of the cross term (exact on
integer-valued descriptors, within 1e-6 of float64 on SIFT descriptors)
and the per-frame extents it reads from the device. Likewise E's and F's
splits and keys, and kernel H's tiles: the blur level by level in tiles
with a sliding window, and the gates in tiles of DoG planes formed once,
bitwise against the plain chain and gates."""

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu_torch.config import SiftConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import fast as tfast
from slam_loop_closing_tpu_torch.ops import image as timage
from slam_loop_closing_tpu_torch.ops import matching as tmatch
from slam_loop_closing_tpu_torch.ops import sift as tsift
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

from test_torch_fast import corner_frames

torch.set_num_threads(1)

THR = 20.0 / 255.0


# --------------------------------------------------------------------------
# kernel A
# --------------------------------------------------------------------------

def doubling_score_map(imgs: torch.Tensor, threshold: float) -> torch.Tensor:
    """Kernel A's FAST-9 score: minima and maxima over cyclic windows of 2,
    4 and 8 ring samples, then 9 (the 8-window and one more sample), the
    best and worst arcs, then the centre and the threshold subtracted
    once, in float32."""
    r = tfast._shifted_ring(imgs)                       # [16, B, H, W]

    def roll(x, k):
        return torch.roll(x, -k, dims=0)                # x[(i + k) % 16]

    lo, hi = torch.minimum(r, roll(r, 1)), torch.maximum(r, roll(r, 1))
    for k in (2, 4):
        lo, hi = torch.minimum(lo, roll(lo, k)), torch.maximum(hi, roll(hi, k))
    best = torch.amax(torch.minimum(lo, roll(r, 8)), dim=0)
    worst = torch.amin(torch.maximum(hi, roll(r, 8)), dim=0)
    bright = best - imgs - threshold
    dark = imgs - worst - threshold
    score = torch.clamp_min(torch.maximum(bright, dark), 0.0)
    h, w = imgs.shape[-2:]
    return torch.where(tfast._interior(h, w, 3, imgs.device), score, 0.0)


def frames_with_flats_and_ties(rng, b, h, w) -> torch.Tensor:
    """corner_frames with a flat band (every ring sample equals its centre)
    and a two-valued checkerboard patch (ring windows full of ties)."""
    imgs = corner_frames(rng, b, h, w)
    imgs[:, h // 4:h // 2, :] = 0.5
    yy, xx = np.mgrid[0:20, 0:24]
    imgs[:, -24:-4, 4:28] = np.where((yy // 2 + xx // 3) % 2, 0.2, 0.6)
    return torch.from_numpy(imgs.astype(np.float32))


@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (1, 75, 133), (3, 40, 50)])
def test_doubling_arc_extrema_bitwise(b, h, w):
    rng = np.random.default_rng(h * w)
    imgs = frames_with_flats_and_ties(rng, b, h, w)
    ref = tfast.fast_score_map(imgs, THR)
    got = doubling_score_map(imgs, THR)
    assert torch.equal(got, ref)
    assert (ref > 0).any() and (ref == 0).any()


@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (1, 75, 133)])
def test_compass_pretest_zero_set(b, h, w):
    """Where the exact compass pre-test fails the score is 0, so skipping
    the arc extrema there changes no bit; it fails on most pixels."""
    rng = np.random.default_rng(h + w)
    imgs = frames_with_flats_and_ties(rng, b, h, w)
    score = tfast.fast_score_map(imgs, THR)
    passing = ck.fast_compass_pass(imgs, THR)
    assert (score[~passing] == 0).all()
    assert passing[score > 0].all()
    assert 0.0 < float(passing.float().mean()) < 0.6
    # the kernel's per-warp skip needs 32 neighbouring pixels of a row to
    # fail together: the flat band does
    runs = passing[..., :w // 32 * 32].reshape(b, h, -1, 32).any(-1)
    assert not runs.all()


# --------------------------------------------------------------------------
# kernel G
# --------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 to tf32 (10 mantissa bits) rounded to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: integer bit operations."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 to tf32 by dropping the 13 low mantissa bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split3(x: torch.Tensor):
    """Kernel G's split: hi = tf32(x), lo = x - hi (exact in float32), of
    which the tensor cores read a tf32; the emulation truncates lo, the
    coarser of the two roundings it could take."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def cross_3xtf32(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """hi.hi' + hi.lo' + lo.hi' with exact products and sums (float64): the
    3xTF32 cross term without the tensor cores' accumulation rounding."""
    qh, ql = (a.double() for a in split3(q))
    th, tl = (a.double() for a in split3(t))
    mm = lambda a, b: a @ b.transpose(-1, -2)   # noqa: E731
    return mm(qh, th) + mm(qh, tl) + mm(ql, th)


def test_tf32_rounding_ties_away():
    one = 1.0 + 2.0 ** -10                   # a tf32 value
    half = 2.0 ** -11                        # half a tf32 ulp at 1
    x = torch.tensor([1.0 + half, one + half, -(1.0 + half),
                      1.0 + half * 0.99, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + 2.0 ** -10, -one, 1.0, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


@pytest.mark.parametrize("top", [16, 256])
def test_split_exact_on_integer_descriptors(top):
    """Integer descriptors 0..top-1: lo is 0, hi is x, and every product and
    partial sum is an integer below 2^24: the 3xTF32 distance equals the
    plain version's float32 one bitwise."""
    rng = np.random.default_rng(top)
    q = torch.from_numpy(rng.integers(0, top, (60, 128)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, top, (70, 128)).astype(np.float32))
    for x in (q, t):
        hi, lo = split3(x)
        assert torch.equal(hi, x) and not lo.any()
    cross = cross_3xtf32(q, t)
    assert torch.equal(cross.float(), q @ t.T)
    nq, nt = (torch.sum(x.double() ** 2, -1) for x in (q, t))
    d = torch.clamp_min(nq[:, None] - 2.0 * cross + nt[None, :], 0.0)
    assert torch.equal(d.float(), tmatch.l2sq_matrix(q, t))


@pytest.fixture(scope="module")
def sift_features():
    """The port's SIFT features of tests/test_torch_sift.py's frames at its
    configuration (grid 0)."""
    frames = np.asarray(orbit_sequence(num_frames=3, h=144, w=192,
                                       num_points=250, seed=11), np.float32)
    return tsift.detect_and_describe_batch(
        torch.from_numpy(frames), SiftConfig(num_features=400,
                                             num_octaves=2))


def test_split_within_1e6_of_float64_on_sift(sift_features):
    """On unit-norm SIFT descriptors the 3xTF32 distances are within 1e-6
    of float64 (the dropped lo.lo' is 2^-22 of |q||t|), and the plain
    version's d1 and d2 within 1e-5 of float64's: the margin behind
    kernel G's 1e-5 tolerance against its plain version."""
    f = sift_features
    desc, valid = f.descriptors, f.valid
    assert valid.sum(1).min() > 50
    q, t = desc[0], desc[1]
    nq, nt = (torch.sum(x.double() ** 2, -1) for x in (q, t))
    exact = torch.clamp_min(nq[:, None] - 2.0 * (q.double() @ t.double().T)
                            + nt[None, :], 0.0)
    emul = torch.clamp_min(nq[:, None] - 2.0 * cross_3xtf32(q, t)
                           + nt[None, :], 0.0)
    both = valid[0][:, None] & valid[1][None, :]
    assert float((emul - exact)[both].abs().max()) < 1e-6
    ref = tmatch.knn2(exact, valid[0], valid[1])
    one = torch.tensor([0], dtype=torch.int32)
    d1, idx, d2 = ck.l2_knn2_plain(desc, valid, desc, valid, one, one + 1)
    rows = valid[0]
    assert float((d1[0] - ref.d1.float())[rows].abs().max()) < 1e-5
    assert float((d2[0] - ref.d2.float())[rows].abs().max()) < 1e-5
    far = rows & ((ref.d2 - ref.d1) > 1e-5)
    assert far.sum() > 30
    assert torch.equal(idx[0][far], ref.idx1[far])


@pytest.mark.parametrize("case", ["holes", "empty_frame", "last_row",
                                  "all_valid", "no_rows"])
def test_frame_extents(case):
    """The last valid row + 1 of every frame, whatever the order of valid
    rows: holes mid-frame, a frame with no valid row (extent 0), a frame
    whose only valid row is its last, a store without rows."""
    rng = np.random.default_rng(3)
    n = 0 if case == "no_rows" else 37
    valid = rng.random((5, n)) < 0.5
    if case == "holes":
        valid[:, n - 6:] = False
        valid[2, 10:20] = False
    if case == "empty_frame":
        valid[1] = False
    if case == "last_row":
        valid[3] = False
        valid[3, -1] = True
    if case == "all_valid":
        valid[:] = True
    want = np.array([np.flatnonzero(v).max() + 1 if v.any() else 0
                     for v in valid], np.int32)
    got = ck.frame_extents(torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p_cnt,n,want", [(1, 1536, 11), (32, 1536, 1),
                                          (1176, 1536, 1), (1, 100, 1),
                                          (2, 4000, 3)])
def test_l2_target_splits(p_cnt, n, want):
    """Kernel G splits the target rows of a short pair list over blocks so
    that the 132 SMs of an H100 each get one (its blocks run one an SM),
    never below two 64-row stages a split; a pair list with a block for
    every SM is not split."""
    splits = ck._target_splits(p_cnt * -(-n // ck._L2_QUERY_ROWS), 1, n,
                               2 * ck._L2_STAGE_ROWS, 132)
    assert splits == want
    blocks = p_cnt * -(-n // 128)
    assert splits == 1 or (blocks * (splits - 1) < 132
                           and n // splits >= 128)


# --------------------------------------------------------------------------
# kernel F
# --------------------------------------------------------------------------

IDX_BITS = 20
NO_KEY = 1 << 30                    # keys at or above: no valid target
INVALID_COL = NO_KEY + (1 << 29)    # column key of an invalid target row
STAGE = 512                         # target rows kernel F stages at a time


def _bits(packed: torch.Tensor) -> np.ndarray:
    return ck.desc_ops.packed_to_bits(packed).numpy().astype(np.int64)


def push2(m1, m2, k):
    """Kernel F's running top-2 of keys: m2 = min(m2, max(m1, k)), m1 =
    min(m1, k)."""
    return np.minimum(m1, k), np.minimum(m2, np.maximum(m1, k))


def merge2(a, b):
    """The top-2 of two top-2s: (min(a1, b1), min(max(a1, b1), a2, b2))."""
    return (np.minimum(a[0], b[0]),
            np.minimum(np.maximum(a[0], b[0]), np.minimum(a[1], b[1])))


def knn2_keyed(packed_q, valid_q, packed_t, valid_t, qidx, tidx, splits):
    """Kernel F's arithmetic, step by step: col_t = (popc(t) << 20) + j
    (2^30 + 2^29 for an invalid row), the keys col_t - 2^21 popc(q & t) of
    each lane's two columns of every 8-row tile, in the order it sweeps
    them, its running top-2, the merge over the 4 lanes of a quad (xor 1,
    then xor 2), popc(q) << 20 added, the merge over splits of the target
    rows, and the decode to (d1, idx, d2). Every key is checked to fit in
    int32."""
    n_t = packed_t.shape[1]
    split_len = -(-n_t // splits)
    splits = -(-n_t // split_len)
    outs = []
    for qf, tf in zip(qidx.tolist(), tidx.tolist()):
        bq, bt = _bits(packed_q[qf]), _bits(packed_t[tf])
        acc = bq @ bt.T                                   # popc(q & t)
        j = np.arange(n_t)
        col = np.where(valid_t[tf].numpy(), (bt.sum(1) << IDX_BITS) + j,
                       INVALID_COL)
        keys = col[None, :] - acc * (2 << IDX_BITS)
        assert keys.min() >= -2 ** 31 and keys.max() < 2 ** 31
        pq = bq.sum(1) << IDX_BITS
        full = np.full(bq.shape[0], NO_KEY, np.int64)
        total = None
        for s in range(splits):
            t_begin = s * split_len
            lanes = []
            for tq in range(4):
                m = (full, full)
                for t0 in range(t_begin, min(n_t, t_begin + split_len), STAGE):
                    t_end = min(n_t, t_begin + split_len, t0 + STAGE)
                    for c in range(t0 + 2 * tq, t_end, 8):  # 2 tq, 2 tq + 1
                        for jj in (c, c + 1):
                            if jj < t_end:
                                m = push2(*m, keys[:, jj])
                lanes.append(m)
            lanes = [merge2(lanes[i], lanes[i ^ 1]) for i in range(4)]
            lanes = [merge2(lanes[i], lanes[i ^ 2]) for i in range(4)]
            assert all(np.array_equal(lanes[0][h], ln[h])
                       for ln in lanes for h in (0, 1))
            part = (lanes[0][0] + pq, lanes[0][1] + pq)
            assert part[1].max() < 2 ** 31
            total = part if total is None else merge2(total, part)
        k1, k2 = total
        hit = valid_q[qf].numpy() & (k1 < NO_KEY)
        outs.append((np.where(hit, k1 >> IDX_BITS, 2 ** 30),
                     np.where(hit, k1 & ((1 << IDX_BITS) - 1), 0),
                     np.where(hit & (k2 < NO_KEY), k2 >> IDX_BITS, 2 ** 30)))
    return tuple(torch.from_numpy(np.stack(o).astype(np.int32))
                 for o in zip(*outs))


def knn2_store(rng, case: str, n: int):
    """A 4-frame store of n rows and a 5-pair list for one edge case."""
    signed = (rng.integers(0, 2, (4, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((4, n)) < 0.9
    if case == "ties":             # duplicated targets, queries equal them
        signed[:, n - 40:n - 20] = signed[:, 10:30]
        signed[0, :20] = signed[1, 10:30]
        valid[:, 10:30] = valid[:, n - 40:n - 20] = valid[0, :20] = True
    if case == "invalid_query":
        valid[0, ::3] = False
    if case == "empty_frame":
        valid[2] = False
    if case == "single_valid":     # one valid target row: d2 = 2^30
        valid[3] = False
        valid[3, n // 2] = True
    if case == "near_ties":        # distances 0, 1, 1, 2 from the queries
        signed[1, 5] = signed[0, 0]
        for r, flips in ((n - 3, 1), (7, 1), (n - 1, 2)):
            signed[1, r] = signed[0, 0]
            signed[1, r, :flips] *= -1
        valid[0, 0] = valid[1, [5, 7, n - 3, n - 1]] = True
    packed = ck.desc_ops.signed_to_packed(torch.from_numpy(signed))
    qidx = torch.tensor([0, 0, 1, 3, 2], dtype=torch.int32)
    tidx = torch.tensor([1, 2, 3, 0, 1], dtype=torch.int32)
    return packed, torch.from_numpy(valid), qidx, tidx


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case,n", [("random", 300), ("ties", 1100),
                                    ("invalid_query", 300),
                                    ("empty_frame", 300),
                                    ("single_valid", 300),
                                    ("near_ties", 600)])
def test_knn2_keyed_epilogue_equals_plain(case, n, splits):
    """Kernel F's keyed top-2, lane by lane, quad and split merges, equals
    hamming_knn2_plain: forced ties resolve to the lowest row with d2 = d1,
    invalid query rows give (2^30, 0, 2^30), an all-invalid target frame
    2^30, a frame with one valid row d2 = 2^30; 1,100 rows cross a stage."""
    rng = np.random.default_rng(n + len(case))
    packed, valid, qidx, tidx = knn2_store(rng, case, n)
    ref = ck.hamming_knn2_plain(packed, valid, packed, valid, qidx, tidx)
    got = knn2_keyed(packed, valid, packed, valid, qidx, tidx, splits)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    d1, idx, d2 = ref
    if case == "ties":
        rows = valid[0, :20]
        assert (d1[0, :20][rows] == 0).all() and (d2[0, :20][rows] == 0).all()
        assert (idx[0, :20][rows] == torch.arange(10, 30)[rows]).all()
    if case == "empty_frame":
        assert (d1[1] == 2 ** 30).all() and (d2[1] == 2 ** 30).all()
    if case == "single_valid":
        assert (d2[2] == 2 ** 30).all()
        assert torch.equal(d1[2] < 2 ** 30, valid[1])
    if case == "near_ties":
        assert (int(d1[0, 0]), int(idx[0, 0]), int(d2[0, 0])) == (0, 5, 1)


def test_knn2_keys_order_lexicographic():
    """A key orders (distance, row) lexicographically for every distance
    -256..256 a key can carry before popc(q) is added, and decodes back."""
    d = np.arange(-256, 257)[:, None]
    j = np.array([0, 1, 2 ** 19, 2 ** 20 - 1])[None, :]
    keys = (d << IDX_BITS) + j
    assert np.all(np.diff(keys.ravel()) > 0)
    assert np.array_equal(keys >> IDX_BITS, np.broadcast_to(d, keys.shape))
    assert np.array_equal(keys & ((1 << IDX_BITS) - 1),
                          np.broadcast_to(j, keys.shape))
    # an invalid column's key stays at or above NO_KEY at any product
    assert INVALID_COL - 256 * (2 << IDX_BITS) >= NO_KEY


# --------------------------------------------------------------------------
# kernel E
# --------------------------------------------------------------------------

def support_split(xy_q, xy_t, mask, radius, tau, splits):
    """Kernel E's split: invalid target rows staged with x = NaN, each
    split's partial count over its target rows (in stages of 512), the -1
    added by the one split whose range holds the row itself, nothing added
    for an invalid row, the partials summed as integers."""
    q = torch.cat([xy_q, xy_q - xy_t], dim=-1)
    staged = q.clone()
    staged[..., 0] = torch.where(mask, q[..., 0], float("nan"))
    r2, t2 = ck._square_f32(radius), ck._square_f32(tau)
    n = q.shape[-2]
    split_len = -(-n // splits)
    rows = torch.arange(n)
    out = torch.zeros(mask.shape, dtype=torch.int32)
    for t_begin in range(0, n, split_len):
        cnt = torch.zeros(mask.shape, dtype=torch.int32)
        for t0 in range(t_begin, min(n, t_begin + split_len), 512):
            t = staged[..., t0:min(n, t_begin + split_len, t0 + 512), :]

            def sq(a, b):
                ex = a[..., :, None, 0] - b[..., None, :, 0]
                ey = a[..., :, None, 1] - b[..., None, :, 1]
                return ex * ex + ey * ey

            ok = (sq(q[..., :2], t[..., :2]) < r2) & (sq(q[..., 2:],
                                                         t[..., 2:]) < t2)
            cnt += torch.sum(ok, dim=-1, dtype=torch.int32)
        own = ((rows >= t_begin) & (rows < t_begin + split_len)).int()
        out += torch.where(mask, cnt - own, 0).int()
    return out


@pytest.mark.parametrize("splits", [1, 4, 31])
@pytest.mark.parametrize("batch,n", [(1, 2000), (1, 1531), (3, 1000)])
def test_support_split_equals_plain(batch, n, splits):
    """Partial counts over target splits of several sizes (n no multiple of
    a split, a stage or a slab), summed, with one self-subtraction, equal
    motion_support_plain bitwise; NaN points and masked rows included."""
    rng = np.random.default_rng(n + splits)
    xy = rng.uniform(-0.6, 0.6, (batch, n, 2)).astype(np.float32)
    xy[:, 3] = np.nan
    flow = (0.02 + 0.002 * rng.normal(size=(batch, n, 2))).astype(np.float32)
    flow[:, : n // 3] = rng.uniform(-0.3, 0.3, (batch, n // 3, 2))
    mask = torch.from_numpy(rng.random((batch, n)) < 0.8)
    mask[:, 3] = True              # a NaN point supports nothing, not itself
    xy_q = torch.from_numpy(xy)
    xy_t = xy_q - torch.from_numpy(flow.astype(np.float32))
    args = (xy_q, xy_t, mask, 0.06, 0.0125)
    ref = ck.motion_support_plain(*args)
    assert torch.equal(support_split(*args, splits), ref)
    assert int(ref.max()) > 0 and int(ref.min()) == -1


@pytest.mark.parametrize("batch,n,want", [(1, 2000, 62), (1, 4000, 66),
                                          (1, 1000, 31), (32, 1000, 9),
                                          (32, 1536, 6), (1, 100, 3),
                                          (200, 2000, 1)])
def test_motion_support_splits(batch, n, want):
    """Kernel E splits a set's target matches over blocks until the 132 SMs
    of an H100 have four blocks of 128 threads each, never below 32 matches
    a split; a batch that fills the card alone is not split."""
    splits = ck._target_splits(batch * -(-n // ck._MS_SLAB),
                               ck._MS_BLOCKS_PER_SM, n, ck._MS_MIN_SPLIT, 132)
    assert splits == want
    blocks = batch * -(-n // 512)
    assert splits == 1 or (blocks * (splits - 1) < 4 * 132
                           and n // splits >= 32)


@pytest.mark.parametrize("p_cnt,n,want", [(1, 1000, 15), (300, 1000, 1),
                                          (1176, 1000, 1), (3, 1100, 17),
                                          (1, 50, 1), (2, 4000, 9)])
def test_knn2_target_splits(p_cnt, n, want):
    """Kernel F splits the target rows of a short pair list over blocks
    until every SM of an H100 has two blocks of 256 query rows, never below
    64 rows a split (the keyframe step's one pair: 4 blocks x 15 splits);
    the loop search's pair list is not split."""
    splits = ck._target_splits(p_cnt * -(-n // ck._KNN2_SLAB),
                               ck._KNN2_BLOCKS_PER_SM, n,
                               ck._KNN2_MIN_SPLIT_ROWS, 132)
    assert splits == want
    blocks = p_cnt * -(-n // 256)
    assert splits == 1 or (blocks * (splits - 1) < 2 * 132
                           and n // splits >= 64)


# --------------------------------------------------------------------------
# kernel H
# --------------------------------------------------------------------------

def reflect_clamped(i: int, n: int) -> int:
    """The kernel's reflect index: numpy's "reflect", clamped into the
    frame for tile positions past a ragged edge."""
    i = abs(i)
    i = 2 * (n - 1) - i if i >= n else i
    return min(max(i, 0), n - 1)


def blur_tiled(imgs: torch.Tensor, taps, cols: int, rows: int):
    """Kernel H's blur of one level, tile by tile: per tile the columns of
    the tile and its halo (reflected at the frame edge), a window of 2R+1
    rows sliding down them (the vertical pass, one row in a step), then the
    horizontal pass over the vertical results; the plain tap order."""
    r = (len(taps) - 1) // 2
    b, h, w = imgs.shape
    out = torch.full_like(imgs, float("nan"))
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            xs = [reflect_clamped(x0 - r + c, w) for c in range(cols + 2 * r)]
            col = imgs[:, :, xs]
            win = [col[:, reflect_clamped(y0 - r + k, h)]
                   for k in range(2 * r)]
            vert = []
            for y in range(y0, min(y0 + rows, h)):
                win = win[-2 * r:] + [col[:, reflect_clamped(y + r, h)]]
                v = taps[0] * win[0]
                for j in range(1, 2 * r + 1):
                    v = v + taps[j] * win[j]
                vert.append(v)
            vert = torch.stack(vert, dim=1)
            n = min(cols, w - x0)
            o = taps[0] * vert[..., 0:n]
            for j in range(1, 2 * r + 1):
                o = o + taps[j] * vert[..., j:j + n]
            out[:, y0:y0 + vert.shape[1], x0:x0 + n] = o
    return out


def blob_frames(b: int, h: int, w: int, seed: int) -> torch.Tensor:
    """[b, h, w] float32 blob texture: coarse noise upsampled."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(
        rng.random((b, h // 6 + 2, w // 6 + 2)).astype(np.float32))
    return timage.resize_bilinear(coarse, h, w)


@pytest.mark.parametrize("radius", range(1, 10))
def test_blur_window_tiles_equal_plain(radius):
    """Each radius of the blur in tiles of 128 columns and 16 rows, ragged
    in both directions, against image.gaussian_blur, bitwise."""
    imgs = blob_frames(2, 37, 150, radius)
    sigma = max(0.5, radius / 3.0)
    taps = [float(v) for v in timage.gaussian_kernel1d(sigma, radius)]
    assert torch.equal(blur_tiled(imgs, taps, 128, 16),
                       timage.gaussian_blur(imgs, sigma, radius))


@pytest.mark.parametrize("rows", [64, 16])
def test_blur_window_reflects_both_sides(rows):
    """A frame narrower and shorter than one tile with its halo at R = 9:
    the tile's halo reflects at both edges of the frame in both passes, and
    the chain of levels (each reflecting its own input) equals the plain
    chain of the octave, bitwise."""
    imgs = blob_frames(2, 11, 12, rows)
    sig = tsift._chain_sigmas(3, 1.6)
    taps = tsift.chain_taps(sig)
    assert max(len(t) for t in taps) == 19
    levels = [blur_tiled(imgs, taps[0], 128, rows)]
    for t in taps[1:]:
        levels.append(blur_tiled(levels[-1], t, 128, rows))
    assert torch.equal(torch.stack(levels, dim=-3),
                       tsift._gaussian_chain(imgs, sig))


def gates_tiled(gauss: torch.Tensor, s: int, thr: float, edge_r: float,
                border: int, cols: int, rows: int) -> torch.Tensor:
    """Kernel H's gates, tile by tile: the L Gaussian planes over the tile
    and a 2-pixel halo (indices clamped into the frame), the S+2 DoG planes
    formed once; per plane the row maxima (minima) of three, the pair of
    rows above and below, the full 3x3 and, for a centre plane, the 3x3
    without its centre, each formed once; the three merged per response
    plane; then the contrast gate, the Hessian on the tile's DoG plane and
    the border gate."""
    b, _, h, w = gauss.shape
    edge_rhs = float(np.float32((edge_r + 1.0) ** 2))
    mx, mn = torch.maximum, torch.minimum
    out = torch.full((b, s, h, w), float("nan"))
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            ys = torch.arange(y0 - 2, y0 + rows + 2).clamp(0, h - 1)
            xs = torch.arange(x0 - 2, x0 + cols + 2).clamp(0, w - 1)
            g = gauss[:, :, ys][:, :, :, xs]
            dog = g[:, 1:] - g[:, :-1]              # [b, S+2, rows+4, cols+4]
            left = dog[..., 1:cols + 1]
            mid = dog[..., 2:cols + 2]
            right = dog[..., 3:cols + 3]
            rmax, rmin = mx(mx(left, mid), right), mn(mn(left, mid), right)
            amax = mx(rmax[..., 1:rows + 1, :], rmax[..., 3:rows + 3, :])
            amin = mn(rmin[..., 1:rows + 1, :], rmin[..., 3:rows + 3, :])
            fmax = mx(amax, rmax[..., 2:rows + 2, :])
            fmin = mn(amin, rmin[..., 2:rows + 2, :])
            emax = mx(amax, mx(left, right)[..., 2:rows + 2, :])
            emin = mn(amin, mn(left, right)[..., 2:rows + 2, :])
            yy = torch.arange(y0, y0 + rows)[:, None]
            xx = torch.arange(x0, x0 + cols)[None, :]
            inside = ((yy >= border) & (yy < h - border) & (xx >= border)
                      & (xx < w - border))
            for j in range(s):
                nmax = mx(mx(fmax[:, j], emax[:, j + 1]), fmax[:, j + 2])
                nmin = mn(mn(fmin[:, j], emin[:, j + 1]), fmin[:, j + 2])
                d = dog[:, j + 1]
                v = mid[:, j + 1, 2:rows + 2]

                def at(dy, dx):
                    return d[:, 2 + dy:rows + 2 + dy, 2 + dx:cols + 2 + dx]

                def half(a, c):
                    return (a - c) * 0.5

                gxx = half(half(at(0, 2), v), half(v, at(0, -2)))
                gyy = half(half(at(2, 0), v), half(v, at(-2, 0)))
                gxy = half(half(at(1, 1), at(1, -1)),
                           half(at(-1, 1), at(-1, -1)))
                tr = gxx + gyy
                det = gxx * gyy - gxy * gxy
                ok = (inside & ((v > nmax) | (v < nmin)) & (v.abs() >= thr)
                      & (det > 0) & (tr * tr * edge_r < edge_rhs * det))
                tile = torch.where(ok, v.abs(), 0.0)
                nh, nw = min(rows, h - y0), min(cols, w - x0)
                out[:, j, y0:y0 + nh, x0:x0 + nw] = tile[:, :nh, :nw]
    return out


@pytest.mark.parametrize("s,h,w,cols,rows,border", [
    (3, 61, 77, 32, 16, 8),     # ragged, the kernel's tile
    (2, 61, 77, 32, 16, 8),
    (3, 40, 52, 8, 4, 2),       # tiles across the border band, border 2
    (2, 37, 45, 1, 3, 2),       # a tile narrower than its halo
    (3, 33, 29, 5, 1, 3),       # a tile shorter than its halo
    (3, 48, 128, 64, 16, 8)])   # tiles that divide the frame (the
                                # kernel's first form)
def test_gates_tiles_equal_plain(s, h, w, cols, rows, border):
    """The gates in tiles of DoG planes formed once, with the extremum from
    per-plane row maxima shared by the response planes above and below,
    against sift._gates on a real octave's Gaussian stack, bitwise, with
    extrema that pass every gate."""
    imgs = blob_frames(2, h, w, h + w)
    gauss = tsift._gaussian_chain(imgs, tsift._chain_sigmas(s, 1.6))
    thr = float(np.float32(0.01 / s))
    ref = tsift._gates(gauss, s, thr, 10.0, border)
    assert int((ref > 0).sum()) > 0
    assert torch.equal(gates_tiled(gauss, s, thr, 10.0, border, cols, rows),
                       ref)
