"""The arithmetic forms of the redesigned kernels A (FAST score + NMS + blur)
and G (squared-L2 top-2), modelled in torch on the CPU, where no kernel
runs: A's arc extrema by doubling and its compass pre-test against the
plain score map, bitwise; G's 3xTF32 split of the cross term (exact on
integer-valued descriptors, within 1e-6 of float64 on SIFT descriptors)
and the per-frame extents it reads from the device."""

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu_torch.config import SiftConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import fast as tfast
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
    splits = ck._l2_splits(p_cnt, n, n, 132)
    assert splits == want
    blocks = p_cnt * -(-n // 128)
    assert splits == 1 or (blocks * (splits - 1) < 132
                           and n // splits >= 128)
