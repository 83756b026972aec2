"""The port's Version-A matching against the JAX package on the CPU: the
descriptor layouts, Hamming distances, per-block counts and the banded
counts (the plain version of the band-count kernel) against the XLA path
and both TPU band kernels in interpret mode; the plain versions of the
frame-pair count (K5), nearest-neighbour (D), top-2 (F) and
motion-support (E) kernels against their TPU kernels in interpret mode and
the XLA path; the Version-B ratio matching and the valid-first packing.
Counts, indices and distances are integers: every such comparison is
bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.ops import descriptors as jdesc
from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import pallas_kernels
from slam_loop_closing_tpu_torch.ops import cuda_kernels
from slam_loop_closing_tpu_torch.ops import descriptors as tdesc
from slam_loop_closing_tpu_torch.ops import matching as tmatch
from slam_loop_closing_tpu_torch.utils import convert

torch.set_num_threads(1)

F, N, GAP, BLOCK = 13, 40, 3, 4   # N not a multiple of 128, F of BLOCK


@pytest.fixture(scope="module")
def band_inputs():
    """Random +-1 descriptors with an all-invalid frame and exact
    duplicates across frames (dmin 0 -> threshold 30)."""
    rng = np.random.default_rng(7)
    signed = (rng.integers(0, 2, (F, N, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((F, N)) > 0.2
    valid[2] = False
    signed[9, :12] = signed[1, :12]
    valid[9, :12] = valid[1, :12] = True
    signed = np.where(valid[..., None], signed, 0).astype(np.int8)
    return signed, valid


def test_layouts_equal_jax(rng):
    bits = rng.integers(0, 2, (5, 256)).astype(np.uint8)
    packed = tdesc.bits_to_packed(torch.from_numpy(bits)).numpy()
    ref = np.asarray(jdesc.bits_to_packed(jnp.asarray(bits)))
    np.testing.assert_array_equal(packed.view(np.uint32), ref)
    signed = tdesc.bits_to_signed(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        signed.numpy(), np.asarray(jdesc.bits_to_signed(jnp.asarray(bits))))
    np.testing.assert_array_equal(tdesc.signed_to_packed(signed).numpy(),
                                  packed)
    np.testing.assert_array_equal(
        tdesc.packed_to_bits(torch.from_numpy(packed)).numpy(), bits)


def test_hamming_matrix_and_packed_oracle(rng):
    sq = (rng.integers(0, 2, (30, 256)) * 2 - 1).astype(np.int8)
    st = (rng.integers(0, 2, (20, 256)) * 2 - 1).astype(np.int8)
    got = tmatch.hamming_matrix(torch.from_numpy(sq), torch.from_numpy(st))
    ref = np.asarray(jmatch.hamming_matrix(jnp.asarray(sq), jnp.asarray(st)))
    np.testing.assert_array_equal(got.numpy(), ref)
    oracle = tdesc.hamming_packed(tdesc.signed_to_packed(torch.from_numpy(sq)),
                                  tdesc.signed_to_packed(torch.from_numpy(st)))
    np.testing.assert_array_equal(oracle.numpy(), ref)


def test_block_pair_counts_equal_jax(band_inputs):
    signed, valid = band_inputs
    args = (signed[:5], valid[:5], signed[5:8], valid[5:8])
    got = tmatch.block_pair_counts(*map(torch.from_numpy, args))
    ref = jmatch.block_pair_counts(*map(jnp.asarray, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def banded_reference(name, signed, valid):
    s, v = jnp.asarray(signed), jnp.asarray(valid)
    if name == "xla":
        return np.asarray(jmatch.banded_pair_counts(s, v, GAP, block=BLOCK))
    if name == "band_d1_kernel":
        return np.asarray(pallas_kernels.banded_pair_counts_fused(
            s, v, GAP, block=BLOCK, tile_m=64, interpret=True))
    assert name == "band_counts_kernel"
    return jmatch._banded_chunked_fused(s, v, GAP, scale=2.0, block=BLOCK,
                                        tiles_per_call=5, interpret=True)


@pytest.mark.parametrize("ref_name", ["xla", "band_d1_kernel",
                                      "band_counts_kernel"])
def test_banded_pair_counts_bitwise(band_inputs, ref_name):
    signed, valid = band_inputs
    got = tmatch.banded_pair_counts(torch.from_numpy(signed),
                                    torch.from_numpy(valid), GAP,
                                    block=BLOCK).numpy()
    ref = banded_reference(ref_name, signed, valid)
    np.testing.assert_array_equal(got, ref)
    assert got.max() > 0 and not got[:, 2].any() and not got[2].any()
    assert got[9, 1] >= 12   # the duplicated rows match at distance 0


def test_band_count_tiles_equal_tpu_tile_kernel(band_inputs):
    """Explicit tile lists (every tile pair, not just the band), against
    band_count_tiles_fused in interpret mode."""
    signed, valid = band_inputs
    f = 12
    s, v = signed[:f], valid[:f]
    npad = N + (-N) % 128
    sp = np.pad(s, ((0, 0), (0, npad - N), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, npad - N)))
    nb = f // BLOCK
    pairs = [(q, t) for q in range(nb) for t in range(nb)]
    qidx = np.array([p[0] for p in pairs], np.int32)
    tidx = np.array([p[1] for p in pairs], np.int32)
    ref = pallas_kernels.band_count_tiles_fused(
        jnp.asarray(sp.reshape(nb, BLOCK * npad, 256)),
        jnp.asarray(vp.reshape(nb, BLOCK, npad).astype(np.int32)),
        jnp.asarray(qidx), jnp.asarray(tidx), interpret=True)
    got = cuda_kernels.band_count_tiles(
        tdesc.signed_to_packed(torch.from_numpy(s)), torch.from_numpy(v),
        torch.from_numpy(qidx), torch.from_numpy(tidx), BLOCK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_banded_chunked_equal_jax(band_inputs):
    signed, valid = band_inputs
    got = tmatch.banded_pair_counts_chunked(
        torch.from_numpy(signed), torch.from_numpy(valid), GAP, block=4)
    ref = jmatch.banded_pair_counts_chunked(
        jnp.asarray(signed), jnp.asarray(valid), GAP, block=8,
        tiles_per_call=3)
    np.testing.assert_array_equal(got, ref)


def test_no_band_tiles_gives_zeros(band_inputs):
    signed, valid = band_inputs
    got = tmatch.banded_pair_counts(torch.from_numpy(signed),
                                    torch.from_numpy(valid), F + 5)
    assert got.shape == (F, F) and not got.any()


def test_similarity_equal_jax(rng):
    counts = rng.integers(0, 300, (6, 6)).astype(np.int32)
    n = rng.integers(0, 400, 6).astype(np.int32)
    n[3] = 0
    got = tmatch.similarity(torch.from_numpy(counts),
                            torch.from_numpy(n)[:, None],
                            torch.from_numpy(n)[None, :])
    ref = jmatch.similarity(jnp.asarray(counts), jnp.asarray(n)[:, None],
                            jnp.asarray(n)[None, :])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_refuses_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken; the
    check runs before any kernel is built."""
    meta = torch.empty((4, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.band_count_tiles(
            meta, torch.empty((4, 8), dtype=torch.bool, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError):
        cuda_kernels.extract_patches(torch.zeros((1, 40, 40)),
                                     torch.zeros((1, 3, 2), device="meta"))


def packed(signed: np.ndarray) -> torch.Tensor:
    return tdesc.signed_to_packed(torch.from_numpy(signed))


@pytest.mark.parametrize("ref_name", ["pair_d1_kernel", "xla"])
def test_pair_counts_bitwise(band_inputs, ref_name):
    """K5's plain version on an explicit pair list (a query frame against
    several targets, and a second query frame) against
    block_pair_counts_fused in interpret mode and the XLA
    block_pair_counts; the block form through the dispatching wrapper."""
    signed, valid = band_inputs
    s, v = jnp.asarray(signed), jnp.asarray(valid)
    if ref_name == "xla":
        ref = np.asarray(jmatch.block_pair_counts(s[8:10], v[8:10], s[:7],
                                                  v[:7]))
    else:
        ref = np.asarray(pallas_kernels.block_pair_counts_fused(
            s[8:10], v[8:10], s[:7], v[:7], interpret=True))
    qidx = torch.tensor([8] * 7 + [9] * 7, dtype=torch.int32)
    tidx = torch.arange(7, dtype=torch.int32).repeat(2)
    got = cuda_kernels.pair_counts(packed(signed), torch.from_numpy(valid),
                                   qidx, tidx)
    np.testing.assert_array_equal(got.numpy(), ref.reshape(-1))
    blocks = tmatch.block_pair_counts(
        torch.from_numpy(signed[8:10]), torch.from_numpy(valid[8:10]),
        torch.from_numpy(signed[:7]), torch.from_numpy(valid[:7]))
    np.testing.assert_array_equal(blocks.numpy(), ref)
    assert ref[1, 1] >= 12 and not ref[:, 2].any()


@pytest.fixture(scope="module")
def nn_inputs():
    """Query and target descriptor sets with duplicated target rows (ties
    between distinct indices), queries equal to a target, invalid rows on
    both sides."""
    rng = np.random.default_rng(11)
    sq = (rng.integers(0, 2, (70, 256)) * 2 - 1).astype(np.int8)
    st = (rng.integers(0, 2, (90, 256)) * 2 - 1).astype(np.int8)
    st[40:50] = st[10:20]                      # exact duplicate targets
    sq[:10] = st[10:20]                        # ties at distance 0
    sq[10] = st[60]                            # matches an invalid target
    vq = rng.random(70) > 0.1
    vt = rng.random(90) > 0.15
    vt[10:20] = vt[40:50] = True
    vt[60] = False
    return sq, vq, st, vt


@pytest.mark.parametrize("all_invalid", [False, True])
def test_hamming_nn_plain_equals_tpu_kernel(nn_inputs, all_invalid):
    """On valid query rows: d1 and idx bitwise the TPU kernel's (interpret
    mode), ties to the lowest index; an all-invalid target set gives
    d1 = 2^30 and idx 0 on every row. (The TPU kernel leaves invalid query
    rows unmasked; the port follows the XLA path there, see the next
    test.)"""
    sq, vq, st, vt = nn_inputs
    if all_invalid:
        vt = np.zeros_like(vt)
    d1_ref, idx_ref = pallas_kernels.hamming_nn(
        jnp.asarray(sq), jnp.asarray(st), jnp.asarray(vt), tile_m=64,
        interpret=True)
    d1, idx = cuda_kernels.hamming_nn(packed(sq), torch.from_numpy(vq),
                                      packed(st), torch.from_numpy(vt))
    np.testing.assert_array_equal(d1.numpy()[vq], np.asarray(d1_ref)[vq])
    np.testing.assert_array_equal(idx.numpy()[vq], np.asarray(idx_ref)[vq])
    if all_invalid:
        assert (d1.numpy() == 2 ** 30).all() and not idx.numpy().any()
    else:
        np.testing.assert_array_equal(idx.numpy()[:10][vq[:10]],
                                      np.arange(10, 20)[vq[:10]])
        assert (d1.numpy()[~vq] == 2 ** 30).all()
        assert not idx.numpy()[~vq].any()


@pytest.mark.parametrize("all_invalid", [False, True])
def test_knn2_and_hamming_knn2_plain_equal_jax(nn_inputs, all_invalid):
    """knn2 of the Hamming matrix, and kernel F's plain version over a pair
    list of frame stores: (d1, idx1, d2) bitwise the JAX reference path's
    knn2(hamming_matrix(...)) on every row (an invalid query row, or one
    with no valid target, is (2^30, 0, 2^30)); equal distances tie to the
    lowest index with d2 = d1; the TPU kernel's (interpret mode) on valid
    query rows."""
    sq, vq, st, vt = nn_inputs
    if all_invalid:
        vt = np.zeros_like(vt)
    ref = jmatch.knn2(jmatch.hamming_matrix(jnp.asarray(sq), jnp.asarray(st)),
                      jnp.asarray(vq), jnp.asarray(vt))
    k = tmatch.knn2(tmatch.hamming_matrix(torch.from_numpy(sq),
                                          torch.from_numpy(st)),
                    torch.from_numpy(vq), torch.from_numpy(vt))
    for name in ("idx1", "d1", "d2"):
        np.testing.assert_array_equal(getattr(k, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    # the pairs (1, 1) and (0, 0) of a 2-frame query store and a 3-frame
    # target store, indexed in place
    rng = np.random.default_rng(12)
    other_q = (rng.integers(0, 2, sq.shape) * 2 - 1).astype(np.int8)
    other_t = (rng.integers(0, 2, (2, *st.shape)) * 2 - 1).astype(np.int8)
    pq, pt = packed(np.stack([other_q, sq])), packed(
        np.stack([other_t[0], st, other_t[1]]))
    vqs = torch.from_numpy(np.stack([vq, vq]))
    vts = torch.from_numpy(np.stack([vt, vt, vt]))
    d1, idx, d2 = cuda_kernels.hamming_knn2(
        pq, vqs, pt, vts, torch.tensor([1, 0], dtype=torch.int32),
        torch.tensor([1, 0], dtype=torch.int32))
    assert d1.dtype == idx.dtype == d2.dtype == torch.int32
    np.testing.assert_array_equal(d1[0].numpy(), np.asarray(ref.d1))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref.idx1))
    np.testing.assert_array_equal(d2[0].numpy(), np.asarray(ref.d2))
    if all_invalid:
        assert (d1.numpy() == 2 ** 30).all() and not idx.numpy().any()
        return
    assert (d1[0, :10][vq[:10]] == 0).all() and (d2[0, :10][vq[:10]] == 0).all()
    np.testing.assert_array_equal(idx[0, :10].numpy()[vq[:10]],
                                  np.arange(10, 20)[vq[:10]])
    tpu = pallas_kernels.hamming_knn2(jnp.asarray(sq), jnp.asarray(st),
                                      jnp.asarray(vt), tile_m=64,
                                      interpret=True)
    for got, want in zip((d1[0], idx[0], d2[0]), tpu):
        np.testing.assert_array_equal(got.numpy()[vq], np.asarray(want)[vq])


def test_ratio_matches_hamming_equal_jax(nn_inputs):
    """The ORB ratio test on the XLA path: idx, dist, mask and count, for
    a single pair and through ratio_matches of the distance matrix."""
    sq, vq, st, vt = (a.copy() for a in nn_inputs)
    rng = np.random.default_rng(13)
    sq[20:40] = st[60:80]                       # near copies: ratio matches
    flip = rng.random((20, 256)) < 0.05
    sq[20:40] = np.where(flip, -sq[20:40], sq[20:40])
    vq[20:40] = vt[60:80] = True
    sq = np.where(vq[:, None], sq, 0).astype(np.int8)
    st = np.where(vt[:, None], st, 0).astype(np.int8)
    ref = jmatch.ratio_matches_hamming(jnp.asarray(sq), jnp.asarray(vq),
                                       jnp.asarray(st), jnp.asarray(vt), 0.75)
    got = tmatch.ratio_matches_hamming(packed(sq), torch.from_numpy(vq),
                                       packed(st), torch.from_numpy(vt), 0.75)
    alt = tmatch.ratio_matches(
        tmatch.hamming_matrix(torch.from_numpy(sq), torch.from_numpy(st)),
        torch.from_numpy(vq), torch.from_numpy(vt), 0.75)
    for m in (got, alt):
        for name in ("idx", "dist", "mask", "count"):
            np.testing.assert_array_equal(getattr(m, name).numpy(),
                                          np.asarray(getattr(ref, name)))
    assert int(got.count) >= 20


def test_pack_valid_first_equal_jax():
    """Valid rows first, stable, per frame (a stable sort of a uint8 key)."""
    rng = np.random.default_rng(14)
    desc = rng.integers(-2 ** 31, 2 ** 31, (3, 50, 8)).astype(np.int32)
    xy = rng.random((3, 50, 2)).astype(np.float32)
    valid = rng.random((3, 50)) > 0.4
    valid[1] = False
    ref = jmatch.pack_valid_first(jnp.asarray(desc), jnp.asarray(xy),
                                  jnp.asarray(valid))
    got = tmatch.pack_valid_first(torch.from_numpy(desc), torch.from_numpy(xy),
                                  torch.from_numpy(valid))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2][0, :int(valid[0].sum())].all()


def test_nn_matches_2xmin_equal_jax_xla(nn_inputs):
    """The 2 x min rule on the XLA path: idx and dist on valid query rows,
    mask and count everywhere; also through convert.matches."""
    sq, vq, st, vt = nn_inputs
    sq = np.where(vq[:, None], sq, 0).astype(np.int8)
    st = np.where(vt[:, None], st, 0).astype(np.int8)
    ref = jmatch.nn_matches_2xmin(jnp.asarray(sq), jnp.asarray(vq),
                                  jnp.asarray(st), jnp.asarray(vt))
    got = tmatch.nn_matches_2xmin(packed(sq), torch.from_numpy(vq),
                                  packed(st), torch.from_numpy(vt))
    for name in ("idx", "dist"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[vq],
                                      np.asarray(getattr(ref, name))[vq])
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert int(got.count) == int(ref.count) > 0
    conv = convert.matches(ref, "cpu")
    for a, b in zip(conv, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    xy_q = torch.rand(70, 2)
    xy_t = torch.rand(90, 2)
    q, t = tmatch.gather_matched_points(xy_q, xy_t, got)
    assert torch.equal(q, xy_q) and torch.equal(t, xy_t[got.idx.long()])


@pytest.fixture(scope="module")
def support_inputs():
    """300 matches: float coordinates in normalized units at the live
    path's radius/tau scale, and integer pixel coordinates."""
    rng = np.random.default_rng(5)
    xy_f = rng.normal(size=(300, 2)).astype(np.float32) * 0.3
    flow = np.float32(0.02) + rng.normal(size=(300, 2)).astype(np.float32) * 0.01
    xy_t_f = (xy_f - flow).astype(np.float32)
    xy_i = rng.integers(0, 200, (300, 2)).astype(np.float32)
    xy_t_i = (xy_i - rng.integers(-4, 5, (300, 2))).astype(np.float32)
    mask = np.arange(300) < 280
    mask[7] = False
    return xy_f, xy_t_f, xy_i, xy_t_i, mask


def test_motion_support_plain_equals_tpu_kernel(support_inputs):
    """Float coordinates: bitwise the TPU kernel's direct-difference counts
    (interpret mode)."""
    xy, xy_t, _, _, mask = support_inputs
    radius, tau = 0.208, 0.0256
    ref = pallas_kernels.motion_support_pallas(
        jnp.asarray(xy), jnp.asarray(xy_t), jnp.asarray(mask), radius, tau,
        tile_m=64, interpret=True)
    got = cuda_kernels.motion_support(torch.from_numpy(xy),
                                      torch.from_numpy(xy_t),
                                      torch.from_numpy(mask), radius, tau)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().max() > 5 and not got.numpy()[~mask].any()


def test_motion_support_and_quality_equal_xla(support_inputs):
    """Integer coordinates, where the XLA path's GEMM expansion is exact
    too: support bitwise, prosac_quality within 1e-6."""
    _, _, xy, xy_t, mask = support_inputs
    radius, tau = 30.0, 3.0
    ref = jmatch.motion_support(jnp.asarray(xy), jnp.asarray(xy_t),
                                jnp.asarray(mask), radius, tau)
    got = tmatch.motion_support(torch.from_numpy(xy), torch.from_numpy(xy_t),
                                torch.from_numpy(mask), radius, tau)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rng = np.random.default_rng(6)
    dist = rng.integers(0, 80, 300).astype(np.int32)
    jm = jmatch.Matches(idx=jnp.arange(300, dtype=jnp.int32),
                        dist=jnp.asarray(dist), mask=jnp.asarray(mask),
                        count=jnp.int32(mask.sum()))
    q_ref = jmatch.prosac_quality(jnp.asarray(xy), jnp.asarray(xy_t), jm,
                                  radius, tau)
    q = tmatch.prosac_quality(torch.from_numpy(xy), torch.from_numpy(xy_t),
                              convert.matches(jm, "cpu"), radius, tau)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=0,
                               atol=1e-6)


def test_new_wrappers_refuse_other_devices():
    meta = torch.empty((4, 8), dtype=torch.int32, device="meta")
    vmeta = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.hamming_nn(meta, vmeta, meta, vmeta)
    with pytest.raises(ValueError):
        cuda_kernels.motion_support(torch.zeros((4, 2)), torch.zeros((4, 2)),
                                    vmeta, 1.0, 1.0)
    with pytest.raises(ValueError):
        cuda_kernels.hamming_knn2(
            torch.empty((2, 4, 8), dtype=torch.int32, device="meta"),
            torch.empty((2, 4), dtype=torch.bool, device="meta"),
            torch.empty((2, 4, 8), dtype=torch.int32, device="meta"),
            torch.empty((2, 4), dtype=torch.bool, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        cuda_kernels.pair_counts(
            torch.empty((2, 4, 8), dtype=torch.int32, device="meta"),
            torch.empty((2, 4), dtype=torch.bool, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))


# --------------------------------------------------------------------------
# the SIFT path: squared-L2 distances and float sentinels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["invalid_targets", "invalid_query"])
def test_ratio_matches_float_sentinels_equal_jax(case):
    """A float distance matrix through knn2 / ratio_matches: masked pairs
    take the float sentinel 1e30 (not the integer 2^30), and the match
    distance stays float32. One case with every target invalid, one with an
    invalid query row; d1, d2, idx, mask and dist equal the JAX package's."""
    rng = np.random.default_rng(21)
    dist = rng.random((12, 9)).astype(np.float32) * 4.0
    vq = np.ones(12, bool)
    vt = np.ones(9, bool)
    if case == "invalid_targets":
        vt[:] = False
    else:
        vq[3] = False
        vt[4] = False
    args_j = (jnp.asarray(dist), jnp.asarray(vq), jnp.asarray(vt))
    args_t = (torch.from_numpy(dist), torch.from_numpy(vq),
              torch.from_numpy(vt))
    kj, kt = jmatch.knn2(*args_j), tmatch.knn2(*args_t)
    for name in ("d1", "d2", "idx1"):
        np.testing.assert_array_equal(getattr(kt, name).numpy(),
                                      np.asarray(getattr(kj, name)))
    mj = jmatch.ratio_matches(*args_j, 0.8 * 0.8)
    mt = tmatch.ratio_matches(*args_t, 0.8 * 0.8)
    assert mt.dist.dtype == torch.float32
    for name in ("idx", "dist", "mask", "count"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      np.asarray(getattr(mj, name)))
    if case == "invalid_targets":
        assert (kt.d1.numpy() == np.float32(1e30)).all() and not mt.count
    else:
        assert float(kt.d1[3]) == float(kt.d2[3]) == np.float32(1e30)
        assert int(mt.count) > 0


@pytest.fixture(scope="module")
def l2_int_inputs():
    """Integer-valued 128-d descriptors (the GEMM expansion is exact):
    a 3-frame query store and a 4-frame target store, near copies for ratio
    matches, exact duplicates among the targets (ties: d2 = d1 at the
    lowest index), invalid rows and an all-invalid target frame."""
    rng = np.random.default_rng(22)
    q = rng.integers(0, 16, (3, 50, 128)).astype(np.float32)
    t = rng.integers(0, 16, (4, 60, 128)).astype(np.float32)
    q[:, 10:25] = t[1, 30:45] + rng.integers(-1, 2, (3, 15, 128))
    t[:, 50:53] = t[:, 30:33]
    vq = rng.random((3, 50)) > 0.1
    vt = rng.random((4, 60)) > 0.1
    vt[:, 30:33] = vt[:, 50:53] = True
    vt[3] = False
    return q, vq, t, vt


def test_l2sq_and_ratio_matches_l2_equal_jax(l2_int_inputs):
    """One frame pair: l2sq_matrix bitwise, and ratio_matches_l2 (through
    kernel G's plain version) with idx, dist, mask and count equal to the
    JAX package's XLA path."""
    q, vq, t, vt = l2_int_inputs
    ref_d = jmatch.l2sq_matrix(jnp.asarray(q[0]), jnp.asarray(t[1]))
    got_d = tmatch.l2sq_matrix(torch.from_numpy(q[0]), torch.from_numpy(t[1]))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    ref = jmatch.ratio_matches_l2(jnp.asarray(q[0]), jnp.asarray(vq[0]),
                                  jnp.asarray(t[1]), jnp.asarray(vt[1]), 0.8)
    got = tmatch.ratio_matches_l2(torch.from_numpy(q[0]),
                                  torch.from_numpy(vq[0]),
                                  torch.from_numpy(t[1]),
                                  torch.from_numpy(vt[1]), 0.8)
    for name in ("idx", "dist", "mask", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert int(got.count) >= 10


def test_l2_knn2_pairs_equal_jax(l2_int_inputs):
    """Kernel G's plain version over a pair list of the two stores, in
    place: (d1, idx, d2) bitwise the JAX reference path's
    knn2(l2sq_matrix(...)) per pair, every row (invalid rows and the
    all-invalid target frame give (1e30, 0, 1e30)); the TPU kernel's
    (interpret mode, its bf16 cross term is exact on these integers) on
    valid query rows; ratio_matches_l2_pairs equal to ratio_matches_l2."""
    q, vq, t, vt = l2_int_inputs
    qidx = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    tidx = torch.tensor([1, 1, 3, 0], dtype=torch.int32)
    d1, idx, d2 = cuda_kernels.l2_knn2(
        torch.from_numpy(q), torch.from_numpy(vq), torch.from_numpy(t),
        torch.from_numpy(vt), qidx, tidx)
    assert d1.dtype == d2.dtype == torch.float32 and idx.dtype == torch.int32
    pairs = tmatch.ratio_matches_l2_pairs(
        torch.from_numpy(q), torch.from_numpy(vq), torch.from_numpy(t),
        torch.from_numpy(vt), qidx, tidx, 0.75)
    for p, (a, b) in enumerate(zip(qidx.tolist(), tidx.tolist())):
        ref = jmatch.knn2(jmatch.l2sq_matrix(jnp.asarray(q[a]),
                                             jnp.asarray(t[b])),
                          jnp.asarray(vq[a]), jnp.asarray(vt[b]))
        np.testing.assert_array_equal(d1[p].numpy(), np.asarray(ref.d1))
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(ref.idx1))
        np.testing.assert_array_equal(d2[p].numpy(), np.asarray(ref.d2))
        one = jmatch.ratio_matches_l2(jnp.asarray(q[a]), jnp.asarray(vq[a]),
                                      jnp.asarray(t[b]), jnp.asarray(vt[b]),
                                      0.75)
        for name in ("idx", "dist", "mask", "count"):
            np.testing.assert_array_equal(getattr(pairs, name)[p].numpy(),
                                          np.asarray(getattr(one, name)))
        if b == 3:
            assert (d1[p].numpy() == np.float32(1e30)).all()
            continue
        tpu = pallas_kernels.l2_knn2(jnp.asarray(q[a]), jnp.asarray(t[b]),
                                     jnp.asarray(vt[b]), tile_m=32,
                                     interpret=True)
        for got, want in zip((d1[p], idx[p], d2[p]), tpu):
            np.testing.assert_array_equal(got.numpy()[vq[a]],
                                          np.asarray(want)[vq[a]])
    # duplicated targets 30..32 / 50..52 of frame 1: ties at d2 = d1
    dup = (idx[0].numpy() >= 30) & (idx[0].numpy() < 33) & vq[0]
    assert dup.any() and (d2[0].numpy()[dup] <= d1[0].numpy()[dup]).all()
    empty = cuda_kernels.l2_knn2(
        torch.from_numpy(q), torch.from_numpy(vq), torch.from_numpy(t),
        torch.from_numpy(vt), qidx[:0], tidx[:0])
    assert all(e.shape == (0, 50) for e in empty)


def test_l2_wrappers_refuse_other_devices():
    meta = torch.empty((2, 4, 128), device="meta")
    vmeta = torch.empty((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.l2_knn2(meta, vmeta, meta, vmeta,
                             torch.zeros(1, dtype=torch.int32, device="meta"),
                             torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        cuda_kernels.gauss_stack_resp(torch.empty((1, 64, 64), device="meta"),
                                      (1.6,) * 6, 3)
    ones = torch.ones((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError):   # [F, N, 8] words are not descriptors
        cuda_kernels.l2_knn2(torch.zeros((2, 4, 8)), ones,
                             torch.zeros((2, 4, 8)), ones,
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))


def test_packed_to_signed_and_popcount_alias(rng):
    packed = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(packed.view(np.int32))
    np.testing.assert_array_equal(
        tdesc.packed_to_signed(t).numpy(),
        np.asarray(jdesc.packed_to_signed(jnp.asarray(packed))))
    assert tdesc.popcount_u32 is tdesc.popcount32
    np.testing.assert_array_equal(
        tdesc.popcount_u32(t).numpy(),
        np.asarray(jdesc.popcount_u32(jnp.asarray(packed))))


@pytest.mark.parametrize("t_block", [4, 16])
def test_dense_pair_counts_equals_jax(band_inputs, t_block):
    """The full [F, F] matrix, diagonal and upper triangle included, target
    blocks that do and do not divide F: bitwise."""
    signed, valid = band_inputs
    ref = np.asarray(jmatch.dense_pair_counts(
        jnp.asarray(signed), jnp.asarray(valid), 2.0, t_block))
    got = tmatch.dense_pair_counts(torch.from_numpy(signed),
                                   torch.from_numpy(valid), 2.0, t_block)
    assert got.shape == (F, F) and got.dtype == torch.int32
    assert np.triu(ref).any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_bits_to_packed_in_passes(rng, monkeypatch):
    """Packing a few rows a pass (which bounds the int64 transient of a
    sequence-scale store) gives the words of one pass."""
    bits = torch.from_numpy(rng.integers(0, 2, (3, 11, 256)).astype(np.uint8))
    whole = tdesc.bits_to_packed(bits)
    monkeypatch.setattr(tdesc, "_PACK_ROWS", 7)
    assert torch.equal(tdesc.bits_to_packed(bits), whole)
    assert whole.shape == (3, 11, 8)
