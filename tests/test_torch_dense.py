"""The port's explicit-pair-list counts (the dense all-pairs scan of a
sequence) against the JAX package on the CPU: the plain version of the
d1-only nearest-neighbour kernel against the TPU kernel in interpret mode,
``good_count_pair``, ``all_pairs_good_counts`` and
``dense_pair_counts_chunked`` against the JAX functions, the pair route
against the tile route, the truncated threshold at a non-integer scale, and
the integer identities the tensor-core count kernels rest on.
Distances and counts are integers: every comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import pallas_kernels
from slam_loop_closing_tpu_torch.ops import cuda_kernels
from slam_loop_closing_tpu_torch.ops import descriptors as tdesc
from slam_loop_closing_tpu_torch.ops import matching as tmatch

torch.set_num_threads(1)

F, N = 7, 36


def _signed(rng, *shape):
    return (rng.integers(0, 2, (*shape, 256)) * 2 - 1).astype(np.int8)


def _packed(signed: np.ndarray) -> torch.Tensor:
    return tdesc.signed_to_packed(torch.from_numpy(signed))


@pytest.fixture(scope="module")
def store():
    """Random +-1 descriptors with invalid rows, an all-invalid frame and
    exact duplicates across frames (dmin 0 -> the threshold's floor 30)."""
    rng = np.random.default_rng(11)
    signed = _signed(rng, F, N)
    valid = rng.random((F, N)) > 0.2
    valid[3] = False
    signed[5, :10] = signed[1, :10]
    valid[5, :10] = valid[1, :10] = True
    signed = np.where(valid[..., None], signed, 0).astype(np.int8)
    return signed, valid


@pytest.mark.parametrize("m,n", [(100, 70), (33, 600)])
def test_d1_plain_equals_tpu_kernel(m, n):
    """Rows with a valid target: bitwise the interpreted Pallas kernel; no
    valid target: both reject every row (>= 2^29; the port gives 2^30)."""
    rng = np.random.default_rng(m + n)
    sq, st = _signed(rng, m), _signed(rng, n)
    st[n // 2:n // 2 + 3] = sq[:3]                    # distance 0
    vt = rng.random(n) > 0.2
    ref = np.asarray(pallas_kernels.hamming_nn_d1(
        jnp.asarray(sq), jnp.asarray(st), jnp.asarray(vt), tile_m=64,
        interpret=True))
    got = cuda_kernels.hamming_nn_d1(_packed(sq), _packed(st),
                                     torch.from_numpy(vt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    none = np.zeros(n, bool)
    ref0 = np.asarray(pallas_kernels.hamming_nn_d1(
        jnp.asarray(sq), jnp.asarray(st), jnp.asarray(none), tile_m=64,
        interpret=True))
    got0 = cuda_kernels.hamming_nn_d1_plain(_packed(sq), _packed(st),
                                            torch.from_numpy(none))
    assert np.all(ref0 >= 2 ** 29) and np.all(got0.numpy() == 2 ** 30)


def test_d1_pairs_plain_indexes_stores_in_place(store):
    """The pair-list form on two stores of different row counts, int64 and
    repeated pairs, against the single-pair form."""
    signed, valid = store
    rng = np.random.default_rng(2)
    sq = _signed(rng, 3, 20)
    pq, pt = _packed(sq), _packed(signed)
    vt = torch.from_numpy(valid)
    qidx = torch.tensor([2, 0, 2, 1])
    tidx = torch.tensor([5, 3, 5, 0])
    got = cuda_kernels.hamming_d1_pairs(pq, pt, vt, qidx, tidx)
    assert got.shape == (4, 20)
    for p in range(4):
        ref = cuda_kernels.hamming_nn_d1_plain(pq[qidx[p]], pt[tidx[p]],
                                               vt[tidx[p]])
        assert torch.equal(got[p], ref)
    assert (got[1] == 2 ** 30).all()                  # frame 3 has no row
    empty = cuda_kernels.hamming_d1_pairs(pq, pt, vt, qidx[:0], tidx[:0])
    assert empty.shape == (0, 20)


@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_good_count_pair_equals_jax(store, scale):
    signed, valid = store
    for q, t in ((5, 1), (6, 2), (4, 3), (3, 0)):
        ref = int(jmatch.good_count_pair(
            jnp.asarray(signed[q]), jnp.asarray(valid[q]),
            jnp.asarray(signed[t]), jnp.asarray(valid[t]), scale))
        ref_k = int(pallas_kernels.good_count_pair_pallas(
            jnp.asarray(signed[q]), jnp.asarray(valid[q]),
            jnp.asarray(signed[t]), jnp.asarray(valid[t]), scale,
            interpret=True))
        got = int(tmatch.good_count_pair(
            _packed(signed[q]), torch.from_numpy(valid[q]),
            _packed(signed[t]), torch.from_numpy(valid[t]), scale))
        assert got == ref == ref_k, (q, t)
        m = tmatch.nn_matches_2xmin(
            _packed(signed[q]), torch.from_numpy(valid[q]),
            _packed(signed[t]), torch.from_numpy(valid[t]), scale)
        assert got == int(m.count)


@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_all_pairs_good_counts_equals_jax(store, scale):
    """An explicit pair list padded with index 0 pairs."""
    signed, valid = store
    pq = np.array([5, 6, 4, 2, 0, 0, 0], np.int32)
    pt = np.array([1, 0, 3, 1, 0, 0, 0], np.int32)
    ref = np.asarray(jmatch.all_pairs_good_counts(
        jnp.asarray(signed), jnp.asarray(valid), jnp.asarray(pq),
        jnp.asarray(pt), scale))
    got = tmatch.all_pairs_good_counts(
        _packed(signed), torch.from_numpy(valid), torch.from_numpy(pq),
        torch.from_numpy(pt), scale)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0] >= 10 and ref[2] == 0


@pytest.mark.parametrize("min_gap,pairs_per_call", [(1, 5), (2, 4), (1, 8192)])
def test_dense_pair_counts_chunked_equals_jax(store, min_gap, pairs_per_call):
    signed, valid = store
    ref = jmatch.dense_pair_counts_chunked(
        jnp.asarray(signed), jnp.asarray(valid), min_gap=min_gap,
        pairs_per_call=pairs_per_call)
    got = tmatch.dense_pair_counts_chunked(
        torch.from_numpy(signed), torch.from_numpy(valid), min_gap=min_gap,
        pairs_per_call=pairs_per_call)
    assert got.dtype == np.int32 and got.shape == (F, F)
    np.testing.assert_array_equal(got, ref)
    assert got[5, 1] >= 10 and not np.triu(got, 1 - min_gap).any()


def test_dense_pair_route_equals_tile_route(store):
    """At an integer scale the explicit-pair route (kernel I's path) and
    the band-tile route (kernel C's path) give the same matrix."""
    signed, valid = (torch.from_numpy(a) for a in store)
    dense = tmatch.dense_pair_counts_chunked(signed, valid, min_gap=1,
                                             pairs_per_call=6)
    tiles = tmatch.banded_pair_counts_chunked(signed, valid, min_gap=1,
                                              block=4)
    np.testing.assert_array_equal(dense, tiles)


def test_video_band_tiles_keeps_videos_apart(store):
    """The flat store and tile list of several sequences: every sequence
    padded to whole blocks, no tile pairs blocks of two sequences, and the
    tiles' counts are those of each sequence alone (a sequence beside it,
    even a copy of it, changes nothing)."""
    signed, valid = (torch.from_numpy(a) for a in store)
    videos = torch.stack([signed, signed.flip(0), signed])
    vvalid = torch.stack([valid, valid.flip(0), valid])
    block, gap = 4, 2
    packed, vflat, qidx, tidx, qb, tb = tmatch.video_band_tiles(
        videos, vvalid, gap, block)
    nb = -(-F // block)
    assert packed.shape == (3 * nb * block, N, 8) and vflat.shape == (
        3 * nb * block, N)
    assert not vflat.reshape(3, nb * block, N)[:, F:].any()
    assert [(q, t) for q, t in zip(qb.tolist(), tb.tolist())
            ] == tmatch.band_tiles(nb, block, gap)
    assert torch.equal(qidx // nb, tidx // nb)          # one sequence a tile
    assert torch.equal(qidx.reshape(3, -1) % nb, qb.expand(3, -1))
    assert torch.equal(tidx.reshape(3, -1) % nb, tb.expand(3, -1))
    got = tmatch.banded_pair_counts_videos(videos, vvalid, gap, block=block)
    for i in range(3):
        alone = tmatch.banded_pair_counts(videos[i], vvalid[i], gap,
                                          block=block)
        assert torch.equal(got[i], alone)
    assert torch.equal(got[0], got[2]) and int(got[0].max()) >= 10


def test_truncated_threshold_at_scale_1_5():
    """The pair route truncates ``min d1 * scale`` to an integer (the JAX
    per-pair path); the tile route compares in float32 (the JAX tile path).
    With min d1 = 21 and scale 1.5 a row at distance 31 is good for the
    float threshold 31.5 and not for the truncated 31. Each route follows
    its JAX counterpart."""
    q = np.ones((3, 256), np.int8)
    t = np.ones((3, 256), np.int8)
    t[0, :21] = -1                                    # d(q0, t0) = 21
    t[1, :31] = -1
    t[1, 100:110] = -1                                # far from q0 and t0
    q[1, 100:110] = -1                                # d(q1, t1) = 31
    q[2, :128] = -1
    t[2, 128:] = -1                                   # d(q2, t2) = 256
    # row 1's nearest target must be t1 at 31: t0 is 21 + 10 away
    valid = np.ones((2, 3), bool)
    signed = np.stack([t, q])                         # frame 1 queries frame 0
    args = (jnp.asarray(signed), jnp.asarray(valid))
    ref_pair = jmatch.dense_pair_counts_chunked(*args, scale=1.5, min_gap=1)
    ref_tile = np.asarray(jmatch.banded_pair_counts(*args, 1, 1.5))
    ts, tv = torch.from_numpy(signed), torch.from_numpy(valid)
    got_pair = tmatch.dense_pair_counts_chunked(ts, tv, scale=1.5, min_gap=1)
    got_tile = tmatch.banded_pair_counts_chunked(ts, tv, 1, 1.5, block=2)
    np.testing.assert_array_equal(got_pair, ref_pair)
    np.testing.assert_array_equal(got_tile, ref_tile)
    assert got_pair[1, 0] == 1 and got_tile[1, 0] == 2


@pytest.mark.parametrize("n", [300, 1001])
def test_tensor_core_identities(n):
    """What the tensor-core kernels compute, in torch on seeded words,
    against ``matching.hamming_matrix``: the +-1 dot is 256 - 2 d; the b1
    and-popc product gives d = popc(q) + popc(t) - 2 popc(q & t); a column
    that starts at -1024 (the +-1 form) or carries popc(t) + 512 (the b1
    form) reads d + 512; and the kernels' row rule on those numbers
    (maximum of 2 popc(q & t) - column term, popc(q) minus it, 2^30 from
    257 on) is the plain d1, with a fifth of the target rows invalid and
    with none valid."""
    rng = np.random.default_rng(n)
    m = 130
    pq = torch.from_numpy(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    pt = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32))
    pt[n // 2:n // 2 + 3] = pq[:3]                    # distance 0
    sq, st = tdesc.packed_to_signed(pq), tdesc.packed_to_signed(pt)
    d = tmatch.hamming_matrix(sq, st).to(torch.int64)            # [m, n]
    dot = sq.to(torch.int64) @ st.to(torch.int64).T
    assert torch.equal(256 - 2 * d, dot)
    assert torch.equal((256 - (dot - 1024)) // 2, d + 512)

    popq = tdesc.popcount32(pq).sum(-1)
    popt = tdesc.popcount32(pt).sum(-1)
    both = tdesc.popcount32(pq[:, None, :] & pt[None, :, :]).sum(-1)
    assert torch.equal(popq[:, None] + popt[None, :] - 2 * both, d)
    assert torch.equal(popq[:, None] + (popt + 512)[None, :] - 2 * both,
                       d + 512)
    assert torch.equal(
        cuda_kernels.hamming_tile_product(pq, pt).to(torch.int64),
        both[:64, :64])

    some = torch.from_numpy(rng.random(n) > 0.2)
    some[n // 2] = False                              # a duplicate, invalid
    for valid_t in (some, torch.zeros(n, dtype=torch.bool)):
        col = popt + 512 * (~valid_t)
        d1 = popq - torch.amax(2 * both - col[None, :], dim=1)
        d1 = torch.where(d1 < 257, d1, 2 ** 30).to(torch.int32)
        assert torch.equal(d1, cuda_kernels.hamming_nn_d1(pq, pt, valid_t))
    assert bool((d1 == 2 ** 30).all())
