"""The port's Version-A matching against the JAX package on the CPU: the
descriptor layouts, Hamming distances, per-block counts and the banded
counts (the plain version of the band-count kernel) against the XLA path
and both TPU band kernels in interpret mode. Counts are integers: every
comparison is bitwise."""

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
