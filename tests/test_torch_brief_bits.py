"""Rotated BRIEF at each keypoint's bin (kernel Q's plain version) on the
CPU: the pair table against the difference stack it replaces, the packed
and signed descriptors against the bf16 products of the port and of the
JAX package, the rule at differences below bf16's smallest normal, and the
front-end with either form of its pattern."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam_loop_closing_tpu import config as jconfig
from slam_loop_closing_tpu.ops import descriptors as jdesc
from slam_loop_closing_tpu.ops import orb as jorb
from slam_loop_closing_tpu.utils.synth_video import orbit_sequence
from slam_loop_closing_tpu_torch import config as tconfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import descriptors as tdesc
from slam_loop_closing_tpu_torch.ops import orb as torb
from slam_loop_closing_tpu_torch.utils import profiling

torch.set_num_threads(1)

STEP = np.float32(2 * np.pi / 30)
TINY = np.float32(2.0 ** -126)   # bf16's (and float32's) smallest normal


def pairs_read_off(D: np.ndarray) -> np.ndarray:
    """The (A, B) rows of each column's -1 and +1 of a [bins, P*P, 256]
    difference stack, (0, 0) for an all-zero column, by a loop."""
    bins, _, bits = D.shape
    out = np.zeros((bins, bits, 2), np.int16)
    for b in range(bins):
        for j in range(bits):
            col = D[b, :, j]
            if col.any():
                out[b, j] = (np.flatnonzero(col < 0)[0],
                             np.flatnonzero(col > 0)[0])
    return out


@pytest.mark.parametrize("seed,bins", [(17, 30), (5, 12)])
def test_brief_pairs_equal_the_stacks_columns(seed, bins):
    """The host-built table, the table read on the device from the port's
    stack, and the pairs read off the JAX package's stack are one table;
    the default pattern has pairs whose points share a pixel."""
    tc = tconfig.OrbConfig(pattern_seed=seed, brief_bins=bins)
    jc = jconfig.OrbConfig(pattern_seed=seed, brief_bins=bins)
    pairs = torb.brief_pairs(tc, "cpu")
    assert pairs.dtype == torch.int16 and pairs.shape == (bins, 256, 2)
    D = torb.brief_matrices(tc, "cpu")
    assert torch.equal(torb.brief_pairs_from_matrices(D), pairs)
    np.testing.assert_array_equal(
        pairs_read_off(np.asarray(jorb.brief_matrices(jc))), pairs.numpy())
    if (seed, bins) == (17, 30):
        assert int((pairs[..., 0] == pairs[..., 1]).sum()) > 0


def _gemm_route(patches, angle, valid, D):
    """The port's and the JAX package's bf16-product routes: (packed,
    signed) each."""
    bits = torb.brief_from_patches_binned(torch.from_numpy(patches),
                                          torch.from_numpy(angle),
                                          torch.from_numpy(valid),
                                          torch.from_numpy(D))
    port = (tdesc.bits_to_packed(bits),
            torch.where(torch.from_numpy(valid)[:, None],
                        tdesc.bits_to_signed(bits), 0).to(torch.int8))
    jbits = jorb.brief_from_patches_binned(
        jnp.asarray(patches), jnp.asarray(angle), jnp.asarray(valid),
        jnp.asarray(D))
    jax_packed = np.asarray(jdesc.bits_to_packed(jbits)).view(np.int32)
    jax_signed = np.where(valid[:, None],
                          np.asarray(jdesc.bits_to_signed(jbits)), 0)
    return port, (torch.from_numpy(jax_packed.copy()),
                  torch.from_numpy(jax_signed.astype(np.int8)))


def _case(rng, case: str, k: int = 600):
    """Patches, angles and validity of one edge case."""
    patches = rng.random((k, 32, 32)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, k).astype(np.float32)
    valid = np.ones(k, bool)
    half = (np.arange(-31, 32, dtype=np.float32) + 0.5) * STEP
    if case == "bin boundaries":
        # half steps either side of 0, negative angles, +-pi and 0
        edge = np.concatenate([half, np.float32([np.pi, -np.pi, 0.0, -0.0])])
        angle[:edge.size] = edge
    elif case == "half-step neighbours":
        # the float32 neighbours of each half step
        edge = np.concatenate([np.nextafter(half, np.float32(9)),
                               np.nextafter(half, np.float32(-9))])
        angle[:edge.size] = edge
    elif case == "equal pixels":
        # a few levels, so A and B often hold one value; values that differ
        # in float32 and round to one bf16
        patches = np.round(patches * 3) / 3
        patches[::2] += rng.integers(0, 2, patches[::2].shape) * 2.0 ** -12
        patches = patches.astype(np.float32)
    elif case == "shared pixel":
        # every row in a bin with a pair whose points share a pixel
        pairs = torb.brief_pairs(tconfig.OrbConfig(), "cpu").numpy()
        shared = np.flatnonzero((pairs[..., 0] == pairs[..., 1]).any(1))
        angle = (shared[rng.integers(0, shared.size, k)]
                 * STEP).astype(np.float32)
    elif case == "invalid rows":
        valid = rng.random(k) > 0.5
        valid[:3] = False
    return patches, angle, valid


@pytest.mark.parametrize("case", ["random", "bin boundaries",
                                  "half-step neighbours", "equal pixels",
                                  "shared pixel", "invalid rows"])
def test_brief_bits_plain_equals_the_products(rng, case):
    """Packed and signed descriptors bitwise equal to the bf16 products,
    the selects, ``bits_to_packed`` and ``bits_to_signed``, of the port and
    of the JAX package; invalid rows all zero. At the float32 neighbours of
    the half steps the port alone: XLA turns the JAX package's division by
    the step into a multiply by its reciprocal, which can round to the
    other side (R8), so its bins differ there."""
    patches, angle, valid = _case(rng, case)
    cfg = tconfig.OrbConfig()
    D = torb.brief_matrices(cfg, "cpu").numpy()
    packed, signed = ck.brief_bits(torch.from_numpy(patches),
                                   torch.from_numpy(angle),
                                   torch.from_numpy(valid),
                                   torb.brief_pairs(cfg, "cpu"))
    assert packed.dtype == torch.int32 and packed.shape == (len(valid), 8)
    assert signed.dtype == torch.int8 and signed.shape == (len(valid), 256)
    routes = _gemm_route(patches, angle, valid, D)
    for ref_packed, ref_signed in routes[:1 if "neighbours" in case else 2]:
        assert torch.equal(packed, ref_packed)
        assert torch.equal(signed, ref_signed)
    assert not packed[~torch.from_numpy(valid)].any()
    assert not signed[~torch.from_numpy(valid)].any()
    if case == "shared pixel":
        pairs = torb.brief_pairs(cfg, "cpu")
        bins = torb.brief_bins(torch.from_numpy(angle), 30)
        tie = (pairs[..., 0] == pairs[..., 1])[bins]
        assert tie.any() and (signed[tie] == -1).all()


def test_brief_bits_below_the_smallest_normal():
    """A pixel pair whose bf16 difference lies below bf16's smallest normal
    (2^-126): kernel Q and its plain version compare exactly, ``bf16(B) >
    bf16(A)``, as the card's bf16 product does (the card test). A CPU bf16
    product may flush instead: XLA's dot (the JAX package) reads subnormal
    operands as zero and flushes a subnormal difference, so its bit is
    ``flush(B) - flush(A) >= 2^-126``; the port's CPU product follows one
    rule or the other, as the CPU's bf16 instructions do (it flushes where
    they are AVX-512 BF16 or AMX). Outside that range, pixels 0 or at least
    2^-126 in size and 2^-126 apart (every real frame: a pixel is a
    weighted sum of multiples of 1/255), the rules agree."""
    vals = np.float32([0.0, TINY, TINY * (1 + 2 ** -7), TINY * (1 + 2 ** -6),
                       2 * TINY, TINY / 2, TINY / 4, TINY * 0.75, 1e-39,
                       -1e-39, 1e-38, 1.2e-38, -TINY, -TINY * (1 + 2 ** -7),
                       -2 * TINY, 1e-37, 0.5])
    a, b = (v.ravel() for v in np.meshgrid(vals, vals, indexing="ij"))
    k = a.size
    D = np.zeros((30, 4, 256), np.float32)
    D[:, 0, :] = -1.0   # point A at pixel 0, point B at pixel 1
    D[:, 1, :] = 1.0
    pairs = torb.brief_pairs_from_matrices(torch.from_numpy(D))
    patches = np.zeros((k, 32, 32), np.float32)
    patches[:, 0, 0], patches[:, 0, 1] = a, b
    angle = np.zeros(k, np.float32)
    valid = np.ones(k, bool)
    packed, _ = ck.brief_bits(torch.from_numpy(patches),
                              torch.from_numpy(angle),
                              torch.from_numpy(valid), pairs)
    got = (packed[:, 0] & 1).numpy()

    def bf16(x):
        return torch.from_numpy(x).bfloat16().float().numpy()

    def flush(x):
        return np.where(np.abs(x) < TINY, np.float32(0), x)

    exact = bf16(b) > bf16(a)
    flushed = (flush(bf16(b)) - flush(bf16(a))) >= TINY
    assert (exact != flushed).sum() > 10
    np.testing.assert_array_equal(got, exact)
    (port, _), (jax_route, _) = _gemm_route(patches[:, :2, :2], angle,
                                            valid, D)
    np.testing.assert_array_equal((jax_route[:, 0] & 1).numpy(), flushed)
    port_bit = (port[:, 0] & 1).numpy()
    assert (port_bit == flushed).all() or (port_bit == exact).all()
    real = ((np.abs(a) >= TINY) | (a == 0)) & ((np.abs(b) >= TINY) | (b == 0))
    real &= np.abs(bf16(b) - bf16(a)) >= TINY
    assert (exact[real] == flushed[real]).all()


def test_brief_bits_rejects_other_layouts():
    patches = torch.zeros((4, 32, 32))
    angle, valid = torch.zeros(4), torch.ones(4, dtype=torch.bool)
    pairs = torb.brief_pairs(tconfig.OrbConfig(), "cpu")
    for bad in (pairs.to(torch.int32), pairs[:, :128], pairs[0]):
        with pytest.raises(ValueError, match="pairs"):
            ck.brief_bits(patches, angle, valid, bad)
    with pytest.raises(ValueError, match="angle"):
        ck.brief_bits(patches, angle.double(), valid, pairs)
    with pytest.raises(ValueError, match="patches"):
        ck.brief_bits(patches[:, :16], angle, valid, pairs)


def test_front_end_pattern_forms_agree():
    """The pair table, the difference stack and no pattern give the same
    features; the describe span counts the rows it described."""
    frames = torch.from_numpy(orbit_sequence(num_frames=2, h=144, w=192,
                                             num_points=250, seed=5))
    cfg = tconfig.OrbConfig(num_features=300, num_levels=2)
    forms = [torb.brief_pairs(cfg, "cpu"), torb.brief_matrices(cfg, "cpu"),
             None]
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        feats = [torb.detect_and_describe_batch(frames, cfg, p)
                 for p in forms]
    for f in feats[1:]:
        for a, b in zip(feats[0], f):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
    assert int(feats[0].keypoints.valid.sum()) > 300
    describe = [r for r in profiling.spans()[before:]
                if r["name"] == "slam.orb.describe"]
    assert [r["counters"] for r in describe] == [{"keypoints": 600}] * 3
