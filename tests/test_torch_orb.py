"""The port's ORB front-end against the JAX package on the CPU: the patch
gather (plain version of its kernel), the numpy builders, orientation,
binned BRIEF and the whole batched front-end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu import config as jconfig
from slam_loop_closing_tpu.ops import orb as jorb
from slam_loop_closing_tpu.ops import pallas_kernels
from slam_loop_closing_tpu.utils.synth_video import orbit_sequence
from slam_loop_closing_tpu_torch import config as tconfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels
from slam_loop_closing_tpu_torch.ops import orb as torb

torch.set_num_threads(1)


def keypoints(rng, b, k, h, w, margin):
    return np.stack([rng.integers(margin, w - margin, (b, k)),
                     rng.integers(margin, h - margin, (b, k))],
                    -1).astype(np.float32)


@pytest.mark.parametrize("margin", [19, 0])
def test_extract_patches_bitwise(rng, margin):
    """Tolerance 0 (a copy), interior keypoints and clamped border ones,
    against the vmapped dynamic-slice gather and the TPU kernel in
    interpret mode."""
    imgs = rng.random((2, 96, 300)).astype(np.float32)
    xy = keypoints(rng, 2, 130, 96, 300, margin)
    got = cuda_kernels.extract_patches(torch.from_numpy(imgs),
                                       torch.from_numpy(xy)).numpy()
    for b in range(2):
        ref = jorb.extract_patches(jnp.asarray(imgs[b]), jnp.asarray(xy[b]))[0]
        np.testing.assert_array_equal(got[b], np.asarray(ref))
        ker = pallas_kernels.extract_patches_pallas(
            jnp.asarray(imgs[b]), jnp.asarray(xy[b]), interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(ker))


def test_extract_patches_sift_variant_and_centers(rng):
    """The 40/19 window the SIFT path uses, and the clamped centers."""
    imgs = rng.random((1, 104, 280)).astype(np.float32)
    xy = keypoints(rng, 1, 140, 104, 280, 0)
    got = cuda_kernels.extract_patches(torch.from_numpy(imgs),
                                       torch.from_numpy(xy), 40, 19).numpy()
    ker = pallas_kernels.extract_patches_pallas(
        jnp.asarray(imgs[0]), jnp.asarray(xy[0]), interpret=True, patch=40,
        center=19)
    np.testing.assert_array_equal(got[0], np.asarray(ker))
    _, centers = torb.extract_patches(torch.from_numpy(imgs),
                                      torch.from_numpy(xy))
    _, ref = jorb.extract_patches(jnp.asarray(imgs[0]), jnp.asarray(xy[0]))
    np.testing.assert_array_equal(centers[0].numpy(), np.asarray(ref))


def test_numpy_builders_bitwise():
    cfg = jconfig.OrbConfig()
    pat = torb.make_pattern(cfg.pattern_seed)
    np.testing.assert_array_equal(pat, jorb.make_pattern(cfg.pattern_seed))
    np.testing.assert_array_equal(torb._orientation_moment_weights(),
                                  jorb._orientation_moment_weights())
    np.testing.assert_array_equal(torb.make_brief_bin_matrices(pat, 30),
                                  jorb.make_brief_bin_matrices(pat, 30))
    np.testing.assert_array_equal(
        torb.brief_matrices(tconfig.OrbConfig(), "cpu").numpy(),
        np.asarray(jorb.brief_matrices(cfg)))
    for n, lv, s in [(2000, 4, 1.2), (300, 2, 1.2), (1000, 8, 1.3)]:
        assert torb._level_budgets(n, lv, s) == jorb._level_budgets(n, lv, s)


def test_orientation_and_binned_brief_on_same_patches(rng):
    """Same patches in: angles within 1e-4 rad (measured 4.7e-5 on these
    uniform-noise patches, whose moments nearly cancel; 8.3e-5 when the
    moments were one [K, 1024] @ [1024, 2] product): the moments sum in a
    pairwise tree, another order than XLA's. BRIEF bits from the same
    angles: bitwise."""
    patches = rng.random((300, 32, 32)).astype(np.float32)
    valid = rng.random(300) > 0.1
    mw = torb._orientation_moment_weights()
    ang = torb.orientation_from_patches(torch.from_numpy(patches),
                                        torch.from_numpy(valid),
                                        torch.from_numpy(mw))
    ref_ang = jorb.orientation_from_patches(jnp.asarray(patches),
                                            jnp.asarray(valid),
                                            jnp.asarray(mw))
    np.testing.assert_allclose(ang.numpy(), np.asarray(ref_ang), atol=1e-4,
                               rtol=0)
    D = np.asarray(jorb.brief_matrices(jconfig.OrbConfig()))
    bits = torb.brief_from_patches_binned(
        torch.from_numpy(patches), torch.tensor(np.asarray(ref_ang)),
        torch.from_numpy(valid), torch.tensor(D))
    ref_bits = jorb.brief_from_patches_binned(
        jnp.asarray(patches), ref_ang, jnp.asarray(valid), jnp.asarray(D))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))


def test_bins_round_half_even_floor_mod():
    """Angles on bin boundaries and negative angles: round half to even,
    floor modulo (jnp.round, jnp.mod)."""
    step = np.float32(2 * np.pi / 30)
    ang = np.array([-np.pi, -0.5 * step, 0.5 * step, 1.5 * step, -1.5 * step,
                    np.pi, 29.5 * step], np.float32)
    D = np.zeros((30, 4, 256), np.float32)
    for b in range(30):
        D[b, 0, b] = 1.0            # bit b set for rows in bin b
    patches = np.ones((len(ang), 2, 2), np.float32)
    bits = torb.brief_from_patches_binned(
        torch.from_numpy(patches), torch.from_numpy(ang),
        torch.ones(len(ang), dtype=torch.bool), torch.from_numpy(D)).numpy()
    ref = jorb.brief_from_patches_binned(
        jnp.asarray(patches), jnp.asarray(ang), jnp.ones(len(ang), bool),
        jnp.asarray(D))
    np.testing.assert_array_equal(bits, np.asarray(ref))


@pytest.fixture(scope="module")
def front_end_pair():
    frames = orbit_sequence(num_frames=4, h=144, w=192, num_points=250,
                            seed=3)
    out = {}
    for grid in (0, 8):
        jc = jconfig.OrbConfig(num_features=300, num_levels=2, grid_cell=grid)
        tc = tconfig.OrbConfig(num_features=300, num_levels=2, grid_cell=grid)
        ref = jax.tree.map(np.asarray, jorb.detect_and_describe_batch(
            jnp.asarray(frames), jc))
        out[grid] = (torb.detect_and_describe_batch(torch.from_numpy(frames),
                                                    tc), ref)
    return out


@pytest.mark.parametrize("grid", [0, 8])
def test_front_end_keypoints_identical(front_end_pair, grid):
    got, ref = front_end_pair[grid]
    kp = got.keypoints
    np.testing.assert_array_equal(kp.valid.numpy(), ref.keypoints.valid)
    np.testing.assert_array_equal(kp.xy.numpy(), ref.keypoints.xy)
    np.testing.assert_array_equal(kp.response.numpy(), ref.keypoints.response)
    np.testing.assert_array_equal(kp.octave.numpy(), ref.keypoints.octave)
    assert kp.valid.sum() > 500


@pytest.mark.parametrize("grid", [0, 8])
def test_front_end_descriptors_where_bins_agree(front_end_pair, grid):
    """Angles differ slightly (the blur's last bits, R2): a keypoint whose
    angle sits on a bin boundary may take the neighbouring bin. Bound: at
    most 1% of valid keypoints change bin (measured 0 of ~1000 here), angles
    within 1e-4 rad (measured 6.6e-5 with the moments' pairwise tree, 4.8e-5
    with the earlier matmul); every keypoint whose bin agrees has identical
    bits."""
    got, ref = front_end_pair[grid]
    valid = ref.keypoints.valid
    step = np.float32(2 * np.pi / 30)

    def bins(a):
        return np.mod(np.round(a / step).astype(np.int32), 30)

    same = (bins(got.keypoints.angle.numpy()) == bins(ref.keypoints.angle)) \
        & valid
    assert (valid & ~same).sum() <= 0.01 * valid.sum()
    np.testing.assert_allclose(got.keypoints.angle.numpy()[valid],
                               ref.keypoints.angle[valid], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.signed.numpy()[same], ref.signed[same])
    np.testing.assert_array_equal(
        got.descriptors.numpy()[same], ref.descriptors.view(np.int32)[same])
    assert not got.signed.numpy()[~valid].any()


@pytest.fixture(scope="module")
def one_frame():
    """One 120x160 orbit frame, its sigma-2 blur, and 120 of the JAX
    package's keypoints on it, a fifth marked invalid."""
    from slam_loop_closing_tpu.ops import image as jimage

    img = orbit_sequence(num_frames=2, h=120, w=160, seed=1)[0]
    feats = jorb.detect_and_describe(
        jnp.asarray(img), jconfig.OrbConfig(num_features=200, num_levels=2))
    xy = np.array(feats.keypoints.xy)[:120]
    valid = np.asarray(feats.keypoints.valid)[:120].copy()
    valid[::5] = False
    blurred = np.array(jimage.gaussian_blur(jnp.asarray(img), 2.0, 3))
    return img, blurred, xy, valid


def test_detect_and_describe_one_frame(one_frame):
    """One frame through ``detect_and_describe``: the JAX package's
    keypoints, angles within 1e-4 rad and descriptors wherever the
    orientation bin agrees, and the batch function's first entry."""
    img = one_frame[0]
    ref = jorb.detect_and_describe(
        jnp.asarray(img), jconfig.OrbConfig(num_features=200, num_levels=2))
    tcfg = tconfig.OrbConfig(num_features=200, num_levels=2)
    got = torb.detect_and_describe(torch.from_numpy(img), tcfg)
    assert got.descriptors.shape == (200, 8) and got.signed.shape == (200, 256)
    np.testing.assert_array_equal(got.keypoints.xy.numpy(),
                                  np.asarray(ref.keypoints.xy))
    np.testing.assert_array_equal(got.keypoints.valid.numpy(),
                                  np.asarray(ref.keypoints.valid))
    np.testing.assert_array_equal(got.keypoints.octave.numpy(),
                                  np.asarray(ref.keypoints.octave))
    np.testing.assert_allclose(got.keypoints.angle.numpy(),
                               np.asarray(ref.keypoints.angle), atol=1e-4,
                               rtol=0)
    step = 2 * np.pi / tcfg.brief_bins
    same_bin = (np.round(got.keypoints.angle.numpy() / step)
                == np.round(np.asarray(ref.keypoints.angle) / step))
    assert same_bin.mean() > 0.99
    np.testing.assert_array_equal(
        got.descriptors.numpy().view(np.uint32)[same_bin],
        np.asarray(ref.descriptors)[same_bin])
    batch = torb.detect_and_describe_batch(torch.from_numpy(img)[None], tcfg)
    assert torch.equal(batch.descriptors[0], got.descriptors)


def test_orientation_gather_form(one_frame):
    """Moments over the clamped circular window: within 1e-4 rad of the JAX
    package (sums in another order), 0 on invalid keypoints."""
    img, _, xy, valid = one_frame
    xy = np.concatenate([xy, [[0.0, 0.0], [159.0, 119.0]]]).astype(np.float32)
    valid = np.concatenate([valid, [True, True]])     # clamped windows
    ref = jorb.orientation(jnp.asarray(img), jnp.asarray(xy),
                           jnp.asarray(valid))
    got = torb.orientation(torch.from_numpy(img), torch.from_numpy(xy),
                           torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert not got.numpy()[~valid].any()


def test_exact_rotation_brief_bits_equal(one_frame):
    """``brief_descriptors`` (image-wide bilinear samples) and
    ``brief_from_patches`` (patch-local) at the same angles: the JAX
    package's bits, zero rows for invalid keypoints."""
    img, blurred, xy, valid = one_frame
    rng = np.random.default_rng(2)
    angle = rng.uniform(-np.pi, np.pi, len(xy)).astype(np.float32)
    pattern = jorb.make_pattern(0)
    t = torch.from_numpy
    ref = np.asarray(jorb.brief_descriptors(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle),
        jnp.asarray(valid), jnp.asarray(pattern)))
    got = torb.brief_descriptors(t(blurred), t(xy), t(angle), t(valid),
                                 t(pattern)).numpy()
    assert got.dtype == np.uint8 and ref.any()
    np.testing.assert_array_equal(got, ref)
    assert not got[~valid].any()

    patches, centers = jorb.extract_patches(jnp.asarray(blurred),
                                            jnp.asarray(xy))
    ref = np.asarray(jorb.brief_from_patches(
        patches, centers, jnp.asarray(angle), jnp.asarray(valid),
        jnp.asarray(pattern)))
    tp, tc = torb.extract_patches(t(blurred)[None], t(xy)[None])
    got = torb.brief_from_patches(tp[0], tc[0], t(angle), t(valid),
                                  t(pattern)).numpy()
    np.testing.assert_array_equal(got, ref)


def _rendered_patches(n):
    """``n`` 32x32 patches of a blurred orbit frame around random interior
    points, and the moment weights."""
    from slam_loop_closing_tpu_torch.ops import image as timage

    img = orbit_sequence(num_frames=2, h=120, w=160, seed=1)[0]
    blurred = timage.gaussian_blur(torch.from_numpy(img)[None], 2.0, 3)
    rng = np.random.default_rng(n)
    xy = keypoints(rng, 1, n, 120, 160, 19)
    return torb.extract_patches(blurred, torch.from_numpy(xy))[0][0]


@pytest.mark.parametrize("source", ["noise", "rendered"])
def test_moment_tree_against_matmul(rng, source):
    """Kernel M's plain moments (products rounded, a pairwise tree) against
    the [K, 1024] @ [1024, 2] float32 product they replace: within 1e-5 of
    the sum of the terms' magnitudes, the scale of their rounding (the
    moments of noise patches nearly cancel, so no bound relative to the
    moment itself holds)."""
    patches = (torch.from_numpy(rng.random((300, 32, 32)).astype(np.float32))
               if source == "noise" else _rendered_patches(300))
    mw = torch.from_numpy(torb._orientation_moment_weights())
    got = cuda_kernels.moment_sums_plain(patches, mw)
    flat = patches.reshape(300, -1)
    ref = flat @ mw
    scale = flat.abs() @ mw.abs()
    assert float(((got - ref).abs() / scale).max()) <= 1e-5
    ang = cuda_kernels.orient_moments(patches, torch.ones(300, dtype=bool), mw)
    assert torch.equal(ang, torch.atan2(got[:, 1], got[:, 0]))


@pytest.mark.parametrize("n", [40, 120])
def test_orient_moments_against_jax_orientation(one_frame, n):
    """Kernel M's plain version on 32x32 patches of the frame around
    interior keypoints against the JAX package's gather form ``orientation``
    (the same circular window): within 1e-4 rad, 0 on invalid rows."""
    img, _, xy, valid = one_frame
    xy, valid = xy[:n], valid[:n]
    patches = torb.extract_patches(torch.from_numpy(img)[None],
                                   torch.from_numpy(xy)[None])[0][0]
    got = cuda_kernels.orient_moments(
        patches, torch.from_numpy(valid),
        torch.from_numpy(torb._orientation_moment_weights())).numpy()
    ref = np.asarray(jorb.orientation(jnp.asarray(img), jnp.asarray(xy),
                                      jnp.asarray(valid)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert not got[~valid].any()
