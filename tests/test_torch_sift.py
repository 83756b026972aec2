"""The port's SIFT front-end against the JAX package, on the CPU.

The same numpy inputs go through both packages; the JAX functions run on
their XLA reference path (``use_pallas()`` is False on the CPU), the port's
through the plain versions of kernels H (Gaussian stack + gated DoG
response) and B (40x40 gradient windows).

Tolerances, float32 on both sides: the Gaussian stack within 2e-6 (XLA's
CPU build contracts the blur's tap chain into FMAs, the port does not:
ROADMAP R13), so fewer than 1e-4 of the gated responses may differ by more
than 1e-6 (a gate flipped at its threshold); of the JAX package's valid
keypoints at least 99% appear in the port at the same position (xy within
1e-3 px after the subpixel step: LAPACK's LU and XLA's solve round apart)
and scale (sigma within 1e-4 relative: XLA's and torch's float32 pow
differ), at least 99% of those with the same orientation, and their
descriptors within 1e-4 (the histogram sums run in another order).
Squared-L2 matching of real SIFT descriptors: d1 and d2 within 1e-5
relative, idx and mask equal away from ties and the ratio.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.config import SiftConfig as JSiftConfig
from slam_loop_closing_tpu.ops import image as jimage
from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import sift as jsift
from slam_loop_closing_tpu.utils.synth_video import orbit_sequence
from slam_loop_closing_tpu_torch.config import SiftConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels
from slam_loop_closing_tpu_torch.ops import matching as tmatch
from slam_loop_closing_tpu_torch.ops import sift as tsift
from slam_loop_closing_tpu_torch.utils import convert

torch.set_num_threads(1)

GAUSS_ATOL = 2e-6
XY_ATOL = 1e-3
SIGMA_RTOL = 1e-4
DESC_ATOL = 1e-4
L2_RTOL = 1e-5


@pytest.fixture(scope="module")
def blob_img():
    """test_pallas_kernels.py's fixture: coarse noise upsampled to 128x256,
    so DoG extrema at the detector's scales pass the contrast gate."""
    rng = np.random.default_rng(0)
    return np.array(jax.image.resize(
        jnp.asarray(rng.random((16, 32)), jnp.float32), (128, 256),
        "bilinear"))


def test_chain_sigmas_and_taps_equal_jax():
    """The chain's sigmas exactly; its float32 taps within 2 ulp (XLA's and
    torch's float32 exp round apart at the non-integer sigmas)."""
    sig = tsift._chain_sigmas(3, 1.6)
    assert sig == jsift._chain_sigmas(3, 1.6)
    for taps, s in zip(tsift.chain_taps(sig), sig):
        np.testing.assert_allclose(
            np.asarray(taps, np.float32),
            np.asarray(jimage.gaussian_kernel1d(s)), rtol=2.4e-7, atol=0)
    assert tsift._level_budgets(4000, 4) == jsift._level_budgets(4000, 4)


@pytest.mark.parametrize("emit_resp", [True, False])
def test_gauss_stack_resp_plain_equals_jax_xla(blob_img, emit_resp):
    """Kernel H's plain version against the JAX package's XLA pipeline
    (sift._gated_response, and sift._gaussian_stack for the gauss-only
    mode)."""
    cfg = JSiftConfig()
    s = cfg.scales_per_octave
    img = torch.from_numpy(blob_img)[None]
    if not emit_resp:
        ref_g = jsift._gaussian_stack(jnp.asarray(blob_img), s, cfg.sigma0)
        got_g = tsift._gaussian_stack(img, s, cfg.sigma0)
        assert got_g.shape == (1, s + 3, 128, 256)
        np.testing.assert_allclose(got_g[0].numpy(), np.asarray(ref_g),
                                   atol=GAUSS_ATOL)
        _, none = cuda_kernels.gauss_stack_resp(
            img, tsift._chain_sigmas(s, cfg.sigma0), s, emit_resp=False)
        assert none is None
        return
    ref_g, ref_r = jsift._gated_response(jnp.asarray(blob_img), cfg)
    got_g, got_r = tsift._gated_response(img, SiftConfig())
    assert got_r.shape == (1, s, 128, 256)
    np.testing.assert_allclose(got_g[0].numpy(), np.asarray(ref_g),
                               atol=GAUSS_ATOL)
    ref_r = np.asarray(ref_r)
    disagree = np.abs(got_r[0].numpy() - ref_r) > 1e-6
    assert disagree.mean() < 1e-4, f"{disagree.sum()} responses differ"
    assert (ref_r > 0).sum() > 50, "fixture produced too few extrema"
    # the border gate
    assert not got_r[..., :tsift._BORDER, :].any()
    assert not got_r[..., -tsift._BORDER:].any()


def test_extrema_and_edge_gates_equal_jax():
    """The gates on one DoG stack fed to both (no blur in between):
    the extremum map and the edge mask bitwise."""
    rng = np.random.default_rng(3)
    dog = (rng.normal(size=(5, 40, 50)) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(
        tsift._extrema_response(torch.from_numpy(dog)).numpy(),
        np.asarray(jsift._extrema_response(jnp.asarray(dog))))
    ok = tsift._edge_mask(torch.from_numpy(dog[1:4]), 10.0).numpy()
    ref = np.asarray(jsift._edge_mask(jnp.asarray(dog[1:4]), 10.0))
    # XLA may contract det's product into an FMA (R13): a rare flip
    assert (ok != ref).mean() < 1e-3 and ok.any() and not ok.all()


@pytest.fixture(scope="module")
def frames():
    return np.asarray(orbit_sequence(num_frames=3, h=144, w=192,
                                     num_points=250, seed=11), np.float32)


def _cfgs(grid):
    return (JSiftConfig(num_features=400, num_octaves=2, grid_cell=grid),
            SiftConfig(num_features=400, num_octaves=2, grid_cell=grid))


def _match_keypoints(xy_j, sig_j, v_j, xy_t, sig_t, v_t):
    """For each valid JAX keypoint (frame-major), the index of the port's
    valid keypoint of the same frame at the same position and scale
    (xy within XY_ATOL, sigma within SIGMA_RTOL), -1 where there is none."""
    out = np.full(v_j.shape, -1)
    for f in range(v_j.shape[0]):
        cand = np.flatnonzero(v_t[f])
        for i in np.flatnonzero(v_j[f]):
            dxy = np.abs(xy_t[f, cand] - xy_j[f, i]).max(axis=1)
            ds = np.abs(sig_t[f, cand] / sig_j[f, i] - 1.0)
            hit = cand[(dxy <= XY_ATOL) & (ds <= SIGMA_RTOL)]
            if hit.size:
                out[f, i] = hit[0]
    return out


@pytest.mark.parametrize("grid", [0, 4])
def test_detect_octave_equal_jax(frames, grid):
    """Octave 0 of three frames: at least 99% of JAX's keypoints at the
    same position and scale, responses within 1e-6, and the gradient
    maps: magnitude within 1e-6; angle (wrapped) times magnitude within
    2e-6, the gradient difference the stacks' 2e-6 allow (atan2 of
    near-zero gradients amplifies their last-bit differences)."""
    jcfg, tcfg = _cfgs(grid)
    budget = jsift._level_budgets(400, 2)[0]
    ref = jax.vmap(lambda im: jsift._detect_octave(im, 0, budget, jcfg))(
        jnp.asarray(frames))
    got = tsift._detect_octave(torch.from_numpy(frames), 0, budget, tcfg)
    xy_j, sig_j, val_j, v_j, mag_j, ang_j, _ = (np.asarray(a) for a in ref)
    xy_t, sig_t, val_t, v_t, mag_t, ang_t, _ = (a.numpy() for a in got)
    hit = _match_keypoints(xy_j, sig_j, v_j, xy_t, sig_t, v_t)
    assert v_j.sum() > 100
    assert (hit[v_j] >= 0).mean() >= 0.99
    f, i = np.nonzero(hit >= 0)
    np.testing.assert_allclose(val_t[f, hit[f, i]], val_j[f, i], atol=1e-6)
    np.testing.assert_allclose(mag_t, mag_j, atol=1e-6)
    dang = np.angle(np.exp(1j * (ang_t - ang_j).astype(np.float64)))
    assert (np.abs(dang) * mag_j).max() < 2e-6


@pytest.fixture(scope="module")
def features(frames):
    """detect_and_describe of the three frames by both packages, grid 0 and
    4: {grid: (JAX features as numpy, port features)}."""
    out = {}
    for grid in (0, 4):
        jcfg, tcfg = _cfgs(grid)
        ref = jax.vmap(lambda im: jsift.detect_and_describe(im, jcfg))(
            jnp.asarray(frames))
        out[grid] = (jax.device_get(ref), tsift.detect_and_describe_batch(
            torch.from_numpy(frames), tcfg))
    return out


@pytest.mark.parametrize("grid", [0, 4])
def test_detect_and_describe_equal_jax(features, grid):
    """Both octaves: at least 99% of JAX's keypoints at the same position
    and scale, at least 99% of those in the same orientation, and where it
    is the same, descriptors within 1e-4 (and L2-normalised)."""
    ref, got = features[grid]
    v_j = np.asarray(ref.valid)
    hit = _match_keypoints(np.asarray(ref.xy), np.asarray(ref.scale), v_j,
                           got.xy.numpy(), got.scale.numpy(),
                           got.valid.numpy())
    assert v_j.sum() > 150 and (hit[v_j] >= 0).mean() >= 0.99
    f, i = np.nonzero(hit >= 0)
    j = hit[f, i]
    same = got.angle.numpy()[f, j] == np.asarray(ref.angle)[f, i]
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.descriptors.numpy()[f[same], j[same]],
                               np.asarray(ref.descriptors)[f[same], i[same]],
                               atol=DESC_ATOL)
    d = got.descriptors.numpy()[got.valid.numpy()]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-3)
    assert not got.descriptors.numpy()[~got.valid.numpy()].any()


def test_batch_chunks_equal_single_frames(features, frames):
    """detect_and_describe_batch in chunks of 2 equals detect_and_describe
    frame by frame (and convert.sift_features carries JAX's features
    across with their dtypes)."""
    _, tcfg = _cfgs(4)
    batch = features[4][1]
    for f in range(3):
        one = tsift.detect_and_describe(torch.from_numpy(frames[f]), tcfg)
        for a, b in zip(one, batch):
            assert torch.equal(a, b[f])
    conv = convert.sift_features(features[4][0], "cpu")
    assert conv.descriptors.dtype == torch.float32
    assert conv.valid.dtype == torch.bool and conv.xy.shape == batch.xy.shape


def test_blank_frame_gives_no_keypoints():
    f = tsift.detect_and_describe(torch.zeros((128, 128)),
                                  SiftConfig(num_features=200,
                                             num_octaves=2))
    assert f.xy.shape == (200, 2) and f.descriptors.shape == (200, 128)
    assert not f.valid.any() and not f.descriptors.any()


def test_ratio_matches_l2_real_descriptors_equal_jax(features):
    """JAX's SIFT descriptors of frames 0 and 1 through both packages'
    squared-L2 ratio matching (the port's through kernel G's plain version,
    single pair and pair list): d1 and d2 within 1e-5 relative; idx and mask
    equal except on rows within 1e-5 of a tie or of the ratio."""
    ref_f, _ = features[0]
    dq, vq = np.array(ref_f.descriptors[0]), np.array(ref_f.valid[0])
    dt, vt = np.array(ref_f.descriptors[1]), np.array(ref_f.valid[1])
    k_ref = jmatch.knn2(jmatch.l2sq_matrix(jnp.asarray(dq), jnp.asarray(dt)),
                        jnp.asarray(vq), jnp.asarray(vt))
    m_ref = jmatch.ratio_matches_l2(jnp.asarray(dq), jnp.asarray(vq),
                                    jnp.asarray(dt), jnp.asarray(vt), 0.85)
    store = torch.from_numpy(np.array(ref_f.descriptors))
    valid = torch.from_numpy(np.array(ref_f.valid))
    one = torch.tensor([0], dtype=torch.int32)
    d1, idx, d2 = (a[0].numpy() for a in cuda_kernels.l2_knn2(
        store, valid, store, valid, one, one + 1))
    m = tmatch.ratio_matches_l2(torch.from_numpy(dq), torch.from_numpy(vq),
                                torch.from_numpy(dt), torch.from_numpy(vt),
                                0.85)
    r1, r2 = np.asarray(k_ref.d1), np.asarray(k_ref.d2)
    np.testing.assert_allclose(d1[vq], r1[vq], rtol=L2_RTOL, atol=1e-7)
    np.testing.assert_allclose(d2[vq], r2[vq], rtol=L2_RTOL, atol=1e-7)
    near = (np.abs(r2 - r1) <= L2_RTOL * r2) | (
        np.abs(r1 - 0.85 ** 2 * r2) <= L2_RTOL * r2)
    keep = vq & ~near
    assert keep.sum() > 50 and int(m_ref.count) > 5
    np.testing.assert_array_equal(idx[keep], np.asarray(k_ref.idx1)[keep])
    np.testing.assert_array_equal(m.mask.numpy()[keep],
                                  np.asarray(m_ref.mask)[keep])
    np.testing.assert_allclose(m.dist.numpy()[keep],
                               np.asarray(m_ref.dist)[keep], rtol=L2_RTOL,
                               atol=1e-7)
