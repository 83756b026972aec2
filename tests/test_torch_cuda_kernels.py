"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no CUDA
device (the CPU test run); on a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the tests' conftest configures JAX, which this file does
not use.) Integer outputs, the FAST score and the blur are bitwise equal;
so are the nearest-neighbour (D), top-2 (F), motion-support (E) and
frame-pair count (K5) kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu_torch.config import (CameraConfig, KeyframeConfig,
                                                LoopConfig, LoopVerifyConfig,
                                                OrbConfig, PipelineConfig,
                                                RansacConfig)
from slam_loop_closing_tpu_torch.models import sfm
from slam_loop_closing_tpu_torch.models.loop_closing import LoopClosingSystem
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import matching
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_ship_frames_on_card_equals_cpu(dev):
    """uint8 -> [0, 1] by true division on both devices (CUDA would turn a
    division by a host scalar into a reciprocal multiply)."""
    u8 = torch.arange(256, dtype=torch.uint8).reshape(16, 16)
    assert torch.equal(image_ops.ship_frames(u8, dev).cpu(),
                       image_ops.ship_frames(u8, "cpu"))


@pytest.mark.parametrize("h,w", [(37, 61), (120, 160), (625, 1111)])
def test_fast_kernel_bitwise(dev, h, w):
    rng = np.random.default_rng(h)
    imgs = torch.from_numpy(
        (rng.integers(0, 256, (3, h, w)) / 255.0).astype(np.float32)).to(dev)
    score, blur = ck.fast_score_nms_blur(imgs)
    ref_s, ref_b = ck.fast_score_nms_blur_plain(imgs)
    assert torch.equal(score, ref_s) and torch.equal(blur, ref_b)
    assert (score > 0).any()


def test_fast_kernel_refuses_other_radius(dev):
    with pytest.raises(ValueError):
        ck.fast_score_nms_blur(torch.zeros((1, 32, 32), device=dev),
                               blur_radius=2)


@pytest.mark.parametrize("patch,center", [(32, 15), (40, 19)])
def test_patch_kernel_bitwise(dev, patch, center):
    rng = np.random.default_rng(patch)
    imgs = torch.from_numpy(rng.random((2, 150, 230)).astype(np.float32)).to(dev)
    xy = np.stack([rng.integers(0, 230, (2, 500)),
                   rng.integers(0, 150, (2, 500))], -1).astype(np.float32)
    xy = torch.from_numpy(xy).to(dev)
    got = ck.extract_patches(imgs, xy, patch, center)
    assert torch.equal(got, ck.extract_patches_plain(imgs, xy, patch, center))


@pytest.mark.parametrize("n,block", [(40, 4), (2100, 2), (8000, 1)])
def test_band_kernel_bitwise(dev, n, block):
    """Random +-1 descriptors with an all-invalid frame and duplicates; n
    2100 crosses a 2048-row query pass and several 512-row target chunks;
    n 8000 needs more than 48 KB of shared memory."""
    rng = np.random.default_rng(n)
    f = 4 * block
    signed = (rng.integers(0, 2, (f, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((f, n)) > 0.2
    valid[1] = False
    signed[f - 1, :10] = signed[0, :10]
    valid[f - 1, :10] = valid[0, :10] = True
    signed = np.where(valid[..., None], signed, 0).astype(np.int8)
    packed = desc_ops.signed_to_packed(torch.from_numpy(signed).to(dev))
    vt = torch.from_numpy(valid).to(dev)
    pairs = [(q, t) for q in range(4) for t in range(4)]
    qidx, tidx = torch.tensor(pairs, dtype=torch.int32, device=dev).T
    got = ck.band_count_tiles(packed, vt, qidx, tidx, block)
    ref = ck.band_count_tiles_plain(packed, vt, qidx, tidx, block)
    assert torch.equal(got, ref) and got.max() > 0


def test_banded_counts_on_card_equal_cpu(dev):
    rng = np.random.default_rng(3)
    signed = torch.from_numpy(
        (rng.integers(0, 2, (37, 300, 256)) * 2 - 1).astype(np.int8))
    valid = torch.from_numpy(rng.random((37, 300)) > 0.1)
    signed = torch.where(valid[..., None], signed, 0).to(torch.int8)
    cpu = matching.banded_pair_counts(signed, valid, 5)
    card = matching.banded_pair_counts(signed.to(dev), valid.to(dev), 5)
    assert torch.equal(card.cpu(), cpu)


def test_process_video_on_card_equals_cpu(dev):
    """The 32-frame orbit fixture: the same loops on the card (kernels) as
    on the CPU (plain versions), through the batched path's kernels A, B
    and C."""
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=300, num_levels=2),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=20, frame_skip=1))
    frames = orbit_sequence(num_frames=32, h=144, w=192, num_points=250, seed=3)
    cpu = LoopClosingSystem(cfg, max_frames=32, device="cpu").process_video(
        frames)
    before = dict(ck.LAUNCHES)
    card = LoopClosingSystem(cfg, max_frames=32, device=dev).process_video(
        frames)
    assert all(ck.LAUNCHES[k] > before[k] for k in
               ("fast_score_nms_blur", "extract_patches", "band_count_tiles"))
    assert cpu
    assert [(c.current_frame_id, c.matched_frame_id) for c in card] == \
        [(c.current_frame_id, c.matched_frame_id) for c in cpu]


def _signed(rng, rows):
    return (rng.integers(0, 2, (rows, 256)) * 2 - 1).astype(np.int8)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """The values of ``t`` as a non-contiguous view."""
    return torch.stack([t, t], -1)[..., 0]


@pytest.mark.parametrize("m,n", [(70, 90), (2000, 2000), (5, 1100)])
def test_hamming_nn_kernel_bitwise(dev, m, n):
    """Duplicated targets (ties to the lowest index), invalid rows on both
    sides, target sets crossing 512-row chunks, and an all-invalid target
    set."""
    rng = np.random.default_rng(m + n)
    sq, st = _signed(rng, m), _signed(rng, n)
    st[n // 2:n // 2 + 3] = st[:3]
    sq[:3] = st[:3]
    vq = torch.from_numpy(rng.random(m) > 0.1).to(dev)
    vt = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    pq = desc_ops.signed_to_packed(torch.from_numpy(sq).to(dev))
    pt = desc_ops.signed_to_packed(torch.from_numpy(st).to(dev))
    # the last case passes strided validity: the wrapper's contiguous copies
    # must outlive the launch (F4)
    for valid_q, valid_t in ((vq, vt), (vq, torch.zeros_like(vt)),
                             (_strided(vq), _strided(vt))):
        d1, idx = ck.hamming_nn(pq, valid_q, pt, valid_t)
        ref_d1, ref_idx = ck.hamming_nn_plain(pq, vq, pt, valid_t)
        assert torch.equal(d1, ref_d1) and torch.equal(idx, ref_idx)


@pytest.mark.parametrize("n", [300, 2000, 2500])
def test_motion_support_kernel_bitwise(dev, n):
    rng = np.random.default_rng(n)
    xy = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)).to(dev)
    flow = torch.from_numpy(
        (0.02 + 0.01 * rng.normal(size=(n, 2))).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    got = ck.motion_support(xy, xy - flow, mask, 0.208, 0.0256)
    ref = ck.motion_support_plain(xy, xy - flow, mask, 0.208, 0.0256)
    assert torch.equal(got, ref) and int(got.max()) > 0


def test_pair_counts_kernel_bitwise(dev):
    """One query frame against a database prefix, in place, and the block
    form through matching.block_pair_counts."""
    rng = np.random.default_rng(5)
    f, n = 40, 700
    signed = (rng.integers(0, 2, (f, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((f, n)) > 0.1
    valid[4] = False
    signed[39, :60] = signed[2, :60]
    valid[39, :60] = valid[2, :60] = True
    signed = torch.from_numpy(np.where(valid[..., None], signed, 0)
                              .astype(np.int8)).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    packed = desc_ops.signed_to_packed(signed)
    tidx = torch.arange(30, dtype=torch.int32, device=dev)
    qidx = torch.full_like(tidx, 39)
    got = ck.pair_counts(packed, valid, qidx, tidx)
    assert torch.equal(got, ck.pair_counts_plain(packed, valid, qidx, tidx))
    assert int(got[2]) >= 60 and int(got[4]) == 0
    blocks = matching.block_pair_counts(signed[30:], valid[30:], signed[:8],
                                        valid[:8])
    assert torch.equal(blocks.cpu(), matching.block_pair_counts(
        signed[30:].cpu(), valid[30:].cpu(), signed[:8].cpu(),
        valid[:8].cpu()))


def test_process_frame_on_card_equals_cpu(dev):
    """The 32-frame orbit fixture frame by frame: the same loops on the card
    as on the CPU, through kernels A, B, D, E and K5."""
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=300, num_levels=2),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=20, frame_skip=1))
    frames = orbit_sequence(num_frames=32, h=144, w=192, num_points=250, seed=3)
    loops = {}
    for d in ("cpu", dev):
        sys_ = LoopClosingSystem(cfg, max_frames=32, log=lambda _: None,
                                 device=d)
        before = dict(ck.LAUNCHES)
        for _, _ in sys_.process_stream(frames):
            pass
        loops[str(d)] = [(c.current_frame_id, c.matched_frame_id,
                          c.num_matches) for c in sys_.get_loop_closures()]
    for k in ("fast_score_nms_blur", "extract_patches", "hamming_nn",
              "motion_support", "pair_counts"):
        assert ck.LAUNCHES[k] > before[k]
    assert loops["cpu"] and loops["cpu"] == loops[str(dev)]


@pytest.mark.parametrize("m,n,pairs", [(70, 90, 5), (1000, 1000, 300),
                                       (5, 1100, 3)])
def test_hamming_knn2_kernel_bitwise(dev, m, n, pairs):
    """A query store and a target store indexed in place by a pair list:
    duplicated targets (d2 = d1 ties), queries equal to targets, invalid
    rows on both sides, an all-invalid target frame, targets crossing
    512-row chunks."""
    rng = np.random.default_rng(m + n + pairs)
    sq = (rng.integers(0, 2, (6, m, 256)) * 2 - 1).astype(np.int8)
    st = (rng.integers(0, 2, (7, n, 256)) * 2 - 1).astype(np.int8)
    st[:, n // 2:n // 2 + 3] = st[:, :3]
    sq[:, :3] = st[0, :3]
    vq = torch.from_numpy(rng.random((6, m)) > 0.1).to(dev)
    vt = torch.from_numpy(rng.random((7, n)) > 0.1).to(dev)
    vt[:, :3] = True
    vt[:, n // 2:n // 2 + 3] = True
    vt[4] = False
    pq = desc_ops.signed_to_packed(torch.from_numpy(sq).to(dev))
    pt = desc_ops.signed_to_packed(torch.from_numpy(st).to(dev))
    qidx = torch.from_numpy(rng.integers(0, 6, pairs).astype(np.int32)).to(dev)
    tidx = torch.from_numpy(rng.integers(0, 7, pairs).astype(np.int32)).to(dev)
    tidx[0] = 0
    tidx[-1] = 4
    ref = ck.hamming_knn2_plain(pq, vq, pt, vt, qidx, tidx)
    # int64 pair lists as strided views of one [P, 2] tensor (as find_loop
    # builds them) and strided validity: converted copies must outlive the
    # launch (F4)
    q64, t64 = torch.stack([qidx, tidx], 1).long().T
    for args in ((vq, vt, qidx, tidx),
                 (_strided(vq), _strided(vt), q64, t64)):
        got = ck.hamming_knn2(pq, args[0], pt, args[1], args[2], args[3])
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    d1, idx, d2 = (t.cpu() for t in got)
    ok0 = vq[int(qidx[0]), :3].cpu()
    assert (d1[0, :3][ok0] == 0).all() and (d2[0, :3][ok0] == 0).all()
    assert (idx[0, :3][ok0] == torch.arange(3)[ok0]).all()
    assert (d1[-1] == 2 ** 30).all() and (d2[-1] == 2 ** 30).all()


def test_motion_support_kernel_batched_bitwise(dev):
    """A verification chunk: 32 match sets in one launch."""
    rng = np.random.default_rng(32)
    xy = torch.from_numpy(rng.normal(size=(32, 1000, 2)).astype(np.float32))
    flow = torch.from_numpy(
        (0.02 + 0.01 * rng.normal(size=(32, 1000, 2))).astype(np.float32))
    mask = torch.from_numpy(rng.random((32, 1000)) > 0.2)
    xy, flow, mask = xy.to(dev), flow.to(dev), mask.to(dev)
    got = ck.motion_support(xy, xy - flow, mask, 0.208, 0.0256)
    ref = ck.motion_support_plain(xy, xy - flow, mask, 0.208, 0.0256)
    assert torch.equal(got, ref) and int(got.max()) > 0


def test_sfm_on_card_equals_cpu(dev, monkeypatch):
    """The 24-frame SfM fixture (512 hypotheses) through SfMPipeline.run on
    the CPU and on the card, the CPU's minimal sets replayed on the card,
    through kernels A, B, E and F: the same keyframes and loop pair; the
    loop's inlier count within 3 and the map counts within 1% (a few points
    flip at the float Sampson and parallax gates: cuSOLVER's SVDs differ
    from LAPACK's in the last bits); reprojection errors before BA and
    final within 10% (0.8% measured; the maps differ by a few points)."""
    cfg = dataclasses.replace(
        PipelineConfig(),
        camera=CameraConfig(fx=153.6, fy=153.6, cx=96.0, cy=72.0, k1=0.0,
                            k2=0.0, p1=0.0, p2=0.0, k3=0.0),
        orb=OrbConfig(num_features=300, num_levels=2),
        keyframe=KeyframeConfig(min_median_displacement=2.0,
                                max_median_displacement=150.0,
                                min_tracked_features=40, min_inlier_ratio=0.3,
                                min_inliers=25),
        loop_verify=LoopVerifyConfig(min_matches=40, min_inliers=30,
                                     min_inlier_ratio=0.5,
                                     min_pose_inliers=15),
        ransac=RansacConfig(num_hypotheses=512))
    frames = orbit_sequence(num_frames=24, h=144, w=192, num_points=250, seed=5)
    drawn = []
    draw = sfm._minimal_sets

    def record(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    out = {}
    for d in ("cpu", dev):
        if d == dev:
            replay = iter(drawn)
            monkeypatch.setattr(sfm, "_minimal_sets",
                                lambda g, mask, *a: next(replay).to(
                                    mask.device))
        else:
            monkeypatch.setattr(sfm, "_minimal_sets", record)
        before = dict(ck.LAUNCHES)
        res = sfm.SfMPipeline(cfg, max_keyframes=32, max_points=8192,
                              max_obs=32768, log=lambda *a: None,
                              device=d).run(frames, write_obj=False)
        k = int(res.state.kf_count)
        out[str(d)] = (res.state.kf_frame[:k].cpu().tolist(),
                       (res.loop.curr_kf, res.loop.past_kf),
                       res.loop.num_inliers,
                       np.array([int(res.state.point_count),
                                 int(res.state.obs_count)]),
                       np.array([res.reproj_before_ba, res.reproj_final]))
    for name in ("fast_score_nms_blur", "extract_patches", "hamming_knn2",
                 "motion_support"):
        assert ck.LAUNCHES[name] > before[name]
    cpu, card = out["cpu"], out[str(dev)]
    assert cpu[1][0] >= 0 and cpu[:2] == card[:2]
    assert abs(cpu[2] - card[2]) <= 3
    np.testing.assert_allclose(card[3], cpu[3], rtol=0.01)
    np.testing.assert_allclose(card[4], cpu[4], rtol=0.1)
