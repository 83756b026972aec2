"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no CUDA
device (the CPU test run); on a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the tests' conftest configures JAX, which this file does
not use.) Integer outputs, the FAST score and the blur are bitwise equal;
so are the nearest-neighbour (D), motion-support (E) and frame-pair count
(K5) kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu_torch.config import (LoopConfig, OrbConfig,
                                                PipelineConfig)
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
    for valid_t in (vt, torch.zeros_like(vt)):
        d1, idx = ck.hamming_nn(pq, vq, pt, valid_t)
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
