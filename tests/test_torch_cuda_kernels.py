"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no CUDA
device (the CPU test run); on a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py

(``--noconftest``: the tests' conftest configures JAX, which this file does
not use.) Integer outputs, the FAST score and the blur are bitwise equal;
so are the nearest-neighbour (D), top-2 (F), motion-support (E) and
frame-pair count (K5) and d1-only nearest-neighbour (I) kernels, the SIFT
octave kernel (H) in both modes, the pyramid level (J) and the
orientation moments (M), and the ORB front-end across batch sizes (F9),
and the squared-L2 top-2 kernel (G) on integer-valued descriptors (on real
ones its dot products sum in another order than cuBLAS's: distances within
1e-5). So are the pyramid kernel's float32 mode (the SIFT octave halving)
and the SIFT front-end across chunk sizes (R17), and the fixed-order
segment sum (N), with which BA and PGO give the same bits at every run
(F12).
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
from slam_loop_closing_tpu_torch.config import BaConfig, PgoConfig, SiftConfig
from slam_loop_closing_tpu_torch.ops import ba, lie, matching, orb, pgo, sift
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


@pytest.mark.parametrize("b,h,w", [(3, 37, 61), (3, 120, 160),
                                   (3, 625, 1111), (1, 1080, 1920),
                                   (2, 21, 50), (2, 540, 960),
                                   (2, 450, 800), (2, 313, 555)])
def test_fast_kernel_bitwise(dev, b, h, w):
    """Random 8-bit frames (a ragged tile edge, one frame at 1080p as the
    live path gives it, a frame narrower than one 64 x 16 tile, and the
    540x960 levels of ORB SfM and multi-video, odd widths included) and the
    same frames with flat regions (where the compass pre-test skips whole
    warps)."""
    rng = np.random.default_rng(h * w + b)
    u8 = rng.integers(0, 256, (b, h, w))
    u8[:, h // 3:2 * h // 3] = 128
    u8[:, :, w // 2:w // 2 + 9] = 200
    imgs = torch.from_numpy((u8 / 255.0).astype(np.float32)).to(dev)
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
    2100 crosses two 1024-row query slabs and several 512-row target
    chunks; n 8000 needs more than 48 KB of shared memory."""
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


@pytest.mark.parametrize("n", [300, 2000, 2500, 4000, 1531])
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
                                       (5, 1100, 3), (1000, 4000, 8)])
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


@pytest.mark.parametrize("m,n,pairs", [(70, 90, 5), (4000, 4000, 40),
                                       (2100, 1100, 3), (5, 8192, 1)])
def test_hamming_d1_kernel_bitwise(dev, m, n, pairs):
    """A query store and a target store indexed in place by a pair list:
    queries equal to targets, invalid target rows, an all-invalid target
    frame, query rows crossing 1024-row slabs, targets crossing 512-row
    chunks, and (few pairs) the target rows split over blocks."""
    rng = np.random.default_rng(m + n + pairs)
    sq = (rng.integers(0, 2, (6, m, 256)) * 2 - 1).astype(np.int8)
    st = (rng.integers(0, 2, (7, n, 256)) * 2 - 1).astype(np.int8)
    sq[:, :3] = st[0, :3]
    vt = torch.from_numpy(rng.random((7, n)) > 0.2).to(dev)
    vt[:, :3] = True
    vt[4] = False
    pq = desc_ops.signed_to_packed(torch.from_numpy(sq).to(dev))
    pt = desc_ops.signed_to_packed(torch.from_numpy(st).to(dev))
    qidx = torch.from_numpy(rng.integers(0, 6, pairs).astype(np.int32)).to(dev)
    tidx = torch.from_numpy(rng.integers(0, 7, pairs).astype(np.int32)).to(dev)
    tidx[0] = 0
    if pairs > 1:
        tidx[-1] = 4
    ref = ck.hamming_d1_pairs_plain(pq, pt, vt, qidx, tidx)
    # int64 pair lists as strided views of one [P, 2] tensor and strided
    # validity: converted copies must outlive the launch (F4)
    q64, t64 = torch.stack([qidx, tidx], 1).long().T
    before = ck.LAUNCHES["hamming_d1"]
    for valid_t, qi, ti in ((vt, qidx, tidx), (_strided(vt), q64, t64)):
        assert torch.equal(ck.hamming_d1_pairs(pq, pt, valid_t, qi, ti), ref)
    assert ck.LAUNCHES["hamming_d1"] == before + 2
    assert (ref[0, :3] == 0).all()
    if pairs > 1:
        assert (ref[-1] == 2 ** 30).all()
    one = ck.hamming_nn_d1(pq[1], pt[2], vt[2])
    assert torch.equal(one, ck.hamming_nn_d1_plain(pq[1], pt[2], vt[2]))
    assert torch.equal(one, ck.hamming_nn(pq[1], torch.ones(m, dtype=torch.bool,
                                                            device=dev),
                                          pt[2], vt[2])[0])


def test_hamming_tile_product_on_card(dev):
    """The raw [64, 64] product of the tensor-core fragments, before any
    maximum: popc(q & t) of every row pair, and through it the distances of
    ``matching.hamming_matrix`` (a wrong fragment layout would still give
    plausible minima)."""
    rng = np.random.default_rng(64)
    words = rng.integers(0, 2 ** 32, (2, 70, 8), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    pq, pt = torch.from_numpy(words).to(dev)
    got = ck.hamming_tile_product(pq, pt)
    assert torch.equal(got, ck.hamming_tile_product_plain(pq, pt))
    pop = [desc_ops.popcount32(w[:64]).sum(-1) for w in (pq, pt)]
    d = matching.hamming_matrix(desc_ops.packed_to_signed(pq[:64]),
                                desc_ops.packed_to_signed(pt[:64]))
    assert torch.equal(pop[0][:, None] + pop[1][None, :] - 2 * got, d)


@pytest.mark.parametrize("n", [300, 1001, 1536, 2000, 4000])
def test_tensor_core_counts_bitwise(dev, n):
    """Kernels I, C and K5 on one store of ``n``-row frames (no multiple of
    a tile, a slab or a chunk among them) with a fifth of the rows invalid,
    a short frame, an empty frame, duplicated rows, a frame whose rows all
    have an even popcount and one where all are odd (the kernels stage
    target rows by that parity): a single pair and a long pair list (kernel
    I with its target rows split over blocks, and in one piece), the
    frame-pair counts, and 2 x 2 frame tiles."""
    rng = np.random.default_rng(n)
    f = 8
    words = rng.integers(0, 2 ** 32, (f, n, 8), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    parity = desc_ops.popcount32(torch.from_numpy(words)).sum(-1).numpy() & 1
    words[4, :, 0] ^= parity[4].astype(np.int32)          # all even
    words[7, :, 0] ^= 1 - parity[7].astype(np.int32)      # all odd
    words[6, :40] = words[1, :40]
    valid = rng.random((f, n)) > 0.2
    valid[3] = False                                  # an empty frame
    valid[5, n // 10:] = False                        # a short frame
    valid[6, :40] = valid[1, :40] = True
    packed = torch.from_numpy(words).to(dev)
    vt = torch.from_numpy(valid).to(dev)

    one = torch.tensor([6], dtype=torch.int32, device=dev)
    few_q, few_t = one, torch.tensor([1], dtype=torch.int32, device=dev)
    many_q = torch.arange(f, dtype=torch.int32, device=dev).repeat_interleave(f).repeat(6)
    many_t = torch.arange(f, dtype=torch.int32, device=dev).repeat(f * 6)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    def d1_splits(p_cnt):
        return ck._target_splits(p_cnt * -(-n // ck._D1_SLAB),
                                 ck._D1_BLOCKS_PER_SM, n,
                                 ck._D1_MIN_SPLIT_ROWS, sms)

    assert d1_splits(1) > 1
    assert d1_splits(many_q.shape[0]) == 1
    for qi, ti in ((few_q, few_t), (many_q, many_t)):
        d1 = ck.hamming_d1_pairs(packed, packed, vt, qi, ti)
        assert torch.equal(d1, ck.hamming_d1_pairs_plain(packed, packed, vt,
                                                         qi, ti))
        got = ck.pair_counts(packed, vt, qi, ti)
        assert torch.equal(got, ck.pair_counts_plain(packed, vt, qi, ti))
        assert torch.equal(got, matching.all_pairs_good_counts(packed, vt,
                                                               qi, ti))
    assert (d1[3] == 2 ** 30).all()                   # pair (0, 3): no target
    assert int(got[6 * f + 1]) >= 40 and int(got[3]) == 0

    tq, tt = torch.tensor([[0, 1], [2, 3], [3, 0], [1, 1]], dtype=torch.int32,
                          device=dev).T
    tiles = ck.band_count_tiles(packed, vt, tq, tt, 2)
    assert torch.equal(tiles, ck.band_count_tiles_plain(packed, vt, tq, tt, 2))
    assert tiles.max() > 0 and int(tiles[0, 1, 1]) == 0     # frame 3 targets


def test_dense_pair_counts_on_card_equal_cpu_and_tiles(dev):
    """The dense scan of a small sequence on the card: kernel I's route
    equals the CPU's and kernel C's tile route."""
    rng = np.random.default_rng(9)
    f, n = 21, 300
    signed = (rng.integers(0, 2, (f, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((f, n)) > 0.1
    valid[4] = False
    signed[20, :60] = signed[2, :60]
    valid[20, :60] = valid[2, :60] = True
    signed = torch.from_numpy(np.where(valid[..., None], signed, 0)
                              .astype(np.int8))
    valid = torch.from_numpy(valid)
    before = ck.LAUNCHES["hamming_d1"]
    got = matching.dense_pair_counts_chunked(signed.to(dev), valid.to(dev),
                                             min_gap=1, pairs_per_call=64)
    assert ck.LAUNCHES["hamming_d1"] == before + -(-(f * (f - 1) // 2) // 64)
    ref = matching.dense_pair_counts_chunked(signed, valid, min_gap=1,
                                             pairs_per_call=64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, matching.banded_pair_counts_chunked(
        signed.to(dev), valid.to(dev), 1))
    assert got[20, 2] >= 60
    one = matching.good_count_pair(
        desc_ops.signed_to_packed(signed[20]).to(dev), valid[20].to(dev),
        desc_ops.signed_to_packed(signed[2]).to(dev), valid[2].to(dev))
    assert int(one) == got[20, 2]


def test_process_videos_batched_on_card_equals_per_video(dev):
    """Three small videos through one front-end batch and one launch of the
    band-count kernel: each video's loops equal process_video's on it."""
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=300, num_levels=2),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=12, frame_skip=1))
    videos = np.stack([orbit_sequence(num_frames=20, h=144, w=192,
                                      num_points=250, seed=s)
                       for s in (3, 4, 5)])
    before = ck.LAUNCHES["band_count_tiles"]
    got = LoopClosingSystem.process_videos_batched(videos, cfg, device=dev)
    assert ck.LAUNCHES["band_count_tiles"] == before + 1
    for v in range(3):
        ref = LoopClosingSystem(cfg, max_frames=20, device=dev).process_video(
            videos[v])
        assert ref and got[v] == ref


@pytest.mark.parametrize("splits", [1, 3, 31])
def test_motion_support_kernel_forced_splits(dev, splits, monkeypatch):
    """One set of 2,000 matches with the target split forced: the counts
    add up to the plain version's at every split, the self-support -1 taken
    once; rows with NaN points and a set with every row masked out."""
    rng = np.random.default_rng(splits)
    xy = rng.normal(size=(2000, 2)).astype(np.float32)
    xy[7] = np.nan
    flow = (0.02 + 0.01 * rng.normal(size=(2000, 2))).astype(np.float32)
    xy, flow = torch.from_numpy(xy).to(dev), torch.from_numpy(flow).to(dev)
    monkeypatch.setattr(ck, "_target_splits", lambda *a: splits)
    for mask in (torch.from_numpy(rng.random(2000) > 0.1).to(dev),
                 torch.zeros(2000, dtype=torch.bool, device=dev)):
        got = ck.motion_support(xy, xy - flow, mask, 0.208, 0.0256)
        assert torch.equal(got, ck.motion_support_plain(xy, xy - flow, mask,
                                                        0.208, 0.0256))


def test_hamming_knn2_kernel_keyframe_pair(dev):
    """The keyframe step's single pair of 1,000 x 1,000 rows (the target
    rows split over blocks): duplicated targets, queries equal to targets,
    invalid rows on both sides, and the pair against an all-invalid
    frame."""
    rng = np.random.default_rng(1000)
    s = (rng.integers(0, 2, (3, 1000, 256)) * 2 - 1).astype(np.int8)
    s[1, 500:520] = s[1, 400:420]
    s[0, :20] = s[1, 400:420]
    v = torch.from_numpy(rng.random((3, 1000)) > 0.05).to(dev)
    v[1, 400:420] = v[1, 500:520] = v[0, :20] = True
    v[2] = False
    packed = desc_ops.signed_to_packed(torch.from_numpy(s).to(dev))
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for t in (zero + 1, zero + 2):
        got = ck.hamming_knn2(packed, v, packed, v, zero, t)
        ref = ck.hamming_knn2_plain(packed, v, packed, v, zero, t)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    d1, idx, d2 = (x[0].cpu() for x in ck.hamming_knn2(packed, v, packed, v,
                                                        zero, zero + 1))
    assert (d1[:20] == 0).all() and (d2[:20] == 0).all()
    assert (idx[:20] == torch.arange(400, 420)).all()
    assert torch.equal(d1 < 2 ** 30, v[0].cpu())


@pytest.mark.parametrize("splits", [2, 7])
def test_hamming_knn2_kernel_forced_splits(dev, splits, monkeypatch):
    """A loop-search pair list with the target split forced: the split
    merge keeps the lowest index on ties and d2 = d1 on duplicates."""
    rng = np.random.default_rng(splits)
    s = (rng.integers(0, 2, (6, 1000, 256)) * 2 - 1).astype(np.int8)
    s[:, 700:710] = s[:, 100:110]
    s[0, :10] = s[1, 100:110]
    v = torch.from_numpy(rng.random((6, 1000)) > 0.05).to(dev)
    v[:, 100:110] = v[:, 700:710] = True
    v[0, :10] = True
    v[3] = False
    packed = desc_ops.signed_to_packed(torch.from_numpy(s).to(dev))
    qidx = torch.tensor([0, 0, 2, 5, 4], dtype=torch.int32, device=dev)
    tidx = torch.tensor([1, 3, 1, 0, 2], dtype=torch.int32, device=dev)
    monkeypatch.setattr(ck, "_target_splits", lambda *a: splits)
    got = ck.hamming_knn2(packed, v, packed, v, qidx, tidx)
    ref = ck.hamming_knn2_plain(packed, v, packed, v, qidx, tidx)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    d1, idx, d2 = (t.cpu() for t in got)
    assert (d1[0, :10] == 0).all() and (d2[0, :10] == 0).all()
    assert (idx[0, :10] == torch.arange(100, 110)).all()
    assert (d1[1] == 2 ** 30).all() and (idx[1] == 0).all()


def test_hamming_knn2_kernel_split_sweep(dev, monkeypatch):
    """The keyframe pair and a 3-pair list at every split count from 1 to
    16 on three random stores, each launched twice in a row: the ticket of
    every slab must be back at zero for the second launch, and no split
    count may depend on which block merges."""
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        s = (rng.integers(0, 2, (3, 1000, 256)) * 2 - 1).astype(np.int8)
        s[1, 600:640] = s[1, 100:140]
        v = torch.from_numpy(rng.random((3, 1000)) > 0.1).to(dev)
        packed = desc_ops.signed_to_packed(torch.from_numpy(s).to(dev))
        for qi, ti in (([0], [1]), ([0, 2, 1], [1, 1, 2])):
            qidx, tidx = (torch.tensor(x, dtype=torch.int32, device=dev)
                          for x in (qi, ti))
            ref = ck.hamming_knn2_plain(packed, v, packed, v, qidx, tidx)
            for splits in range(1, 17):
                monkeypatch.setattr(ck, "_target_splits",
                                    lambda *a, n=splits: n)
                for _ in range(2):
                    got = ck.hamming_knn2(packed, v, packed, v, qidx, tidx)
                    assert all(torch.equal(g, r) for g, r in zip(got, ref))


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


def _l2_stores(rng, frames_q, n_q, frames_t, n_t, integer):
    """Descriptor stores with forced duplicate target rows (ties: d2 = d1
    at the lowest index), queries equal to targets, invalid rows scattered
    through every frame (valid rows not packed first), a query frame and a
    target frame whose rows past the middle are all invalid (extents below
    the row count), an all-invalid query frame (extent 0, the last but one)
    and an all-invalid target frame (the last): integer-valued, or unit-norm
    SIFT-like rows (non-negative, clipped at 0.2, renormalised)."""
    def rows(*shape):
        if integer:
            return rng.integers(0, 16, shape).astype(np.float32)
        d = rng.random(shape).astype(np.float32) ** 4
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = np.minimum(d, 0.2)
        return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32)

    q, t = rows(frames_q, n_q, 128), rows(frames_t, n_t, 128)
    t[:, n_t // 2:n_t // 2 + 3] = t[:, :3]
    q[:, :3] = t[0, :3]
    vq = rng.random((frames_q, n_q)) > 0.1
    vt = rng.random((frames_t, n_t)) > 0.1
    vt[:, :3] = vt[:, n_t // 2:n_t // 2 + 3] = True
    vq[1, n_q // 2 + 3:] = False
    vt[2, n_t // 2 + 3:] = False
    vq[-2] = False
    vt[-1] = False
    return q, vq, t, vt


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,pairs", [(4000, 1), (1000, 300), (70, 5),
                                     (1001, 1), (1001, 1176), (1536, 1),
                                     (1536, 1176)])
def test_l2_knn2_kernel(dev, n, pairs, integer):
    """Kernel G against its plain version over a pair list of the stores, in
    place: bitwise on integer-valued descriptors; on SIFT-like ones d1 and
    d2 within 1e-5 and idx equal away from near-ties. A keyframe-step pair
    at 4,000 rows, 300 loop-search pairs at 1,000, a small ragged case,
    rows that are no multiple of the kernel's tiles (1,001, and the SIFT
    run's 1,536) at one pair and at the loop search's 1,176; strided int64
    pair lists and validity (fault F4)."""
    rng = np.random.default_rng(n + pairs + integer)
    q, vq, t, vt = _l2_stores(rng, 6, n, 7, n - 3, integer)
    dq, dt = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    vq, vt = torch.from_numpy(vq).to(dev), torch.from_numpy(vt).to(dev)
    qidx = torch.from_numpy(rng.integers(0, 6, pairs).astype(np.int32)).to(dev)
    tidx = torch.from_numpy(rng.integers(0, 7, pairs).astype(np.int32)).to(dev)
    qidx[0], tidx[0] = 0, 0
    if pairs > 1:
        qidx[1:4] = torch.tensor([1, 4, 2], dtype=torch.int32)
        tidx[1:4] = torch.tensor([2, 1, 3], dtype=torch.int32)
        tidx[-1] = 6
    ref = ck.l2_knn2_plain(dq, vq, dt, vt, qidx, tidx)
    q64, t64 = torch.stack([qidx, tidx], 1).long().T
    for args in ((vq, vt, qidx, tidx), (_strided(vq), _strided(vt), q64, t64)):
        got = ck.l2_knn2(dq, args[0], dt, args[1], args[2], args[3])
        if integer:
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
            continue
        for g, r in (got[0], ref[0]), (got[2], ref[2]):
            assert float((g - r).abs().max()) < 1e-5
        tie = (ref[2] - ref[0]).abs() < 1e-5
        assert torch.equal(got[1][~tie], ref[1][~tie])
    d1, idx, d2 = (x.cpu() for x in got)
    ok0 = vq[int(qidx[0]), :3].cpu()
    # a query equal to a duplicated target: distance ~0, d2 = d1
    assert (d1[0, :3][ok0] < 1e-6).all()
    assert torch.equal(d2[0, :3][ok0], d1[0, :3][ok0])
    assert (idx[0, :3][ok0] == torch.arange(3)[ok0]).all()
    inv = ~vq[qidx.long()].cpu()
    assert (d1[inv] == 1e30).all() and (idx[inv] == 0).all()
    if pairs > 1:
        assert (d1[-1] == 1e30).all() and (d2[-1] == 1e30).all()
        assert (d1[2] == 1e30).all()          # the all-invalid query frame


@pytest.mark.parametrize("emit_resp", [True, False])
@pytest.mark.parametrize("b,h,w", [(2, 1080, 1920), (3, 135, 240),
                                   (1, 61, 77), (8, 540, 960),
                                   (8, 270, 480), (8, 135, 240)])
def test_gauss_stack_resp_kernel_bitwise(dev, b, h, w, emit_resp):
    """Kernel H against its plain version on blob texture (coarse noise
    upsampled): a 1080p octave 0, a small octave (1080p's octave 3), a
    ragged one, and octaves 1-3 of a chunk of 8 1080p frames (each its own
    blur tile height); the Gaussian stack and the gated response bitwise,
    one launch count a call."""
    rng = np.random.default_rng(h)
    coarse = torch.from_numpy(
        rng.random((b, h // 8 + 1, w // 8 + 1)).astype(np.float32)).to(dev)
    imgs = image_ops.resize_bilinear(coarse, h, w).contiguous()
    cfg = sift.SiftConfig()
    s = cfg.scales_per_octave
    sig = sift._chain_sigmas(s, cfg.sigma0)
    args = (imgs, sig, s, sift._contrast_threshold(cfg), cfg.edge_threshold)
    before = ck.LAUNCHES["gauss_stack_resp"]
    got = ck.gauss_stack_resp(*args, emit_resp=emit_resp)
    assert ck.LAUNCHES["gauss_stack_resp"] == before + 1
    ref = ck.gauss_stack_resp_plain(*args, emit_resp=emit_resp)
    assert torch.equal(got[0], ref[0])
    if emit_resp:
        assert torch.equal(got[1], ref[1]) and int((got[1] > 0).sum()) > 5
    else:
        assert got[1] is None and ref[1] is None


def _block_frames(rng, b, h, w):
    """[b, h, w] uint8 frames of 16-px blocks of random grey with 8-bit
    noise over them: corners at every block edge for FAST."""
    base = rng.integers(0, 256, (b, h // 16 + 1, w // 16 + 1))
    img = np.repeat(np.repeat(base, 16, 1), 16, 2)[:, :h, :w]
    return np.clip(img + rng.integers(-8, 9, (b, h, w)), 0, 255).astype(
        np.uint8)


@pytest.mark.parametrize("b,h,w", [(8, 1080, 1920), (1, 1080, 1920),
                                   (2, 540, 960), (2, 160, 120),
                                   (3, 37, 61), (2, 8, 40), (2, 40, 9),
                                   (2, 1079, 1917), (1, 1920, 1080),
                                   (2, 300, 2000)])
def test_pyramid_level_kernel_bitwise(dev, b, h, w):
    """Kernel J against its plain version down four pyramid levels at scale
    1.2 (1080p as 8 frames and as the live path's one, the 540x960 levels,
    portrait frames (columns first) up to 1080p, odd sizes, a footprint
    wider than a tile's staging covers at once, the max(8, ...) floor that
    keeps an axis as it is): both outputs bitwise, the first level from
    float32 frames, the later ones from the bfloat16 level before; one
    launch count a level."""
    rng = np.random.default_rng(h * w + b)
    x = image_ops.ship_frames(_block_frames(rng, b, h, w), dev)
    for lvl in range(1, 4):
        nh = max(8, int(round(h / 1.2 ** lvl)))
        nw = max(8, int(round(w / 1.2 ** lvl)))
        before = ck.LAUNCHES["pyramid_level"]
        got = ck.pyramid_level(x, nh, nw)
        assert ck.LAUNCHES["pyramid_level"] == before + 1
        ref = ck.pyramid_level_plain(x, nh, nw)
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        x = got[0]


@pytest.mark.parametrize("k", [1, 7, 2000, 192000])
def test_orient_moments_kernel_bitwise(dev, k):
    """Kernel M against its plain version: noise patches, rows of zeros
    (atan2(0, 0)), constant rows and invalid rows; up to config 2's 96 x
    2,000 keypoints of one batch."""
    gen = torch.Generator(device=dev).manual_seed(k)
    patches = torch.rand((k, 32, 32), generator=gen, device=dev)
    patches[::5] = 0.0
    patches[1::7] = 0.25
    valid = torch.rand(k, generator=gen, device=dev) > 0.1
    mw = torch.from_numpy(orb._orientation_moment_weights()).to(dev)
    before = ck.LAUNCHES["orient_moments"]
    got = ck.orient_moments(patches, valid, mw)
    assert ck.LAUNCHES["orient_moments"] == before + 1
    assert torch.equal(got, ck.orient_moments_plain(patches, valid, mw))


@pytest.mark.parametrize("grid", [0, 8])
def test_front_end_batch_invariant_on_card(dev, grid):
    """F9's gate: the ORB front-end on the same 96 1080p frames at batch
    sizes 1, 8, 50 and 96, the batches concatenated: pyramid levels,
    keypoints, angles and packed descriptors bitwise equal."""
    rng = np.random.default_rng(96)
    frames = torch.from_numpy(_block_frames(rng, 96, 1080, 1920)).to(dev)
    cfg = OrbConfig(num_features=2000, grid_cell=grid)
    pattern = orb.brief_matrices(cfg, dev)
    runs = {}
    for batch in (1, 8, 50, 96):
        outs = []
        for s in range(0, 96, batch):
            imgs = image_ops.ship_frames(frames[s:s + batch], dev)
            f = orb.detect_and_describe_batch(imgs, cfg, pattern)
            kp = f.keypoints
            levels = image_ops.pyramid(imgs, cfg.num_levels, cfg.scale_factor)
            outs.append([lv[:, ::7, ::7] for lv in levels[1:]]
                        + [kp.xy, kp.valid, kp.response, kp.octave, kp.angle,
                           f.descriptors])
        runs[batch] = [torch.cat(parts) for parts in zip(*outs)]
    names = ["level 1", "level 2", "level 3", "xy", "valid", "response",
             "octave", "angle", "descriptors"]
    for batch in (8, 50, 96):
        for name, a, b in zip(names, runs[1], runs[batch]):
            assert torch.equal(a, b), f"{name} differs at batch {batch}"
    assert int(runs[1][4].sum()) > 96 * 1500


def test_hamming_nn_kernel_split_sweep(dev, monkeypatch):
    """Kernel D at the live shape (2,000 x 2,000) with the target split
    forced to every count from 1 to 16, each launched twice in a row (the
    tickets must be back at zero): duplicated targets (ties to the lowest
    index), queries equal to targets, invalid rows on both sides, a query
    whose only equal target is invalid, and no valid target at all."""
    rng = np.random.default_rng(2000)
    sq, st = _signed(rng, 2000), _signed(rng, 2000)
    st[1000:1040] = st[:40]
    sq[:40] = st[:40]
    st[1500] = sq[60]
    vq = torch.from_numpy(rng.random(2000) > 0.05).to(dev)
    vt = torch.from_numpy(rng.random(2000) > 0.05).to(dev)
    vq[:40] = vt[:40] = vt[1000:1040] = True
    vq[60], vt[1500] = True, False
    pq = desc_ops.signed_to_packed(torch.from_numpy(sq).to(dev))
    pt = desc_ops.signed_to_packed(torch.from_numpy(st).to(dev))
    none = torch.zeros_like(vt)
    refs = [ck.hamming_nn_plain(pq, vq, pt, v) for v in (vt, none)]
    d1, idx = (t.cpu() for t in refs[0])
    assert (d1[:40] == 0).all() and (idx[:40] == torch.arange(40)).all()
    assert int(d1[60]) > 0 and (refs[1][0] == 2 ** 30).all()
    for splits in range(1, 17):
        monkeypatch.setattr(ck, "_target_splits", lambda *a, n=splits: n)
        for v, ref in zip((vt, none), refs):
            for _ in range(2):
                got = ck.hamming_nn(pq, vq, pt, v)
                assert all(torch.equal(g, r) for g, r in zip(got, ref)), \
                    splits


@pytest.mark.parametrize("b,h,w", [(8, 1080, 1920), (1, 1080, 1920),
                                   (2, 61, 77), (2, 90, 50), (1, 1920, 1080),
                                   (3, 135, 241)])
def test_resize_f32_kernel_bitwise(dev, b, h, w):
    """Kernel J's float32 mode against its plain version down the SIFT
    octaves (1080p -> 540 -> 270 -> 135 and on), odd and portrait sizes:
    bitwise, one launch count a halving."""
    rng = np.random.default_rng(h + w + b)
    x = image_ops.ship_frames(_block_frames(rng, b, h, w), dev)
    while min(x.shape[1:]) >= 16:
        nh, nw = x.shape[1] // 2, x.shape[2] // 2
        before = ck.LAUNCHES["resize_f32"]
        got = ck.resize_f32(x, nh, nw)
        assert ck.LAUNCHES["resize_f32"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (b, nh, nw)
        assert torch.equal(got, ck.resize_f32_plain(x, nh, nw))
        x = got


def test_sift_front_end_batch_invariant_on_card(dev):
    """R17's gate on the SIFT path: SIFT-4000 (4 octaves, flat selection)
    on 8 1080p frames in chunks of 1, 4 and 8: keypoints, scales, angles,
    responses, validity and descriptors bitwise equal."""
    rng = np.random.default_rng(8)
    imgs = image_ops.ship_frames(_block_frames(rng, 8, 1080, 1920), dev)
    runs = [sift.detect_and_describe_batch(imgs, SiftConfig(
        num_features=4000, batch_chunk=c)) for c in (1, 4, 8)]
    assert int(runs[0].valid.sum()) > 8 * 1000
    for c, other in zip((4, 8), runs[1:]):
        for name, a, b in zip(runs[0]._fields, runs[0], other):
            assert torch.equal(a, b), f"{name} differs at chunk {c}"


SEGMENT_WIDTHS = {1: (), 3: (3,), 6: (6,), 9: (3, 3), 36: (6, 6),
                  42: (6, 7)}
# kernel N's forms, by the plan's threshold (``SHORT_ROWS`` when the plan
# is built): by segment length (the library's), every non-empty segment
# long (a block each), every segment short (a thread a chain, a 5,000-row
# segment in batches)
SEGMENT_FORMS = {"by length": ck.SHORT_ROWS, "all long": 0,
                 "all short": 2 ** 30}
SEGMENT_CASES = ["random", "empty segments", "one long segment", "permuted",
                 "camera of 5,000 rows", "10,000 segments of degree 2"]


def _segment_case(rng, case: str):
    """(index, segments) of one segment-sum case (tests/
    test_torch_segment_sum.py's, and the card's sizes)."""
    n, e = 40, 2400
    if case == "random":
        return rng.integers(0, n, e), n
    if case == "empty segments":
        return rng.choice(np.flatnonzero(np.arange(n) % 3), e), n
    if case == "one long segment":
        idx = rng.integers(0, n, e)
        idx[rng.random(e) < 0.8] = n // 2
        return idx, n
    if case == "permuted":
        return rng.permutation(np.repeat(np.arange(n), e // n)), n
    if case == "camera of 5,000 rows":     # segment 95, rows scattered
        idx = rng.integers(0, 95, 20000)
        idx[rng.permutation(20000)[:5000]] = 95
        return idx, 96
    if case == "10,000 segments of degree 2":
        return rng.permutation(np.repeat(np.arange(10000), 2)), 10000
    raise ValueError(case)


def _spread(rng, e: int, d: int) -> torch.Tensor:
    """[e, d] float32 whose magnitudes span ~1e-6 .. 1e6, so that any other
    order of adds would show."""
    mag = np.exp(rng.normal(size=(e, 1)) * 5.0)
    return torch.from_numpy((rng.normal(size=(e, d)) * mag).astype(
        np.float32))


@pytest.mark.parametrize("form", SEGMENT_FORMS)
@pytest.mark.parametrize("case", SEGMENT_CASES)
@pytest.mark.parametrize("d", sorted(SEGMENT_WIDTHS))
def test_segment_sum_kernel_bitwise(dev, d, case, form, monkeypatch):
    """Kernel N against its plain version (and the plan built on the
    card against the CPU's): every float's bits; one launch count a
    call."""
    rng = np.random.default_rng(d)
    idx, n = _segment_case(rng, case)
    vals = _spread(rng, idx.shape[0], d).reshape(-1, *SEGMENT_WIDTHS[d])
    monkeypatch.setattr(ck, "SHORT_ROWS", SEGMENT_FORMS[form])
    plan = ck.segment_plan(torch.from_numpy(idx).to(dev), n)
    cpu = ck.segment_plan(torch.from_numpy(idx), n)
    for a, b in zip(plan[:4], cpu[:4]):
        assert torch.equal(a.cpu(), b)
    before = ck.LAUNCHES["segment_sum"]
    got = ck.segment_sum(vals.to(dev), plan)
    assert ck.LAUNCHES["segment_sum"] == before + 1
    ref = ck.segment_sum_plain(vals.to(dev), plan)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.cpu().view(torch.int32),
                       ck.segment_sum(vals, cpu).view(torch.int32))


@pytest.mark.parametrize("form", SEGMENT_FORMS)
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_sums_kernel_several_sums_two_sources(dev, case, form,
                                                      monkeypatch):
    """Three sums in one launch (BA's H and g and a width-1 sum; PGO's
    two-source gradient and diagonal), bitwise equal to the plain version
    of each, the two-source sums to ``torch.cat`` of their parts."""
    rng = np.random.default_rng(SEGMENT_CASES.index(case))
    idx, n = _segment_case(rng, case)
    e = idx.shape[0]
    monkeypatch.setattr(ck, "SHORT_ROWS", SEGMENT_FORMS[form])
    plan = ck.segment_plan(torch.from_numpy(idx).to(dev), n)
    a = _spread(rng, e, 36).reshape(e, 6, 6).to(dev)
    b = _spread(rng, e, 6).to(dev)
    c = _spread(rng, e, 1)[:, 0].to(dev)
    half = e // 2 + 1
    for sums in ((a, b, c), ((a[:half], a[half:]), (b[:3], b[3:]), c)):
        before = ck.LAUNCHES["segment_sum"]
        got = ck.segment_sums(plan, *sums)
        assert ck.LAUNCHES["segment_sum"] == before + 1
        for g, s in zip(got, sums):
            rows = torch.cat(s) if isinstance(s, tuple) else s
            ref = ck.segment_sum_plain(rows, plan)
            assert torch.equal(g.view(torch.int32), ref.view(torch.int32))


def test_segment_sum_kernel_signed_zeros_and_no_rows(dev, monkeypatch):
    """A segment of -0.0 rows sums to +0.0 in both forms, as index_add_
    from zeros; a plan of no rows gives zeros."""
    idx = torch.tensor([0, 0, 1, 1] + [2] * 40, device=dev)
    vals = torch.full((44, 6), -0.0, device=dev)
    vals[2] = 1.0
    for short in SEGMENT_FORMS.values():
        monkeypatch.setattr(ck, "SHORT_ROWS", short)
        plan = ck.segment_plan(idx, 3)
        got = ck.segment_sum(vals, plan)
        assert not torch.signbit(got).any()
        assert torch.equal(got.view(torch.int32), ck.segment_sum_plain(
            vals, plan).view(torch.int32))
    plan = ck.segment_plan(torch.zeros(0, dtype=torch.long, device=dev), 5)
    got = ck.segment_sums(plan, torch.zeros((0, 6), device=dev),
                          torch.zeros((0, 3, 3), device=dev))
    assert [g.shape for g in got] == [(5, 6), (5, 3, 3)]
    assert not any(g.any() for g in got)


def test_segment_sums_kernel_one_row_of_unit_stride(dev):
    """A sum of one row whose leading stride is not its width (``[1, 6]``
    of stride (1, 1), ``[1, 3, 3]`` of stride (1, 3, 1)): ``contiguous``
    returns it as it is, and the kernel still reads a whole row; alone and
    as the first part of a pair."""
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.randn((6, 1), generator=gen, device=dev).t()
    block = torch.randn((3, 3, 1), generator=gen, device=dev).permute(2, 0, 1)
    assert one.stride() == (1, 1) and block.stride() == (1, 3, 1)
    assert one.contiguous() is one and block.contiguous() is block
    plan = ck.segment_plan(torch.tensor([1], device=dev), 2)
    for rows in (one, block):
        got, = ck.segment_sums(plan, rows)
        ref = ck.segment_sum_plain(rows, plan)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(got[1], rows[0]) and not got[0].any()
    rest = torch.randn((3, 6), generator=gen, device=dev)
    plan = ck.segment_plan(torch.tensor([1, 0, 1, 1], device=dev), 2)
    got, = ck.segment_sums(plan, (one, rest))
    ref = ck.segment_sum_plain(torch.cat([one, rest]), plan)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _pose_graph(dev, n: int, loops: int, seed: int):
    """A noisy circle of ``n`` poses with sequential edges and ``loops``
    loop edges of weight 10 across half the circle (BASELINE config 5's
    construction)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    params = np.concatenate([np.zeros((n, 2)), ang[:, None],
                             50 * np.stack([np.cos(ang), np.sin(ang),
                                            np.zeros(n)], -1)], -1)
    clean = torch.tensor(params, dtype=torch.float32)
    params[1:] += rng.normal(0, 0.01, params[1:].shape)
    lid = rng.integers(n // 2, n, loops)
    ef = np.concatenate([np.arange(n - 1), lid - n // 2])
    et = np.concatenate([np.arange(1, n), lid])
    R, t = lie.params_to_pose(clean)
    R_rel, t_rel = lie.relative(R[ef], t[ef], R[et], t[et])
    g = pgo.PoseGraph(
        e_from=torch.tensor(ef, device=dev), e_to=torch.tensor(et, device=dev),
        R_rel=R_rel.to(dev), t_rel=t_rel.to(dev),
        weight=torch.tensor(np.where(et == ef + 1, 1.0, 10.0),
                            dtype=torch.float32, device=dev),
        mask=torch.ones(len(ef), dtype=torch.bool, device=dev))
    return torch.tensor(params, dtype=torch.float32, device=dev), g


@pytest.mark.parametrize("n,solver", [(60, "dense"), (3000, "pcg")])
def test_pgo_reproducible_on_card(dev, n, solver):
    """F12's gate for PGO: two runs of optimize_pose_graph on the card with
    no deterministic mode give the same bits (poses and costs)."""
    assert not torch.are_deterministic_algorithms_enabled()
    params, g = _pose_graph(dev, n, n // 100 + 2, seed=n)
    cfg = PgoConfig(dense_solver_max_poses=1500 if solver == "dense" else 0,
                    cg_iterations=50)
    runs = [pgo.optimize_pose_graph(params, g, cfg, 6) for _ in range(2)]
    assert float(runs[0][1][-1]) < 0.5 * float(runs[0][1][0])
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_ba_reproducible_on_card(dev):
    """F12's gate for BA: two runs of alternating_ba on the card with no
    deterministic mode, 96 cameras of about 1,000 observations each and
    30,000 points, give the same bits."""
    assert not torch.are_deterministic_algorithms_enabled()
    rng = np.random.default_rng(96)
    ncam, npts, per = 96, 30000, 1000
    K = torch.tensor([[768.0, 0, 480], [0, 768, 270], [0, 0, 1]], device=dev)
    truth = np.zeros((ncam, 6), np.float32)
    truth[:, 1] = np.linspace(-0.6, 0.6, ncam)
    truth[:, 3] = np.linspace(-3, 3, ncam)
    X = np.stack([rng.uniform(-6, 6, npts), rng.uniform(-3, 3, npts),
                  rng.uniform(8, 16, npts)], -1).astype(np.float32)
    cam = np.repeat(np.arange(ncam), per)
    pid = rng.integers(0, npts, cam.shape[0])
    perm = rng.permutation(cam.shape[0])
    cam, pid = cam[perm], pid[perm]
    R, t = lie.params_to_pose(torch.from_numpy(truth))
    Xc = (R[cam] @ torch.from_numpy(X[pid])[..., None])[..., 0] + t[cam]
    uv = (Xc[:, :2] / Xc[:, 2:]) * 768.0 + torch.tensor([480.0, 270.0])
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, uv.shape)).float()
    obs = ba.Observations(
        torch.from_numpy(cam.astype(np.int32)).to(dev),
        torch.from_numpy(pid.astype(np.int32)).to(dev), uv.to(dev),
        torch.from_numpy(rng.random(cam.shape[0]) > 0.05).to(dev))
    noisy = truth + rng.normal(0, 0.01, truth.shape).astype(np.float32)
    noisy[0] = truth[0]
    Xn = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    args = (K, torch.from_numpy(noisy).to(dev), torch.from_numpy(Xn).to(dev),
            obs, None, BaConfig(), 3)
    runs = [ba.alternating_ba(*args) for _ in range(2)]
    assert float(runs[0][2][-1]) < 1.0
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_ba_and_pgo_make_no_host_sync(dev):
    """BA (plans, sums, solves, acceptance) and PGO (dense and PCG) run on
    the card with no host sync: ``set_sync_debug_mode("error")`` raises at
    any."""
    rng = np.random.default_rng(5)
    ncam, npts, per = 12, 2000, 400
    K = torch.tensor([[768.0, 0, 480], [0, 768, 270], [0, 0, 1]], device=dev)
    truth = np.zeros((ncam, 6), np.float32)
    truth[:, 3] = np.linspace(-1, 1, ncam)
    X = np.stack([rng.uniform(-4, 4, npts), rng.uniform(-2, 2, npts),
                  rng.uniform(8, 12, npts)], -1).astype(np.float32)
    cam = np.repeat(np.arange(ncam), per)
    pid = rng.integers(0, npts, cam.shape[0])
    R, t = lie.params_to_pose(torch.from_numpy(truth))
    Xc = (R[cam] @ torch.from_numpy(X[pid])[..., None])[..., 0] + t[cam]
    uv = (Xc[:, :2] / Xc[:, 2:]) * 768.0 + torch.tensor([480.0, 270.0])
    obs = ba.Observations(
        torch.from_numpy(cam.astype(np.int32)).to(dev),
        torch.from_numpy(pid.astype(np.int32)).to(dev), uv.to(dev),
        torch.from_numpy(rng.random(cam.shape[0]) > 0.05).to(dev))
    cams = torch.from_numpy(truth + rng.normal(0, 0.01, truth.shape).astype(
        np.float32)).to(dev)
    pts = torch.from_numpy(X).to(dev)
    graphs = [(_pose_graph(dev, n, 3, seed=n),
               PgoConfig(dense_solver_max_poses=1500 if n < 100 else 0,
                         cg_iterations=10)) for n in (60, 600)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ba.alternating_ba(K, cams, pts, obs, None, BaConfig(), 2)
        pgo_out = [pgo.optimize_pose_graph(p, g, cfg, 3)
                   for (p, g), cfg in graphs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(out[2][-1]) < 1.0
    for p, costs in pgo_out:
        assert float(costs[-1]) < float(costs[0])
