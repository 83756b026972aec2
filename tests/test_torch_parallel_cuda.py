"""The port's sharded stages on the card at world size 1 over NCCL: every
test is marked ``cuda`` and skips where there is no CUDA device (the CPU
test run, where ``test_torch_parallel.py`` runs them on gloo ranks). On a
machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_parallel_cuda.py

A 1-rank mesh makes no point-to-point exchange; its collectives (all-gather,
all-reduce, broadcast) run through NCCL and the kernels are the card's.
The ring's counts and the front-end are bitwise the single-device route's,
RANSAC equal field by field; PGO and BA within the CPU tests' tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slam_loop_closing_tpu_torch.config import (BaConfig, LoopConfig,
                                                OrbConfig, PgoConfig,
                                                PipelineConfig, RansacConfig)
from slam_loop_closing_tpu_torch.models.loop_closing import LoopClosingSystem
from slam_loop_closing_tpu_torch.ops import ba, lie, matching, orb, pgo, ransac
from slam_loop_closing_tpu_torch.parallel import dryrun, sharded
from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = mesh_lib.make_mesh(device="cuda")
    assert dist.get_backend() == "nccl" and m.size == 1
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def frames():
    return np.asarray(orbit_sequence(num_frames=48, h=240, w=320,
                                     num_points=200), np.float32)


def test_frontend_sharded_bitwise(mesh, frames):
    cfg = OrbConfig(num_features=500, grid_cell=8)
    got = sharded.frontend_sharded(mesh, frames, cfg)
    ref = orb.detect_and_describe_batch(torch.from_numpy(frames).cuda(), cfg)
    for a, b in zip(got.keypoints, ref.keypoints):
        assert torch.equal(a, b)
    assert torch.equal(got.descriptors, ref.descriptors)
    assert torch.equal(got.signed, ref.signed)


def test_banded_loop_counts_equal_single_device(mesh, frames):
    cfg = OrbConfig(num_features=500, grid_cell=8)
    feats = orb.detect_and_describe_batch(torch.from_numpy(frames).cuda(), cfg)
    signed, valid = feats.signed, feats.keypoints.valid
    nfeat = torch.sum(valid, dim=1, dtype=torch.int32)
    gap = 12
    ref = matching.dense_pair_counts_chunked(signed, valid, min_gap=1)
    ring = sharded.ring_similarity_counts(mesh, signed, valid,
                                          min_gap=gap).cpu().numpy()
    f = ring.shape[0]
    q = np.arange(f)[:, None] // 8 * 8
    t = np.arange(f)[None, :] // 8 * 8
    computed = t <= q + 7 - gap
    np.testing.assert_array_equal(ring, np.where(computed, ref, 0))
    counts, sims = sharded.banded_loop_counts(mesh, signed, valid, nfeat, gap)
    band = np.arange(f)[None, :] <= np.arange(f)[:, None] - gap
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  np.where(band, ref, 0))
    ref_sims = matching.similarity(torch.from_numpy(np.where(band, ref, 0)),
                                   nfeat[:, None].cpu(), nfeat[None].cpu())
    assert torch.equal(sims.cpu(), torch.where(torch.from_numpy(band),
                                               ref_sims, 0.0))


def test_process_videos_sharded_equals_batched(mesh):
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=300),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=8, frame_skip=1))
    videos = np.stack([np.asarray(orbit_sequence(
        num_frames=24, h=144, w=192, num_points=200, seed=s), np.float32)
        for s in range(3)])
    got = sharded.process_videos_sharded(mesh, videos, cfg)
    assert any(got)
    assert got == LoopClosingSystem.process_videos_batched(videos, cfg,
                                                           device="cuda")


def test_verify_pairs_sharded_equals_single(mesh):
    rng = np.random.default_rng(1)
    p, n = 16, 300
    x1 = torch.tensor(rng.uniform(-0.5, 0.5, (p, n, 2)), dtype=torch.float32)
    R = lie.so3_exp(torch.tensor([0.02, -0.04, 0.01]))
    X = torch.cat([x1, torch.ones(p, n, 1)], -1) * torch.tensor(
        rng.uniform(4, 9, (p, n, 1)), dtype=torch.float32)
    Xc = X @ R.T + torch.tensor([-1.0, 0.05, 0.02])
    x2 = Xc[..., :2] / Xc[..., 2:]
    x2[:, : n // 4] += torch.tensor(rng.normal(0, 0.1, (p, n // 4, 2)),
                                    dtype=torch.float32)
    mask = torch.tensor(rng.random((p, n)) > 0.1)
    x1, x2, mask = x1.cuda(), x2.cuda(), mask.cuda()
    cfg = RansacConfig(num_hypotheses=256)
    g1, g2 = (torch.Generator(device="cuda") for _ in range(2))
    g1.manual_seed(3)
    g2.manual_seed(3)
    ref = ransac.estimate_essential_ransac_pairs(x1, x2, mask, g1, 300.0, cfg)
    got = sharded.verify_pairs_sharded(mesh, x1, x2, mask, g2, 300.0, cfg)
    assert bool(ref.ok.all())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pgo_sharded_close_to_single(mesh, solver):
    rng = np.random.default_rng(2)
    k = 13
    params = torch.tensor(rng.normal(0, 0.1, (k, 6)), dtype=torch.float32,
                          device="cuda")
    g = pgo.build_trajectory_graph(
        params, 1, k - 1, lie.so3_exp(torch.tensor([0.05, -0.02, 0.01],
                                                   device="cuda")),
        torch.tensor([0.1, 0.0, -0.05], device="cuda"), 10.0)
    cfg = (PgoConfig() if solver == "dense"
           else PgoConfig(dense_solver_max_poses=0, cg_iterations=30))
    ref, costs_ref = pgo.optimize_pose_graph(params, g, cfg)
    got, costs = sharded.pgo_sharded(mesh, params, g, cfg)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(costs[-1], costs_ref[-1], rtol=1e-5, atol=0)


def test_ba_sharded_close_to_single(mesh):
    rng = np.random.default_rng(3)
    n_cam, n_pt = 6, 40
    dev = "cuda"
    pts = torch.tensor(rng.uniform(-1, 1, (n_pt, 3)) + [0, 0, 5],
                       dtype=torch.float32, device=dev)
    cams = torch.tensor(rng.normal(0, 0.05, (n_cam, 6)), dtype=torch.float32,
                        device=dev)
    K = torch.tensor([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], device=dev)
    oc, op = (torch.tensor(a.ravel(), device=dev) for a in np.meshgrid(
        np.arange(n_cam), np.arange(n_pt), indexing="ij"))
    uv = ba._project_params(K, cams[oc], pts[op])
    uv = uv + torch.tensor(rng.normal(0, 0.5, tuple(uv.shape)),
                           dtype=torch.float32, device=dev)
    obs = ba.Observations(oc.int(), op.int(), uv,
                          torch.ones(len(oc), dtype=torch.bool, device=dev))
    noisy = pts + torch.tensor(rng.normal(0, 0.05, (n_pt, 3)),
                               dtype=torch.float32, device=dev)
    ref = ba.alternating_ba(K, cams, noisy, obs, None, BaConfig())
    got = sharded.ba_sharded(mesh, K, cams, noisy, obs, None, BaConfig())
    torch.testing.assert_close(got[0], ref[0], atol=5e-3, rtol=0)
    torch.testing.assert_close(got[1], ref[1], atol=5e-2, rtol=5e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=0)


def test_dryrun_world_size_1(mesh, capsys):
    s = dryrun.dryrun_multichip(1, device="cuda")
    assert s["loop_found"] and s["keyframes"] >= 5
    assert capsys.readouterr().out.strip() == dryrun.summary_line(s)
