"""Sharded pipeline stages on a :class:`.mesh.Mesh`: the data-parallel
front-end, the ring all-pairs similarity, video-parallel multi-video
detection, pair-parallel RANSAC verification, edge-parallel PGO,
observation-parallel BA, and the Version-B reconstruction built from them.

Port of :mod:`slam_loop_closing_tpu.parallel.sharded`. Every function takes
the global inputs on every rank and returns the global result on every
rank, as the JAX functions return global arrays: a rank cuts its shard
(:func:`.mesh.shard_leading`), runs the port's single-device code on it
(the same kernels: A, B, J and M in the front-end, K5 in the ring, C in the
videos, E and F in the keyframe pass), and the shards come back by
``all_gather`` or ``all_reduce``. The ring rotates packed descriptor blocks
with ``batch_isend_irecv``; a 1-rank mesh makes no point-to-point exchange
(``torch.distributed`` cannot send to its own rank, and nothing needs to).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from slam_loop_closing_tpu_torch.config import (BaConfig, OrbConfig,
                                                PgoConfig, PipelineConfig,
                                                RansacConfig)
from slam_loop_closing_tpu_torch.ops import ba, cuda_kernels, matching, orb
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops import outliers as outliers_ops
from slam_loop_closing_tpu_torch.ops import pgo, ransac
from slam_loop_closing_tpu_torch.ops.image import ship_frames
from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
from slam_loop_closing_tpu_torch.parallel.mesh import Mesh


def _gather(mesh: Mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """The global tensor of shard ``x``, cut to its first ``n`` rows (the
    padding dropped)."""
    return mesh_lib.gather_leading(mesh, x)[:n]


# ---------------------------------------------------------------------------
# DP front-end
# ---------------------------------------------------------------------------

def frontend_sharded(mesh: Mesh, frames, cfg: OrbConfig = OrbConfig(),
                     pattern: torch.Tensor | None = None) -> orb.OrbFeatures:
    """ORB over a frame batch split across the mesh: each rank runs
    :func:`..ops.orb.detect_and_describe_batch` on its block of the frames
    (padded with black frames to a multiple of the mesh size), then every
    field is gathered and the padding cut. The front-end's bits do not
    depend on its batch (kernels J and M fix the order of every sum), so
    the result equals the single-device call's."""
    frames, n = mesh_lib.pad_to_multiple(torch.as_tensor(frames), mesh.size)
    local = ship_frames(mesh_lib.shard_leading(mesh, frames), mesh.device)
    feats = orb.detect_and_describe_batch(local, cfg, pattern)
    kps = orb.Keypoints(*(_gather(mesh, a, n) for a in feats.keypoints))
    return orb.OrbFeatures(keypoints=kps,
                           descriptors=_gather(mesh, feats.descriptors, n),
                           signed=_gather(mesh, feats.signed, n))


# ---------------------------------------------------------------------------
# ring all-pairs similarity
# ---------------------------------------------------------------------------

def _band_step_pairs(fl: int, block: int, row0: int, col0: int,
                     min_gap: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(query row, target row) frame pairs of one ring step's banded tiles:
    every ``block x block`` tile (q, t) of the [fl, fl] step with
    ``col0 + t*block <= row0 + q*block + block - 1 - min_gap`` (the JAX
    ring's rule), query rows in ``[0, fl)``, target rows in ``[fl, 2 fl)``
    of the step's buffer."""
    nt = fl // block
    q, t = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")
    need = col0 + t * block <= row0 + q * block + block - 1 - min_gap
    q, t = q[need], t[need]
    a, b = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    qrow = (q[:, None] * block + a.ravel()[None, :]).ravel()
    trow = (t[:, None] * block + b.ravel()[None, :]).ravel() + fl
    return (torch.from_numpy(qrow.astype(np.int32)).to(device),
            torch.from_numpy(trow.astype(np.int32)).to(device))


def ring_similarity_counts(mesh: Mesh, signed, valid, scale: float = 2.0,
                           min_gap: int | None = None,
                           block: int = 8) -> torch.Tensor:
    """[F, F] int32 good-match counts by a ring exchange of descriptor
    blocks: entry (q, t) is the Version-A count of frame q against frame t.

    ``signed`` [F, N, 256] int8 (F divisible by the mesh size, and by mesh
    size x ``block`` when banded; pad first), ``valid`` [F, N] bool. Rank r
    keeps frames ``r*fl .. (r+1)*fl`` resident as packed words; at step i it
    counts them against the rotating block of rank ``(r - i) % d`` through
    ONE launch of the frame-pair count kernel (K5, over the step's pair
    list), then passes the rotating block to rank ``r + 1`` and takes the
    next from ``r - 1``; there is no exchange after the last step.

    With ``min_gap`` set, each step keeps only the ``block x block`` frame
    tiles that reach the loop band ``t <= q - min_gap`` (the JAX ring's
    rule); the others stay zero, so the matrix is bitwise the JAX one's,
    zeros included."""
    d, me = mesh.size, mesh.rank
    f = signed.shape[0]
    if f % d:
        raise ValueError(f"{f} frames do not split over {d} ranks; pad first")
    fl = f // d
    if min_gap is not None and fl % block:
        raise ValueError(f"per-rank block {fl} not divisible by tile {block}; "
                         "pad frames first")
    dev = mesh.device
    packed = desc_ops.signed_to_packed(mesh_lib.shard_leading(mesh, signed))
    val = mesh_lib.shard_leading(mesh, valid)
    # two buffers of [resident; rotating] rows: a step reads one while the
    # exchange fills the other's rotating half
    bufs = [(torch.cat([packed, packed]), torch.cat([val, val]))
            for _ in range(min(d, 2))]
    out = torch.zeros((fl, f), dtype=torch.int32, device=dev)
    if min_gap is None:
        rows = torch.arange(fl, dtype=torch.int32, device=dev)
        qidx, tidx = rows.repeat_interleave(fl), rows.repeat(fl) + fl
    for i in range(d):
        src = (me - i) % d          # whose frames the rotating block holds
        pk, vk = bufs[i % 2]
        if min_gap is not None:
            qidx, tidx = _band_step_pairs(fl, block, me * fl, src * fl,
                                          min_gap, dev)
        if qidx.numel():
            counts = cuda_kernels.pair_counts(pk, vk, qidx, tidx, scale)
            out[qidx.long(), src * fl + tidx.long() - fl] = counts
        if i + 1 < d:
            nk, nv = bufs[(i + 1) % 2]
            ops = [dist.P2POp(dist.isend, pk[fl:], mesh.peer(1)),
                   dist.P2POp(dist.isend, vk[fl:].view(torch.uint8),
                              mesh.peer(1)),
                   dist.P2POp(dist.irecv, nk[fl:], mesh.peer(-1)),
                   dist.P2POp(dist.irecv, nv[fl:].view(torch.uint8),
                              mesh.peer(-1))]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return mesh_lib.gather_leading(mesh, out)


def banded_loop_counts(mesh: Mesh, signed, valid, nfeat, min_gap: int,
                       scale: float = 2.0, block: int = 8):
    """Loop-detection scores from the ring matrix: good counts and
    similarities of every (curr, past) pair with ``past <= curr - min_gap``
    (README.md:119-126), zero elsewhere. Frames pad to a multiple of mesh
    size x ``block``. Returns ([F, F] int32 counts, [F, F] float32
    similarities) on the mesh's device."""
    f0 = signed.shape[0]
    m = mesh.size * block
    signed, _ = mesh_lib.pad_to_multiple(torch.as_tensor(signed), m)
    valid, _ = mesh_lib.pad_to_multiple(torch.as_tensor(valid), m)
    counts = ring_similarity_counts(mesh, signed, valid, scale,
                                    min_gap=min_gap, block=block)[:f0, :f0]
    band = matching._band_mask(f0, min_gap, mesh.device)
    counts = torch.where(band, counts, 0)
    nfeat = torch.as_tensor(nfeat).to(mesh.device)
    sims = matching.similarity(counts, nfeat[:, None], nfeat[None, :])
    return counts, torch.where(band, sims, 0.0)


# ---------------------------------------------------------------------------
# multi-video DP (BASELINE configs[2]: all videos at once)
# ---------------------------------------------------------------------------

def process_videos_sharded(mesh: Mesh, videos,
                           config: PipelineConfig | None = None):
    """Multi-video loop detection with the VIDEO axis split across the
    mesh: [V, B, H, W] (numpy or tensor, uint8 or float in [0, 1]) ->
    per-video loop lists, equal to
    ``LoopClosingSystem.process_videos_batched``. Each rank runs
    :func:`..models.loop_closing.videos_loop_scores` on its videos (padded
    with black videos to a multiple of the mesh size); the score matrices
    are gathered and the loop rule applied on the host."""
    from slam_loop_closing_tpu_torch.models import loop_closing as lc

    cfg = config or PipelineConfig()
    v0, b = videos.shape[:2]
    if b <= cfg.loop.min_loop_gap:
        return [[] for _ in range(v0)]
    videos, _ = mesh_lib.pad_to_multiple(torch.as_tensor(videos), mesh.size)
    counts, sims = lc.videos_loop_scores(
        mesh_lib.shard_leading(mesh, videos), cfg, mesh.device)
    counts, sims = lc._readback(
        {"s": (_gather(mesh, counts, v0), _gather(mesh, sims, v0))})["s"]
    return lc.loops_from_video_scores(counts, sims, cfg)


# ---------------------------------------------------------------------------
# Version-B backend: edge-/observation-parallel PGO and BA
# ---------------------------------------------------------------------------

def pgo_sharded(mesh: Mesh, params, g: pgo.PoseGraph,
                cfg: PgoConfig = PgoConfig(),
                num_iterations: int | None = None):
    """Pose-graph optimization with the EDGE axis split across the mesh
    (reference optimizePoseGraph, main.cpp:282-445): each rank assembles
    its edges' residuals, Jacobians and normal-equation blocks, and every
    partial sum (cost, gradient, Hessian blocks, each CG iteration's
    Hessian-vector product) is all-reduced before it is used, so every rank
    takes the same steps. The math of :func:`..ops.pgo.optimize_pose_graph`;
    partial sums change the order of float adds. Edges pad with mask=False
    rows (identity ``R_rel`` keeps ``so3_log`` finite). Returns (params,
    [iters + 1] costs)."""
    e = g.e_from.shape[0]
    pad = (-e) % mesh.size
    if pad:
        eye = torch.eye(3, dtype=g.R_rel.dtype, device=g.R_rel.device)
        g = pgo.PoseGraph(
            e_from=mesh_lib.pad_to_multiple(g.e_from, mesh.size)[0],
            e_to=mesh_lib.pad_to_multiple(g.e_to, mesh.size)[0],
            R_rel=torch.cat([g.R_rel, eye.expand(pad, 3, 3)]),
            t_rel=mesh_lib.pad_to_multiple(g.t_rel, mesh.size)[0],
            weight=mesh_lib.pad_to_multiple(g.weight, mesh.size)[0],
            mask=mesh_lib.pad_to_multiple(g.mask, mesh.size)[0])
    g = pgo.PoseGraph(*(mesh_lib.shard_leading(mesh, a) for a in g))
    return pgo.optimize_pose_graph(mesh_lib.replicated(mesh, params), g, cfg,
                                   num_iterations,
                                   reduce=mesh_lib.sum_reduction(mesh))


def ba_sharded(mesh: Mesh, K, cam_params, points, obs: ba.Observations,
               point_valid=None, cfg: BaConfig = BaConfig(),
               outer_iterations: int | None = None):
    """Alternating BA with the OBSERVATION axis split across the mesh
    (reference alternatingBundleAdjustment, main.cpp:905-943): each rank
    scatters its observations' counts, errors and 6x6 / 3x3 normal
    equations, and every partial sum is all-reduced before a step is taken,
    accepted or scored. The math of :func:`..ops.ba.alternating_ba`.
    Observations pad with valid=False rows. Returns (cam_params, points,
    [outer] mean reprojection errors)."""
    obs = ba.Observations(*(mesh_lib.pad_to_multiple(a, mesh.size)[0]
                            for a in obs))
    obs = ba.Observations(*(mesh_lib.shard_leading(mesh, a) for a in obs))
    if point_valid is not None:
        point_valid = mesh_lib.replicated(mesh, point_valid)
    return ba.alternating_ba(
        mesh_lib.replicated(mesh, K), mesh_lib.replicated(mesh, cam_params),
        mesh_lib.replicated(mesh, points), obs, point_valid, cfg,
        outer_iterations, reduce=mesh_lib.sum_reduction(mesh))


def _sfm_features_sharded(mesh: Mesh, pipe, frames):
    """``pipe._frontend(frames)`` with the frames split across the mesh:
    each rank detects its block, the feature bucket comes from the largest
    valid count of ANY frame (an all-reduce, so every rank cuts alike), and
    the cut features are gathered."""
    desc, xy, valid = pipe._frontend_detect(mesh_lib.shard_leading(
        mesh, torch.as_tensor(frames)))
    nv = mesh_lib.all_reduce_max(
        mesh, torch.amax(torch.sum(valid, dim=1, dtype=torch.int32)))
    feats = pipe._frontend_cut(desc, xy, valid, int(nv))
    return tuple(mesh_lib.gather_leading(mesh, a) for a in feats)


def sfm_reconstruct_sharded(mesh: Mesh, pipe, frames):
    """Version-B SfM with every shardable stage split across the mesh
    (reference main.cpp:1041-1685): the front-end over frames, then on
    every rank the serial keyframe pass on the gathered features and the
    loop search, then EDGE-sharded PGO, OBSERVATION-sharded alternating BA,
    outlier removal and the final BA (3 outer iterations). The staged
    single-device backend's math (``optimize``, ``bundle_adjust``,
    ``remove_outliers``, ``bundle_adjust``). ``pipe`` is an
    ``SfMPipeline`` on the mesh's device; the frame count must divide
    the mesh. Returns (state, {"e0", "e1", "ef", "e2", "loop_found",
    "keyframes"})."""
    if torch.empty(0, device=pipe.device).device != mesh.device:
        raise ValueError(f"the pipeline runs on {pipe.device}, the mesh on "
                         f"{mesh.device}")
    if frames.shape[0] % mesh.size:
        raise ValueError(f"{frames.shape[0]} frames do not split over "
                         f"{mesh.size} ranks for the front-end")
    feats = _sfm_features_sharded(mesh, pipe, frames)
    state, _ = pipe.run_frontend_and_keyframes_scan(frames, features=feats)
    loop = pipe.find_loop(state)

    k = int(state.kf_count)
    dev = mesh.device
    if loop.found:
        state, _ = pipe._loop_obs_append(state, loop)
        g = pgo.build_trajectory_graph(
            state.poses[:k], loop.past_kf, loop.curr_kf,
            torch.tensor(loop.R_rel, dtype=torch.float32, device=dev),
            torch.tensor(loop.t_rel, dtype=torch.float32, device=dev),
            pipe.config.pgo.loop_edge_weight)
        opt, _ = pgo_sharded(mesh, state.poses[:k], g, pipe.config.pgo)
        state = state._replace(poses=torch.cat([opt, state.poses[k:]]))

    pb = pipe._bucket(int(state.point_count) + 1, state.points.shape[0])
    nb = pipe._bucket(int(state.obs_count) + 1, state.obs_cam.shape[0])
    obs = ba.Observations(state.obs_cam[:nb], state.obs_point[:nb],
                          state.obs_uv[:nb], state.obs_valid[:nb])
    e0 = float(ba.mean_reprojection_error(pipe.K, state.poses, state.points,
                                          obs))
    cp, pts, errs1 = ba_sharded(mesh, pipe.K, state.poses, state.points[:pb],
                                obs, state.point_valid[:pb], pipe.config.ba)
    state = state._replace(poses=cp,
                           points=torch.cat([pts, state.points[pb:]]))

    k_mask = torch.arange(state.poses.shape[0], device=dev) < state.kf_count
    res = outliers_ops.remove_outliers(
        pipe.K, state.poses, k_mask, state.points[:pb],
        state.point_valid[:pb], obs, pipe.config.outlier)
    state = state._replace(
        point_valid=torch.cat([res.point_valid, state.point_valid[pb:]]),
        obs_valid=torch.cat([res.obs_valid, state.obs_valid[nb:]]))
    obs = obs._replace(valid=res.obs_valid)
    ef = float(ba.mean_reprojection_error(pipe.K, state.poses, state.points,
                                          obs))
    cp2, pts2, errs2 = ba_sharded(mesh, pipe.K, state.poses,
                                  state.points[:pb], obs,
                                  state.point_valid[:pb], pipe.config.ba,
                                  outer_iterations=3)
    state = state._replace(poses=cp2,
                           points=torch.cat([pts2, state.points[pb:]]))
    metrics = {"e0": e0, "e1": float(errs1[-1]), "ef": ef,
               "e2": float(errs2[-1]), "loop_found": loop.found,
               "keyframes": k}
    return state, metrics


# ---------------------------------------------------------------------------
# fanned-out pair verification
# ---------------------------------------------------------------------------

def verify_pairs_sharded(mesh: Mesh, x1, x2, mask,
                         generator: torch.Generator, focal,
                         cfg: RansacConfig = RansacConfig()
                         ) -> ransac.EssentialResult:
    """Batched essential-RANSAC verification of candidate pairs (the
    reference's sequential verify loop, main.cpp:1386-1418) with the PAIR
    axis split across the mesh: ``x1``, ``x2`` [P, N, 2], ``mask`` [P, N].
    Every rank draws the global [P, H, N] noise from ``generator`` (seeded
    alike on every rank), as :func:`..ops.ransac.estimate_essential_ransac_pairs`
    does, and verifies its slice of the pairs, so a pair's result does not
    depend on the mesh size. Pairs pad to a multiple of the mesh size;
    every field of the result is gathered."""
    p, n = x1.shape[:2]
    noise = ransac.gumbel_noise(generator, ransac.resolved_hypotheses(cfg),
                                n, (p,))

    def shard(x):
        x = mesh_lib.pad_to_multiple(torch.as_tensor(x), mesh.size)[0]
        return mesh_lib.shard_leading(mesh, x)

    x1, x2, mask, noise = (shard(a) for a in (x1, x2, mask, noise))
    if isinstance(focal, torch.Tensor):
        focal = focal.to(mesh.device)
    idx = ransac.sample_minimal_sets(noise, mask, cfg.min_points)
    res = ransac.essential_from_samples(x1, x2, mask, idx, focal, cfg)
    return ransac.EssentialResult(*(_gather(mesh, a, p) for a in res))
