"""The Version-B SfM pipeline: keyframing, essential-matrix odometry,
incremental triangulation with map-point merging, loop closure, pose-graph
optimization, alternating BA, outlier removal, OBJ export.

Port of :mod:`slam_loop_closing_tpu.models.sfm` (the reference's ``main()``,
main.cpp:1041-1685) for both detectors:

* the front-end runs batched over all frames up front: ORB in chunks of 8,
  SIFT in chunks of ``SiftConfig.batch_chunk``;
* the keyframe pass is one step function per frame over a fixed-capacity
  :class:`MapState` written in place on the device: every write is gated by
  the step's accept flag (inactive lanes go to the trash slots), and the
  step reads nothing back, so the host only enqueues;
* the loop search counts ratio matches of every candidate keyframe pair in
  one launch of a top-2 kernel (F on ORB's Hamming words, G on SIFT's
  float descriptors, :func:`_match_pairs`), then verifies candidates in
  chunks of 32 in one batched RANSAC pass each;
* the backend (PGO, alternating BA, outlier removal) is
  :mod:`..ops.pgo`, :mod:`..ops.ba` and :mod:`..ops.outliers`, read back
  once for its metrics.

Map state is fixed-capacity padded arrays with validity masks; the OBJ
writer drops invalid entries. Reference quirks kept (SURVEY.md section 7):
unit-norm relative translation chaining (main.cpp:1216-1219), a single
global best loop with gap = max(3, K/2) (main.cpp:1364), loop edge weight
10 (main.cpp:1468).

RANSAC draws its noise from ``torch.Generator`` objects seeded with 42
(keyframe pass) and 7 (loop search), as the JAX package seeds its keys; the
draws themselves differ (ROADMAP R4). :func:`_minimal_sets` is the one place
minimal sets are drawn, so tests can inject the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from slam_loop_closing_tpu_torch.config import PipelineConfig, PoseGraphMethod
from slam_loop_closing_tpu_torch.models.loop_closing import _readback
from slam_loop_closing_tpu_torch.ops import ba
from slam_loop_closing_tpu_torch.ops import camera as camera_ops
from slam_loop_closing_tpu_torch.ops import (epipolar, lie, matching, orb,
                                             outliers, pgo, ransac, sift,
                                             triangulation)
from slam_loop_closing_tpu_torch.ops.image import ship_frames
from slam_loop_closing_tpu_torch.utils import checkpoint as ckpt
from slam_loop_closing_tpu_torch.utils import io as io_utils

KEYFRAME_SEED = 42     # the JAX package's PRNGKey(42) of the keyframe pass
LOOP_SEED = 7          # and its PRNGKey(7) of the loop search
FRONTEND_CHUNK = 8     # frames per front-end call
VERIFY_CHUNK = 32      # loop candidates per verification pass


class MapState(NamedTuple):
    """Fixed-capacity global map (the parallel vectors of main.cpp:1098-1108
    as padded device tensors). The LAST slot of the point and observation
    arrays is a trash slot: inactive scatter lanes write there. The keyframe
    step writes the arrays in place."""

    kf_count: torch.Tensor     # int32 number of accepted keyframes
    kf_frame: torch.Tensor     # [K] int32 source frame index per keyframe
    poses: torch.Tensor        # [K, 6] world->camera params [rvec; t]
    kp_xy: torch.Tensor        # [K, N, 2] undistorted pixel keypoints
    kp_norm: torch.Tensor      # [K, N, 2] normalized coordinates
    kp_valid: torch.Tensor     # [K, N] bool
    desc: torch.Tensor         # [K, N, 8] int32 ORB words / [K, N, 128]
                               # float32 SIFT descriptors
    kp_to_point: torch.Tensor  # [K, N] int32 track table (-1 = none)
    points: torch.Tensor       # [P+1, 3] world points (last = trash)
    point_valid: torch.Tensor  # [P+1] bool
    point_count: torch.Tensor  # int32
    obs_cam: torch.Tensor      # [O+1] int32 keyframe index (last = trash)
    obs_point: torch.Tensor    # [O+1] int32
    obs_uv: torch.Tensor       # [O+1, 2] float32
    obs_valid: torch.Tensor    # [O+1] bool
    obs_count: torch.Tensor    # int32


class StepInfo(NamedTuple):
    """Per-frame diagnostics of the reference's printed counters
    (main.cpp:1202-1206, 1343-1346); behind-camera rejections count as
    depth (main.cpp:1283-1295)."""

    accepted: torch.Tensor        # bool keyframe accepted
    num_matches: torch.Tensor     # int32
    median_disp: torch.Tensor     # float32
    num_inliers: torch.Tensor     # int32
    n_triangulated: torch.Tensor  # int32 new points
    n_merged: torch.Tensor        # int32 observations added to existing points
    n_rej_parallax: torch.Tensor  # int32
    n_rej_reproj: torch.Tensor    # int32
    n_rej_depth: torch.Tensor     # int32


def init_map_state(max_keyframes: int, num_features: int, max_points: int,
                   max_obs: int, device, desc_dim: int = 8,
                   desc_dtype: torch.dtype = torch.int32) -> MapState:
    """``desc_dim``/``desc_dtype``: (8, int32) for ORB's packed words,
    (128, float32) for SIFT."""
    k, n = max_keyframes, num_features

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapState(
        kf_count=z((), torch.int32), kf_frame=z((k,), torch.int32),
        poses=z((k, 6), torch.float32), kp_xy=z((k, n, 2), torch.float32),
        kp_norm=z((k, n, 2), torch.float32), kp_valid=z((k, n), torch.bool),
        desc=z((k, n, desc_dim), desc_dtype),
        kp_to_point=torch.full((k, n), -1, dtype=torch.int32, device=device),
        points=z((max_points + 1, 3), torch.float32),
        point_valid=z((max_points + 1,), torch.bool),
        point_count=z((), torch.int32),
        obs_cam=z((max_obs + 1,), torch.int32),
        obs_point=z((max_obs + 1,), torch.int32),
        obs_uv=z((max_obs + 1, 2), torch.float32),
        obs_valid=z((max_obs + 1,), torch.bool),
        obs_count=z((), torch.int32))


def _bootstrap(state: MapState, xy, norm, valid, desc,
               frame_idx: int) -> MapState:
    """Frame ``frame_idx`` as keyframe 0 with the identity pose
    (main.cpp:1111-1132)."""
    state.kf_frame.narrow(0, 0, 1).fill_(frame_idx)
    state.kp_xy[0] = xy
    state.kp_norm[0] = norm
    state.kp_valid[0] = valid
    state.desc[0] = desc
    return state._replace(kf_count=torch.ones_like(state.kf_count))


def _support_radii(cfg: PipelineConfig) -> tuple[float, float]:
    """The PROSAC motion-support radius and tau in pixels, as the JAX
    package computes them in float32 from K: max(frac * 2 cx, floor)."""
    w_est = np.float32(2.0) * np.float32(cfg.camera.cx)
    radius = max(np.float32(cfg.match.motion_radius_frac) * w_est,
                 np.float32(24.0))
    tau = max(np.float32(cfg.match.motion_tau_frac) * w_est, np.float32(8.0))
    return float(radius), float(tau)


def _minimal_sets(generator: torch.Generator, mask: torch.Tensor,
                  quality: torch.Tensor, cfg) -> torch.Tensor:
    """[..., H, 8] RANSAC minimal sets for the matches ``mask`` [..., N]:
    Gumbel noise from ``generator``, PROSAC-progressive by ``quality``. The
    one place the pipeline draws random numbers: tests replace it to inject
    the JAX package's sampled sets."""
    noise = ransac.gumbel_noise(generator, ransac.resolved_hypotheses(cfg),
                                mask.shape[-1], tuple(mask.shape[:-1]))
    return ransac.sample_minimal_sets(noise, mask, cfg.min_points, quality)


def _match_pairs(desc_q: torch.Tensor, valid_q: torch.Tensor,
                 desc_t: torch.Tensor, valid_t: torch.Tensor,
                 qidx: torch.Tensor, tidx: torch.Tensor,
                 ratio: float) -> matching.Matches:
    """Detector-generic ratio matching of the frame pairs (``qidx[p]``,
    ``tidx[p]``) of two descriptor stores, keyed on the stores' dtype:
    Hamming top-2 (kernel F) on ORB's int32 words, squared-L2 top-2 with
    ``ratio**2`` (kernel G) on SIFT's float32 descriptors (main.cpp:509-534).
    The counterpart of the JAX package's ``_match_descriptors``."""
    if desc_q.dtype.is_floating_point:
        return matching.ratio_matches_l2_pairs(desc_q, valid_q, desc_t,
                                               valid_t, qidx, tidx, ratio)
    return matching.ratio_matches_hamming_pairs(desc_q, valid_q, desc_t,
                                                valid_t, qidx, tidx, ratio)


def _row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` ([1] index tensor) of ``arr``, selected on the device."""
    return arr.index_select(0, i)[0]


def _set_row(arr: torch.Tensor, i: torch.Tensor, val: torch.Tensor,
             accept: torch.Tensor) -> None:
    """Conditional in-place row write: ``arr[i] = val if accept``."""
    arr.index_copy_(0, i, torch.where(accept, val[None],
                                      arr.index_select(0, i)))


def _sfm_step(state: MapState, xy, norm, valid, desc, frame_idx: int,
              K: torch.Tensor, cfg: PipelineConfig,
              generator: torch.Generator):
    """One candidate frame through the keyframe gates and, if accepted, the
    map extension (the reference's hot loop #1, main.cpp:1138-1351). Writes
    ``state``'s arrays in place and returns (state, StepInfo); nothing is
    read back, so the host only enqueues."""
    kcfg = cfg.keyframe
    last = (state.kf_count - 1).reshape(1).long()
    last_xy = _row(state.kp_xy, last)
    last_norm = _row(state.kp_norm, last)

    # match the frame against the last keyframe (main.cpp:1154): a top-2
    # kernel over the one pair, the keyframe store indexed in place
    m = _match_pairs(desc[None], valid[None], state.desc, state.kp_valid,
                     torch.zeros_like(last), last, cfg.match.ratio_threshold)
    m = matching.Matches(*(a[0] for a in m))
    mi = m.idx.long()
    xt = last_xy[mi]
    med = epipolar.median_displacement(xy, xt, m.mask)

    # essential-matrix RANSAC (main.cpp:1186); res: last keyframe -> frame
    focal = (K[0, 0] + K[1, 1]) * 0.5
    quality = matching.prosac_quality(xy, xt, m, *_support_radii(cfg))
    idx = _minimal_sets(generator, m.mask, quality, cfg.ransac)
    res = ransac.essential_from_samples(last_norm[mi], norm, m.mask, idx,
                                        focal, cfg.ransac)

    inlier_ratio = (res.num_inliers.to(torch.float32)
                    / torch.clamp_min(m.count.to(torch.float32), 1.0))
    accept = ((m.count >= kcfg.min_tracked_features)
              & (med >= kcfg.min_median_displacement)
              & (med <= kcfg.max_median_displacement)
              & res.ok
              & (res.num_inliers >= kcfg.min_inliers)
              & (inlier_ratio >= kcfg.min_inlier_ratio)
              & (state.kf_count < state.kp_xy.shape[0]))
    out, tri = _extend_map(state, xy, norm, valid, desc, frame_idx, res, m,
                           K, cfg, accept)
    info = StepInfo(
        accepted=accept, num_matches=m.count, median_disp=med,
        num_inliers=res.num_inliers,
        n_triangulated=out.point_count - state.point_count,
        n_merged=(out.obs_count - state.obs_count
                  - 2 * (out.point_count - state.point_count)),
        n_rej_parallax=tri.n_parallax, n_rej_reproj=tri.n_reproj,
        n_rej_depth=tri.n_behind + tri.n_depth)
    return out, info


def _last_writer(target: torch.Tensor, n: int) -> torch.Tensor:
    """For each of ``n`` slots, the highest row that ``target`` [M] sends
    there, -1 where none does: the winner of a scatter with duplicate
    indices when the last row in order wins, as the JAX package's scatter
    does on its CPU backend (ROADMAP R9). ``index_put_`` on CUDA promises
    no order, so the order is made explicit."""
    rows = torch.arange(target.shape[0], device=target.device)
    return torch.full((n,), -1, dtype=torch.int64,
                      device=target.device).scatter_reduce_(
        0, target, rows, "amax")


def _extend_map(state: MapState, xy, norm, valid, desc, frame_idx: int,
                res: ransac.EssentialResult, m: matching.Matches,
                K: torch.Tensor, cfg: PipelineConfig, accept: torch.Tensor):
    """Chain the pose, triangulate the gated inliers, merge them into the map
    through the track table (main.cpp:1216-1341). Returns (state,
    TriangulationResult). ``accept`` gates every write: scatter lanes go to
    the trash slots and row writes keep the old row, so a rejected frame
    leaves the state's values as they were."""
    dev = xy.device
    n = xy.shape[0]
    cap_k = state.kp_xy.shape[0]
    last = (state.kf_count - 1).reshape(1).long()
    # a full store rejects (accept is False): the row writes then go to the
    # last row and keep it
    new_kf = torch.clamp_max(state.kf_count, cap_k - 1).reshape(1).long()
    R_last, t_last = lie.params_to_pose(_row(state.poses, last))
    # unit-norm t chaining, no scale propagation (main.cpp:1216-1219)
    R_new, t_new = lie.compose(res.R, res.t, R_last, t_last)
    new_pose = lie.pose_to_params(R_new, t_new)

    mi = m.idx.long()
    x1 = _row(state.kp_norm, last)[mi]     # last keyframe, per query row
    uv1 = _row(state.kp_xy, last)[mi]
    pair_mask = m.mask & res.inliers & accept
    tri = triangulation.triangulate_gated(K, R_last, t_last, R_new, t_new,
                                          x1, norm, uv1, xy, pair_mask,
                                          cfg.triangulation)

    # merge (main.cpp:1261-1341): only matches whose fresh triangulation
    # passed every gate add an observation (the reference's gates come
    # before its merge block, main.cpp:1283-1317)
    track_last = _row(state.kp_to_point, last)        # [N]
    existing_pid = track_last[mi]                     # per query row
    has_existing = pair_mask & tri.accept & (existing_pid >= 0)
    make_new = pair_mask & tri.accept & (existing_pid < 0)

    p_cap = state.points.shape[0] - 1
    o_cap = state.obs_cam.shape[0] - 1
    n_new = torch.sum(make_new, dtype=torch.int32)
    new_slot = (state.point_count
                + torch.cumsum(make_new.to(torch.int32), 0, dtype=torch.int32)
                - 1)
    in_p_cap = make_new & (new_slot < p_cap)
    p_idx = torch.where(in_p_cap, new_slot, p_cap)
    # lanes that create no point all write the trash slot, zeroed below
    state.points.index_put_((p_idx.long(),), tri.X)
    state.point_valid.index_put_((p_idx.long(),), in_p_cap)
    point_count = torch.clamp_max(state.point_count + n_new, p_cap)

    # point id each matched keypoint ends up with
    final_pid = torch.where(has_existing, existing_pid,
                            torch.where(in_p_cap, p_idx, -1))

    # observation appends: one per existing match (new keyframe only) and
    # two per new point (last and new keyframe)
    n_exist = torch.sum(has_existing, dtype=torch.int32)
    base = state.obs_count
    rank_e = torch.cumsum(has_existing.to(torch.int32), 0,
                          dtype=torch.int32) - 1
    e_idx = torch.clamp_max(torch.where(has_existing, base + rank_e, o_cap),
                            o_cap).long()
    base2 = torch.clamp_max(base + n_exist, o_cap)
    rank_p = torch.cumsum(in_p_cap.to(torch.int32), 0, dtype=torch.int32) - 1
    a_idx = torch.clamp_max(torch.where(in_p_cap, base2 + 2 * rank_p, o_cap),
                            o_cap).long()
    b_idx = torch.clamp_max(
        torch.where(in_p_cap, base2 + 2 * rank_p + 1, o_cap), o_cap).long()
    kf_new = state.kf_count.expand(n)
    kf_last = (state.kf_count - 1).expand(n)
    true = torch.ones(n, dtype=torch.bool, device=dev)
    # real indices are distinct; every inactive lane writes the trash slot
    for idx_, cam, uv in ((e_idx, kf_new, xy), (a_idx, kf_new, xy),
                          (b_idx, kf_last, uv1)):
        state.obs_cam.index_put_((idx_,), cam)
        state.obs_point.index_put_((idx_,), final_pid)
        state.obs_uv.index_put_((idx_,), uv)
        state.obs_valid.index_put_((idx_,), true)
    obs_count = torch.clamp_max(
        base2 + 2 * torch.sum(in_p_cap, dtype=torch.int32), o_cap)

    # track tables: the new keyframe's row by query keypoint; the last
    # keyframe's row gets the new points too (both views now track them).
    # Rows that share a target (or carry the idx 0 of a non-match) write in
    # order and the last one wins (ROADMAP R9).
    track_new = torch.where(pair_mask & (final_pid >= 0), final_pid, -1)
    writer = _last_writer(mi, n)
    vals = torch.where(in_p_cap, final_pid, existing_pid)
    track_last_new = torch.where(writer >= 0, vals[writer.clamp_min(0)],
                                 track_last)

    # zero the trash slots
    state.points.narrow(0, p_cap, 1).zero_()
    state.point_valid.narrow(0, p_cap, 1).zero_()
    state.obs_valid.narrow(0, o_cap, 1).zero_()

    fid = torch.full((), frame_idx, dtype=torch.int32, device=dev)
    _set_row(state.kf_frame, new_kf, fid, accept)
    _set_row(state.poses, new_kf, new_pose, accept)
    _set_row(state.kp_xy, new_kf, xy, accept)
    _set_row(state.kp_norm, new_kf, norm, accept)
    _set_row(state.kp_valid, new_kf, valid, accept)
    _set_row(state.desc, new_kf, desc, accept)
    _set_row(state.kp_to_point, last, track_last_new, accept)
    _set_row(state.kp_to_point, new_kf, track_new, accept)
    return state._replace(
        kf_count=state.kf_count + accept.to(torch.int32),
        point_count=point_count, obs_count=obs_count), tri


# ---------------------------------------------------------------------------
# loop-closure search over keyframes (main.cpp:1362-1421)
# ---------------------------------------------------------------------------

def _pair_ratio_counts(desc: torch.Tensor, kp_valid: torch.Tensor,
                       pair_q: torch.Tensor, pair_t: torch.Tensor,
                       ratio: float = 0.7) -> torch.Tensor:
    """[P] ratio-test match counts of candidate keyframe pairs (the loop
    search matches with ratio 0.7, main.cpp:1386): one launch of the top-2
    kernel over the pair list."""
    return _match_pairs(desc, kp_valid, desc, kp_valid, pair_q, pair_t,
                        ratio).count


def _verify_loop_candidates(desc, kp_valid, kp_norm, cand_q, cand_t,
                            generator, focal, radius: float, tau: float,
                            ratio: float, cfg):
    """Match + batched essential RANSAC of the candidate keyframe pairs
    (``cand_q`` [C] current, ``cand_t`` [C] past) in one pass: one launch of
    the top-2 kernel, one of the motion-support kernel E over the C match
    sets, one RANSAC over a leading candidate axis. Returns (Matches [C, N],
    EssentialResult [C, ...])."""
    m = _match_pairs(desc, kp_valid, desc, kp_valid, cand_q, cand_t, ratio)
    xq = kp_norm.index_select(0, cand_q.long())
    xt = torch.take_along_dim(kp_norm.index_select(0, cand_t.long()),
                              m.idx.long()[..., None], dim=1)
    # PROSAC quality in normalized coordinates (radius/tau over focal)
    quality = matching.prosac_quality(xq, xt, m, radius, tau)
    idx = _minimal_sets(generator, m.mask, quality, cfg)
    res = ransac.essential_from_samples(xt, xq, m.mask, idx, focal, cfg)
    return m, res


def _verify_loop_scores(desc, kp_valid, kp_norm, cand_q, cand_t, generator,
                        focal, radius: float, tau: float, ratio: float, cfg,
                        chunk: int = VERIFY_CHUNK):
    """:func:`_verify_loop_candidates` over all candidates, ``chunk`` at a
    time (the candidate count is a multiple of ``chunk``). Returns the [C,
    3] (match count, inlier count, pose-inlier count) table and each
    candidate's (match idx [C, N], R [C, 3, 3], t [C, 3], pose inliers [C,
    N]), all on the device."""
    scores, geo = [], []
    for s in range(0, cand_q.shape[0], chunk):
        m, res = _verify_loop_candidates(
            desc, kp_valid, kp_norm, cand_q[s:s + chunk],
            cand_t[s:s + chunk], generator, focal, radius, tau, ratio, cfg)
        scores.append(torch.stack([m.count, res.num_inliers,
                                   res.num_pose_inliers], dim=-1))
        geo.append((m.idx, res.R, res.t, res.pose_inliers))
    return torch.cat(scores), tuple(torch.cat(g) for g in zip(*geo))


def _backend_program(K, poses, points, point_valid, obs_cam, obs_point,
                     obs_uv, obs_valid, loop_past: int, loop_curr: int,
                     loop_R, loop_t, *, k: int, pb: int, nb: int,
                     has_loop: bool, cfg: PipelineConfig):
    """The reference backend (main.cpp:1423-1669): PGO with the loop
    constraint, reprojection metric, 5-outer alternating BA, outlier
    removal, post-filter metric, 3-outer BA, and every counter the reference
    prints as device tensors, for one readback. The math of the staged
    methods, composed; ``k``/``pb``/``nb`` are the host-known keyframe /
    point / observation buckets."""
    params = poses[:k]
    zero = torch.zeros((), dtype=torch.float32, device=poses.device)

    def drift_deg(pp):
        # rotation drift between the loop measurement and the odometry
        # chain (main.cpp:1476-1482, 1487-1491)
        Rc, _ = lie.params_to_pose(pp[loop_curr])
        Rp, _ = lie.params_to_pose(pp[loop_past])
        return torch.rad2deg(lie.rotation_error(loop_R, Rc @ Rp.T))

    drift0 = drift1 = cost0 = zero
    costs = zero[None]
    if has_loop:
        drift0 = drift_deg(params)
        if cfg.pgo.method == PoseGraphMethod.GAUSS_NEWTON:
            g = pgo.build_trajectory_graph(params, loop_past, loop_curr,
                                           loop_R, loop_t,
                                           cfg.pgo.loop_edge_weight)
            cost0 = pgo.total_cost(params, g)
            opt, costs = pgo.optimize_pose_graph(params, g, cfg.pgo)
        else:
            opt = pgo.simple_pose_correction(params, loop_past, loop_curr,
                                             loop_R)
        drift1 = drift_deg(opt)
        poses = torch.cat([opt, poses[k:]])

    # last keyframe camera center (the reconstruction summary,
    # main.cpp:1524-1538)
    Rk, tk = lie.params_to_pose(poses[k - 1])
    center_last = lie.camera_center(Rk, tk)

    obs = ba.Observations(obs_cam[:nb], obs_point[:nb], obs_uv[:nb],
                          obs_valid[:nb])
    e0 = ba.mean_reprojection_error(K, poses, points, obs)
    cp, pts, errs1 = ba.alternating_ba(K, poses, points[:pb], obs,
                                       point_valid[:pb], cfg.ba)
    points = torch.cat([pts, points[pb:]])

    k_mask = torch.arange(poses.shape[0], device=poses.device) < k
    res = outliers.remove_outliers(K, cp, k_mask, points[:pb],
                                   point_valid[:pb], obs, cfg.outlier)
    point_valid = torch.cat([res.point_valid, point_valid[pb:]])
    obs = obs._replace(valid=res.obs_valid)

    ef = ba.mean_reprojection_error(K, cp, points, obs)
    cp2, pts2, errs2 = ba.alternating_ba(K, cp, points[:pb], obs,
                                         point_valid[:pb], cfg.ba,
                                         outer_iterations=3)
    points = torch.cat([pts2, points[pb:]])
    metrics = dict(
        drift0_deg=drift0, drift1_deg=drift1, cost0=cost0,
        cost_last=costs[-1], center_last=center_last, e0=e0, errs1=errs1,
        n_outliers=res.n_outliers, n_points_before=res.n_points_before,
        distance_threshold=res.distance_threshold,
        pts_after=torch.sum(res.point_valid, dtype=torch.int32),
        obs_after=torch.sum(res.obs_valid, dtype=torch.int32), ef=ef,
        errs2=errs2)
    return cp2, points, point_valid, obs.valid, metrics


def _host(tensors: dict) -> dict:
    """Every tensor of ``tensors`` as numpy, with one wait for the device."""
    out = _readback({k: (v,) for k, v in tensors.items()})
    return {k: v[0] for k, v in out.items()}


@dataclasses.dataclass
class LoopResult:
    found: bool
    curr_kf: int = -1
    past_kf: int = -1
    num_matches: int = 0
    num_inliers: int = 0
    num_pose_inliers: int = 0
    R_rel: np.ndarray | None = None   # past cam -> curr cam
    t_rel: np.ndarray | None = None
    inlier_pairs: tuple[np.ndarray, np.ndarray] | None = None  # (q, t) idx


@dataclasses.dataclass
class SfMResult:
    state: MapState
    infos: list[StepInfo] | StepInfo
    loop: LoopResult
    reproj_before_ba: float
    reproj_after_ba: float
    reproj_final: float
    obj_path: str | None


class SfMPipeline:
    """The Version-B pipeline, run from the host on one ``device`` (a
    ``torch.device`` or its name). ``run(frames)`` reproduces the
    reference's ``main()`` end to end: front-end -> keyframe pass -> loop
    search -> PGO -> BA -> outlier removal -> BA -> OBJ. ``use_scan`` runs
    the keyframe pass without per-frame logging and without reading
    anything back per frame; the host loop reads one flag per frame to log
    accepted keyframes, as the JAX package does. ``config.detector`` picks
    the ORB or the SIFT front-end."""

    def __init__(self, config: PipelineConfig | None = None,
                 max_keyframes: int = 256, max_points: int = 65536,
                 max_obs: int = 262144, log=print, use_scan: bool = False,
                 *, device):
        self.config = config or PipelineConfig()
        if self.config.detector not in ("orb", "sift"):
            raise ValueError(f"unknown detector {self.config.detector!r}")
        self.max_keyframes = max_keyframes
        self.max_points = max_points
        self.max_obs = max_obs
        self.log = log
        self.use_scan = use_scan
        self.device = torch.device(device)
        cam = self.config.camera
        self.K = torch.tensor(cam.K, dtype=torch.float32, device=self.device)
        self.dist = torch.tensor(cam.dist_coeffs, dtype=torch.float32,
                                 device=self.device)
        self._pattern = (orb.brief_pairs(self.config.orb, self.device)
                         if self.config.detector == "orb" else None)

    # -- front-end ---------------------------------------------------------

    def _frontend(self, frames):
        """Batched front-end (ORB or SIFT per ``config.detector``) and
        keypoint undistortion of every frame (numpy or tensor, uint8 or
        float in [0, 1]), uploaded and detected a chunk at a time
        (``FRONTEND_CHUNK`` frames for ORB, ``SiftConfig.batch_chunk`` for
        SIFT). Valid rows are packed first and every array is cut to a count
        bucket (one readback of the largest valid count). Returns
        (descriptors: ORB's packed words [B, N, 8] int32 or SIFT's
        [B, N, 128] float32, valid, undistorted xy, normalized xy)."""
        desc, xy, valid = self._frontend_detect(frames)
        return self._frontend_cut(desc, xy, valid,
                                  int(torch.amax(torch.sum(valid, dim=1))))

    def _frontend_detect(self, frames):
        """The detection half of :meth:`_frontend`: (descriptors, xy,
        valid) of every frame, valid rows first, not cut."""
        sift_cfg = self.config.sift
        chunk = (sift_cfg.batch_chunk if self.config.detector == "sift"
                 else FRONTEND_CHUNK)
        parts = []
        for i in range(0, frames.shape[0], chunk):
            imgs = ship_frames(frames[i:i + chunk], self.device)
            if self.config.detector == "sift":
                f = sift._detect_and_describe_frames(imgs, sift_cfg)
                parts.append((f.descriptors, f.xy, f.valid))
                continue
            f = orb.detect_and_describe_batch(imgs, self.config.orb,
                                              self._pattern)
            parts.append((f.descriptors, f.keypoints.xy, f.keypoints.valid))
        desc, xy, valid = (torch.cat(p) for p in zip(*parts))
        return matching.pack_valid_first(desc, xy, valid)

    def _frontend_cut(self, desc, xy, valid, nv: int):
        """The rest of :meth:`_frontend`: every array cut to the count
        bucket of ``nv`` valid rows (the largest count of any frame), the
        keypoints undistorted and normalized."""
        nb = self._bucket_fine(max(nv, 128), desc.shape[1], floor=128,
                               step=512)
        desc, xy, valid = (desc[:, :nb].contiguous(), xy[:, :nb],
                           valid[:, :nb].contiguous())
        und = camera_ops.undistort_points(self.K, self.dist, xy)
        c = torch.stack([self.K[0, 2], self.K[1, 2]])
        f = torch.stack([self.K[0, 0], self.K[1, 1]])
        return desc, valid, und, (und - c) / f

    # -- keyframe pass -----------------------------------------------------

    def _keyframe_pass(self, frames, log_frames: bool, features=None):
        desc, valid, und, norm = (self._frontend(frames) if features is None
                                  else features)
        num_frames = desc.shape[0]
        # capacity = the compacted feature bucket, not the configured maximum
        state = init_map_state(self.max_keyframes, desc.shape[1],
                               self.max_points, self.max_obs, self.device,
                               desc.shape[2], desc.dtype)
        state = _bootstrap(state, und[0], norm[0], valid[0], desc[0], 0)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(KEYFRAME_SEED)
        infos, kf_index = [], 0
        for f in range(1, num_frames):
            state, info = _sfm_step(state, und[f], norm[f], valid[f], desc[f],
                                    f, self.K, self.config, generator)
            infos.append(info)
            # per-frame acceptance lines (main.cpp:1202-1206, 1343-1346)
            if log_frames and bool(info.accepted):
                kf_index += 1
                if hasattr(self.log, "keyframe_accepted"):
                    v = torch.stack([t.to(torch.float64) for t in (
                        info.num_matches, info.median_disp, info.num_inliers,
                        info.n_triangulated, info.n_merged,
                        info.n_rej_parallax, info.n_rej_reproj,
                        info.n_rej_depth)]).tolist()
                    self.log.keyframe_accepted(f, kf_index, int(v[0]), v[1],
                                               int(v[2]))
                    self.log.triangulation_counters(*(int(x) for x in v[3:]))
        self._log_keyframe_summary(state, num_frames)
        return state, infos

    def run_frontend_and_keyframes_scan(self, frames, features=None):
        """The whole keyframe pass with no per-frame readback (the fast
        path; the math of :meth:`run_frontend_and_keyframes`, which reads
        one flag per frame for the reference's logging). Returns (state,
        StepInfo of [B - 1] tensors). ``features``, when given, are
        :meth:`_frontend`'s outputs for ``frames`` (the sharded front-end's,
        say), and the front-end does not run."""
        state, infos = self._keyframe_pass(frames, log_frames=False,
                                           features=features)
        return state, StepInfo(*(torch.stack(f) for f in zip(*infos)))

    def run_frontend_and_keyframes(self, frames):
        return self._keyframe_pass(frames, log_frames=True)

    def _log_keyframe_summary(self, state: MapState, num_frames: int):
        """Reference keyframe-pass completion block (main.cpp:1354-1356)."""
        h = _host({"k": state.kf_count, "p": state.point_count})
        self.log("\n=== Keyframe Selection Complete ===")
        self.log(f"Total keyframes: {int(h['k'])} (from {num_frames} frames)")
        self.log(f"Total 3D points: {int(h['p'])}")

    # -- loop search -------------------------------------------------------

    def find_loop(self, state: MapState) -> LoopResult:
        """Single global best loop (main.cpp:1362-1421): candidate pairs at
        gap >= max(3, K/2) where both keyframes have >= 100 descriptors
        (main.cpp:1382), ratio-0.7 matching > min_matches, essential RANSAC
        with inliers > min_inliers and ratio > min_inlier_ratio, the best
        inlier count wins, recoverPose must keep > min_pose_inliers. Every
        candidate above the match threshold is verified, most-matched first,
        in chunks of 32; the scores come back in one readback."""
        self.log("\n=== Starting Loop Closure Detection ===")
        k = int(state.kf_count)
        gap = max(3, k // 2)
        nfeat = torch.sum(state.kp_valid, dim=1).cpu().numpy()
        enough = nfeat >= 100
        pairs = [(c, p) for c in range(gap, k) for p in range(0, c - gap + 1)
                 if enough[c] and enough[p]]
        if not pairs:
            self.log(f"  No loop closure detected (gap={gap} frames).")
            return LoopResult(found=False)
        pq, pt = torch.tensor(pairs, dtype=torch.int32,
                              device=self.device).T
        ratio = self.config.match.loop_ratio_threshold
        counts = _pair_ratio_counts(state.desc, state.kp_valid, pq, pt,
                                    ratio).cpu().numpy()
        lv = self.config.loop_verify
        cand = [i for i, c in enumerate(counts) if c > lv.min_matches]
        if not cand:
            self.log(f"  No loop closure detected (gap={gap} frames).")
            return LoopResult(found=False)

        # most-matched first (stable), padded to a bucket with the first
        # candidate, as the JAX package does (its sampled sets then line up)
        cand = sorted(cand, key=lambda i: -counts[i])
        c_real = len(cand)
        cb = self._bucket_fine(c_real, 1 << 20, floor=VERIFY_CHUNK)
        padded = cand + [cand[0]] * (cb - c_real)
        cq, ct = torch.tensor([pairs[i] for i in padded], dtype=torch.int32,
                              device=self.device).T
        cam = self.config.camera
        focal = float(np.float32(cam.fx) + np.float32(cam.fy)) * 0.5
        # motion-support radii in normalized units (pixel fractions / focal)
        w_est = 2.0 * float(np.float32(cam.cx))
        radius = max(self.config.match.motion_radius_frac * w_est,
                     24.0) / focal
        tau = max(self.config.match.motion_tau_frac * w_est, 8.0) / focal
        generator = torch.Generator(device=self.device)
        generator.manual_seed(LOOP_SEED)
        scores, geo = _verify_loop_scores(
            state.desc, state.kp_valid, state.kp_norm, cq, ct, generator,
            torch.full((), focal, dtype=torch.float32, device=self.device),
            radius, tau, ratio, self.config.ransac)
        scores = scores.cpu().numpy()[:c_real]

        best = LoopResult(found=False)
        best_row = -1
        for row, i in enumerate(cand):
            mcount, ninl, npos = (int(v) for v in scores[row])
            if (ninl > lv.min_inliers
                    and ninl / max(mcount, 1) > lv.min_inlier_ratio
                    and ninl > best.num_inliers
                    and npos > lv.min_pose_inliers):
                c, p = pairs[i]
                best = LoopResult(found=True, curr_kf=c, past_kf=p,
                                  num_matches=mcount, num_inliers=ninl,
                                  num_pose_inliers=npos)
                best_row = row
        if best.found:
            midx, R, t, mask = _host({
                "midx": geo[0][best_row], "R": geo[1][best_row],
                "t": geo[2][best_row], "mask": geo[3][best_row]}).values()
            best.R_rel, best.t_rel = R, t
            best.inlier_pairs = (np.flatnonzero(mask), midx[mask])
            # reference success line (main.cpp:1425-1428)
            self.log(f"  Best loop closure: Frame {best.curr_kf} <-> "
                     f"Frame {best.past_kf} ({best.num_inliers} inliers)")
        else:
            self.log(f"  No loop closure detected (gap={gap} frames).")
        return best

    # -- backend -----------------------------------------------------------

    def _drift_deg(self, params: torch.Tensor, loop: LoopResult) -> float:
        """Rotation drift between the loop measurement and the odometry
        chain (main.cpp:1476-1482, 1487-1491)."""
        Rc, _ = lie.params_to_pose(params[loop.curr_kf])
        Rp, _ = lie.params_to_pose(params[loop.past_kf])
        R_loop = torch.tensor(loop.R_rel, dtype=torch.float32,
                              device=self.device)
        return float(torch.rad2deg(lie.rotation_error(R_loop, Rc @ Rp.T)))

    def optimize(self, state: MapState, loop: LoopResult) -> MapState:
        """PGO with the loop constraint (main.cpp:1423-1515)."""
        if not loop.found:
            return state
        k = int(state.kf_count)
        params = state.poses[:k]
        R_loop = torch.tensor(loop.R_rel, dtype=torch.float32,
                              device=self.device)
        t_loop = torch.tensor(loop.t_rel, dtype=torch.float32,
                              device=self.device)
        if self.config.pgo.method == PoseGraphMethod.GAUSS_NEWTON:
            self.log("  Using Gauss-Newton pose graph optimization...")
            g = pgo.build_trajectory_graph(params, loop.past_kf, loop.curr_kf,
                                           R_loop, t_loop,
                                           self.config.pgo.loop_edge_weight)
            self.log(f"  Built pose graph: {k} edges ({k - 1} sequential "
                     "+ 1 loop closure)")
            self.log(f"  Rotation drift before PGO: "
                     f"{self._drift_deg(params, loop):g} degrees")
            cost0 = float(pgo.total_cost(params, g))
            opt, costs = pgo.optimize_pose_graph(params, g, self.config.pgo)
            self.log(f"PGO cost: {cost0:.6f} -> {float(costs[-1]):.6f}")
            self.log(f"  Rotation drift after PGO: "
                     f"{self._drift_deg(opt, loop):g} degrees")
        else:
            self.log("  Using simple linear pose correction...")
            opt = pgo.simple_pose_correction(params, loop.past_kf,
                                             loop.curr_kf, R_loop)
        state = state._replace(poses=torch.cat([opt, state.poses[k:]]))
        return self._add_loop_observations(state, loop)

    def _add_loop_observations(self, state: MapState,
                               loop: LoopResult) -> MapState:
        state, count = self._loop_obs_append(state, loop)
        if count:
            self.log(f"  Added {count} loop closure observations.")
        return state

    def _loop_obs_append(self, state: MapState, loop: LoopResult):
        """Cross-observations of existing points between the loop keyframes
        through the track table (main.cpp:1494-1514), appended on the host
        side (once per reconstruction; the rows come back in one readback).
        Returns (state, observations added)."""
        qi, ti = loop.inlier_pairs
        h = _host({"tc": state.kp_to_point[loop.curr_kf],
                   "tp": state.kp_to_point[loop.past_kf],
                   "uc": state.kp_xy[loop.curr_kf],
                   "up": state.kp_xy[loop.past_kf], "base": state.obs_count})
        cams, pids, uvs = [], [], []
        for q, t in zip(qi, ti):
            pid_c, pid_p = h["tc"][q], h["tp"][t]
            if pid_p >= 0 and pid_c < 0:
                cams.append(loop.curr_kf), pids.append(pid_p)
                uvs.append(h["uc"][q])
            elif pid_c >= 0 and pid_p < 0:
                cams.append(loop.past_kf), pids.append(pid_c)
                uvs.append(h["up"][t])
        if not cams:
            return state, 0
        base = int(h["base"])
        o_cap = state.obs_cam.shape[0] - 1
        count = min(len(cams), o_cap - base)
        sl = slice(base, base + count)

        def dev(a, dtype):
            return torch.from_numpy(np.asarray(a[:count], dtype)).to(
                self.device)

        state.obs_cam[sl] = dev(cams, np.int32)
        state.obs_point[sl] = dev(pids, np.int32)
        state.obs_uv[sl] = dev(uvs, np.float32)
        state.obs_valid[sl].fill_(True)
        return state._replace(obs_count=torch.full_like(
            state.obs_count, base + count)), count

    def _log_reconstruction_summary(self, state: MapState):
        """Reference report block (main.cpp:1524-1538)."""
        h = _host({"k": state.kf_count, "p": state.point_count,
                   "o": state.obs_count, "f": state.kf_frame})
        k = int(h["k"])
        self.log("\n=== Reconstruction Summary ===")
        self.log(f"Number of keyframes: {k}")
        self.log(f"Total 3D points: {int(h['p'])}")
        self.log(f"Total observations: {int(h['o'])}")
        self.log("\nFirst keyframe pose (origin):")
        self.log("  R = I, t = [0,0,0]")
        if k > 1:
            R, t = lie.params_to_pose(state.poses[k - 1])
            C = lie.camera_center(R, t).cpu().numpy()
            self.log(f"\nLast keyframe pose (keyframe {k - 1}, "
                     f"frame {int(h['f'][k - 1])}):")
            self.log(f"  Camera center: [{C[0]:g}, {C[1]:g}, {C[2]:g}]")

    @staticmethod
    def _bucket_fine(n: int, cap: int, floor: int = 32,
                     step: int = 256) -> int:
        """Power-of-two buckets below ``step``, multiples of ``step`` above
        (the JAX package's shape buckets, kept so shapes match)."""
        if n <= step:
            return SfMPipeline._bucket(n, cap, floor)
        return min(-(-n // step) * step, cap)

    @staticmethod
    def _bucket(n: int, cap: int, floor: int = 4096) -> int:
        """Smallest power of two >= n (>= floor, <= cap): the backend works
        on bucketed slices of the fixed-capacity arrays, so its cost follows
        the map's size, not its capacity."""
        b = floor
        while b < n:
            b *= 2
        return min(b, cap)

    def _active_obs(self, state: MapState) -> ba.Observations:
        nb = self._bucket(int(state.obs_count) + 1, state.obs_cam.shape[0])
        return ba.Observations(state.obs_cam[:nb], state.obs_point[:nb],
                               state.obs_uv[:nb], state.obs_valid[:nb])

    def _mean_reproj(self, state: MapState) -> float:
        return float(ba.mean_reprojection_error(
            self.K, state.poses, state.points, self._active_obs(state)))

    def bundle_adjust(self, state: MapState,
                      outer_iterations: int | None = None):
        obs = self._active_obs(state)
        pb = self._bucket(int(state.point_count) + 1, state.points.shape[0])
        cp, pts, errs = ba.alternating_ba(
            self.K, state.poses, state.points[:pb], obs,
            state.point_valid[:pb], self.config.ba, outer_iterations)
        return state._replace(
            poses=cp, points=torch.cat([pts, state.points[pb:]])), errs

    def remove_outliers(self, state: MapState) -> MapState:
        k_mask = (torch.arange(state.poses.shape[0], device=self.device)
                  < state.kf_count)
        obs = self._active_obs(state)
        nb = obs.valid.shape[0]
        pb = self._bucket(int(state.point_count) + 1, state.points.shape[0])
        res = outliers.remove_outliers(
            self.K, state.poses, k_mask, state.points[:pb],
            state.point_valid[:pb], obs, self.config.outlier)
        state = state._replace(
            point_valid=torch.cat([res.point_valid, state.point_valid[pb:]]),
            obs_valid=torch.cat([res.obs_valid, state.obs_valid[nb:]]))
        h = _host({"out": res.n_outliers, "before": res.n_points_before,
                   "thr": res.distance_threshold,
                   "pts": torch.sum(res.point_valid, dtype=torch.int32),
                   "obs": torch.sum(res.obs_valid, dtype=torch.int32)})
        # reference outlier block (main.cpp:1620-1658)
        n_out = int(h["out"])
        before = max(int(h["before"]), 1)
        self.log(f"  Outliers detected: {n_out} / {before} "
                 f"({100.0 * n_out / before:.1f}%)")
        self.log(f"  Distance threshold: {float(h['thr']):g}")
        self.log(f"  Points after filtering: {int(h['pts'])}")
        self.log(f"  Observations after filtering: {int(h['obs'])}")
        return state

    def run_backend(self, state: MapState, loop: LoopResult):
        """The post-loop-search backend (PGO -> BA -> outlier removal -> BA,
        main.cpp:1423-1669) enqueued whole, then ONE metrics readback; the
        log block follows in the reference's order. Returns (state, e0, e1,
        e2): the reprojection errors before BA, after BA and final."""
        n_loop_obs = 0
        if loop.found:
            state, n_loop_obs = self._loop_obs_append(state, loop)
        h = _host({"k": state.kf_count, "p": state.point_count,
                   "o": state.obs_count, "f": state.kf_frame})
        k = int(h["k"])
        counts = (int(h["p"]), int(h["o"]))
        pb = self._bucket(counts[0] + 1, state.points.shape[0])
        nb = self._bucket(counts[1] + 1, state.obs_cam.shape[0])
        R_loop = torch.tensor(loop.R_rel if loop.found else np.eye(3),
                              dtype=torch.float32, device=self.device)
        t_loop = torch.tensor(loop.t_rel if loop.found else np.zeros(3),
                              dtype=torch.float32, device=self.device)
        cp, points, point_valid, obs_valid_b, metrics = _backend_program(
            self.K, state.poses, state.points, state.point_valid,
            state.obs_cam, state.obs_point, state.obs_uv, state.obs_valid,
            max(loop.past_kf, 0), max(loop.curr_kf, 0), R_loop, t_loop,
            k=k, pb=pb, nb=nb, has_loop=loop.found, cfg=self.config)
        m = _host(metrics)  # the single backend readback
        state = state._replace(
            poses=cp, points=points, point_valid=point_valid,
            obs_valid=torch.cat([obs_valid_b, state.obs_valid[nb:]]))

        # the reference's log block, in its order (main.cpp:1423-1669)
        if loop.found:
            if self.config.pgo.method == PoseGraphMethod.GAUSS_NEWTON:
                self.log("  Using Gauss-Newton pose graph optimization...")
                self.log(f"  Built pose graph: {k} edges ({k - 1} sequential "
                         "+ 1 loop closure)")
                self.log(f"  Rotation drift before PGO: "
                         f"{float(m['drift0_deg']):g} degrees")
                self.log(f"PGO cost: {float(m['cost0']):.6f} -> "
                         f"{float(m['cost_last']):.6f}")
                self.log(f"  Rotation drift after PGO: "
                         f"{float(m['drift1_deg']):g} degrees")
            else:
                self.log("  Using simple linear pose correction...")
            if n_loop_obs:
                self.log(f"  Added {n_loop_obs} loop closure observations.")
        self.log("\n=== Reconstruction Summary ===")
        self.log(f"Number of keyframes: {k}")
        self.log(f"Total 3D points: {counts[0]}")
        self.log(f"Total observations: {counts[1]}")
        self.log("\nFirst keyframe pose (origin):")
        self.log("  R = I, t = [0,0,0]")
        if k > 1:
            C = m["center_last"]
            self.log(f"\nLast keyframe pose (keyframe {k - 1}, "
                     f"frame {int(h['f'][k - 1])}):")
            self.log(f"  Camera center: [{C[0]:g}, {C[1]:g}, {C[2]:g}]")
        e0 = float(m["e0"])
        e1 = float(m["errs1"][-1])
        self.log(f"\nReprojection error BEFORE BA: {e0:g} px")
        self.log(f"\nReprojection error AFTER BA: {e1:g} px")
        self.log("\n=== Outlier Removal ===")
        n_out = int(m["n_outliers"])
        before = max(int(m["n_points_before"]), 1)
        self.log(f"  Outliers detected: {n_out} / {before} "
                 f"({100.0 * n_out / before:.1f}%)")
        self.log(f"  Distance threshold: {float(m['distance_threshold']):g}")
        self.log(f"  Points after filtering: {int(m['pts_after'])}")
        self.log(f"  Observations after filtering: {int(m['obs_after'])}")
        self.log("\n=== Final Bundle Adjustment ===")
        self.log(f"Reprojection error after filtering: {float(m['ef']):g} px")
        e2 = float(m["errs2"][-1])
        self.log(f"\nFINAL reprojection error: {e2:g} px")
        return state, e0, e1, e2

    # -- end to end --------------------------------------------------------

    def run(self, frames, data_dir: str = "data", write_obj: bool = True,
            checkpoint: bool = False) -> SfMResult:
        """Full reconstruction of ``[B, H, W]`` frames. With ``checkpoint``
        the map state is saved after the front-end and after PGO (NPZ under
        ``<data_dir>/checkpoints/``, the JAX package's layout) and an
        existing front-end checkpoint is reused (the reference's
        skip-if-exists extraction cache, main.cpp:97-100, extended to the
        compute stages); the backend then runs stage by stage."""
        infos: list[StepInfo] | StepInfo = []
        fe_path = ckpt.stage_checkpoint_path(data_dir, "frontend")
        if checkpoint and fe_path.exists():
            self.log(f"Resuming map state from {fe_path}")
            state = ckpt.load_map_state(fe_path, self.device)
        else:
            if self.use_scan:
                state, infos = self.run_frontend_and_keyframes_scan(frames)
            else:
                state, infos = self.run_frontend_and_keyframes(frames)
            if checkpoint:
                ckpt.save_map_state(fe_path, state)
        loop = self.find_loop(state)
        if not checkpoint:
            state, e0, e1, e2 = self.run_backend(state, loop)
        else:
            # staged: materializes the after-PGO state of the checkpoint
            state = self.optimize(state, loop)
            ckpt.save_map_state(ckpt.stage_checkpoint_path(data_dir, "pgo"),
                                state)
            self._log_reconstruction_summary(state)
            e0 = self._mean_reproj(state)
            self.log(f"\nReprojection error BEFORE BA: {e0:g} px")
            state, errs = self.bundle_adjust(state)
            e1 = float(errs[-1])
            self.log(f"\nReprojection error AFTER BA: {e1:g} px")
            self.log("\n=== Outlier Removal ===")
            state = self.remove_outliers(state)
            self.log("\n=== Final Bundle Adjustment ===")
            ef = self._mean_reproj(state)
            self.log(f"Reprojection error after filtering: {ef:g} px")
            state, errs2 = self.bundle_adjust(state, outer_iterations=3)
            e2 = float(errs2[-1])
            self.log(f"\nFINAL reprojection error: {e2:g} px")

        obj_path = None
        if write_obj:
            k = int(state.kf_count)
            Rs, ts = lie.params_to_pose(state.poses[:k])
            obj_path = str(io_utils.write_obj(
                io_utils.reconstruction_obj_path(data_dir),
                state.points[:-1].cpu().numpy(), Rs.cpu().numpy(),
                ts.cpu().numpy(),
                point_valid=state.point_valid[:-1].cpu().numpy(),
                log=self.log))
        return SfMResult(state=state, infos=infos, loop=loop,
                         reproj_before_ba=e0, reproj_after_ba=e1,
                         reproj_final=e2, obj_path=obj_path)
