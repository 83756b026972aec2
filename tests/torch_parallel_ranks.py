"""Rank bodies of the port's sharded-stage tests (``test_torch_parallel*``):
module-level functions that :func:`slam_loop_closing_tpu_torch.parallel.
launch.spawn` runs on every rank. Every spawned rank imports this module
afresh, so it imports torch, numpy and the port only, never jax."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_loop_closing_tpu_torch.config import (BaConfig, LoopConfig,
                                                OrbConfig, PgoConfig,
                                                PipelineConfig, RansacConfig)
from slam_loop_closing_tpu_torch.ops import ba, pgo, ransac
from slam_loop_closing_tpu_torch.parallel import sharded
from slam_loop_closing_tpu_torch.parallel.mesh import Mesh


def video_config(gap: int = 8) -> PipelineConfig:
    """tests/test_parallel.py's multi-video configuration."""
    return dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=100, num_levels=1),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=gap, frame_skip=1))


def loop_tuples(loops) -> list:
    return [[(c.current_frame_id, c.matched_frame_id, c.num_matches)
             for c in v] for v in loops]


def pose_graph(arrays: dict) -> pgo.PoseGraph:
    return pgo.PoseGraph(*(torch.from_numpy(arrays[f])
                           for f in pgo.PoseGraph._fields))


def observations(arrays: dict) -> ba.Observations:
    return ba.Observations(*(torch.from_numpy(arrays[f])
                             for f in ba.Observations._fields))


def stages(mesh: Mesh, inputs: dict) -> dict:
    """Every light sharded stage on ``inputs`` (numpy arrays from the test):
    the ring (full and banded), ``banded_loop_counts``, the front-end, the
    videos, PGO (dense and PCG), BA and RANSAC. Returns numpy results."""
    out = {}
    for name, (signed, valid, gap) in inputs["ring"].items():
        out[f"ring/{name}"] = sharded.ring_similarity_counts(
            mesh, torch.from_numpy(signed), torch.from_numpy(valid),
            min_gap=gap).numpy()
    for name, (signed, valid, gap) in inputs["banded"].items():
        v = torch.from_numpy(valid)
        counts, sims = sharded.banded_loop_counts(
            mesh, torch.from_numpy(signed), v,
            torch.sum(v, dim=1, dtype=torch.int32), min_gap=gap)
        out[f"banded/{name}"] = (counts.numpy(), sims.numpy())

    frames, nf = inputs["frontend"]
    feats = sharded.frontend_sharded(mesh, frames,
                                     OrbConfig(num_features=nf, num_levels=1))
    out["frontend"] = {"valid": feats.keypoints.valid.numpy(),
                       "xy": feats.keypoints.xy.numpy(),
                       "descriptors": feats.descriptors.numpy(),
                       "signed": feats.signed.numpy()}

    out["videos"] = loop_tuples(sharded.process_videos_sharded(
        mesh, inputs["videos"], video_config()))

    params, graph = inputs["pgo"]
    for name, cfg in (("dense", PgoConfig()),
                      ("pcg", PgoConfig(dense_solver_max_poses=0,
                                        cg_iterations=30))):
        got, costs = sharded.pgo_sharded(mesh, torch.from_numpy(params),
                                         pose_graph(graph), cfg)
        out[f"pgo/{name}"] = (got.numpy(), costs.numpy())

    for name, (K, cams, pts, obs) in inputs["ba"].items():
        c, p, e = sharded.ba_sharded(mesh, torch.from_numpy(K),
                                     torch.from_numpy(cams),
                                     torch.from_numpy(pts),
                                     observations(obs), None, BaConfig())
        out[f"ba/{name}"] = (c.numpy(), p.numpy(), e.numpy())

    x1, x2, mask, hyps = inputs["verify"]
    generator = torch.Generator()
    generator.manual_seed(0)
    res = sharded.verify_pairs_sharded(
        mesh, torch.from_numpy(x1), torch.from_numpy(x2),
        torch.from_numpy(mask), generator, 100.0,
        RansacConfig(num_hypotheses=hyps))
    out["verify"] = {f: getattr(res, f).numpy()
                     for f in ransac.EssentialResult._fields}
    return out


def sfm(mesh: Mesh, frames: np.ndarray, cfg_json: str, caps: dict) -> dict:
    """``sfm_reconstruct_sharded`` on ``frames``: the metrics and the map's
    poses and counts."""
    from slam_loop_closing_tpu_torch.models.sfm import SfMPipeline

    pipe = SfMPipeline(PipelineConfig.from_json(cfg_json),
                       log=lambda *a: None, use_scan=True, device=mesh.device,
                       **caps)
    state, m = sharded.sfm_reconstruct_sharded(mesh, pipe, frames)
    return {"metrics": m, "poses": state.poses.cpu().numpy(),
            "kf_count": int(state.kf_count),
            "point_count": int(state.point_count),
            "points_valid": int(state.point_valid.sum())}
