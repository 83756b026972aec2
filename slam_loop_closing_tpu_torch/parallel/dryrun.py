"""One pass of every sharded stage at tiny shapes: the port's counterpart of
the JAX package's multi-chip dry run (``dryrun_multichip``).

    python -m slam_loop_closing_tpu_torch.parallel.dryrun 2 --device cpu
    python -m slam_loop_closing_tpu_torch.parallel.dryrun 1

On the CPU it spawns ``n`` gloo ranks (:func:`.launch.spawn`); on a CUDA
device it runs in this process at one rank (or joins the process group the
caller made), or spawns ``n`` NCCL ranks, one GPU each. Stages, in the JAX
dry run's order and at its shapes: the front-end over ``2n`` 96x128 orbit
frames (ORB-128, one level), the ring's banded counts at gap 2, RANSAC of
the ``n`` best-counted pairs; the multi-video path on two copies of those
frames; then Version-B end to end on the 24-frame 144x192 orbit (seed 5)
with edge-sharded PGO and observation-sharded BA. Version-B runs at 512
RANSAC hypotheses, not the JAX dry run's 128: at 128 the port's own draws
meet a collapse of the keyframe chain on this orbit and the loop (and with
it the sharded PGO) is never reached. The last line printed is the JAX dry
run's summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from slam_loop_closing_tpu_torch.config import (CameraConfig, KeyframeConfig,
                                                LoopConfig, LoopVerifyConfig,
                                                OrbConfig, PipelineConfig,
                                                RansacConfig)
from slam_loop_closing_tpu_torch.parallel import launch, sharded
from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

SFM_H, SFM_W, SFM_HYPOTHESES = 144, 192, 512


def sfm_config() -> PipelineConfig:
    """The dry run's Version-B configuration (the JAX dry run's gates)."""
    h, w = SFM_H, SFM_W
    cam = CameraConfig(fx=0.8 * w, fy=0.8 * w, cx=w / 2, cy=h / 2,
                       k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return dataclasses.replace(
        PipelineConfig(), camera=cam,
        orb=OrbConfig(num_features=300, num_levels=2),
        keyframe=KeyframeConfig(min_median_displacement=2.0,
                                max_median_displacement=150.0,
                                min_tracked_features=40,
                                min_inlier_ratio=0.3, min_inliers=25),
        loop_verify=LoopVerifyConfig(min_matches=40, min_inliers=30,
                                     min_inlier_ratio=0.5,
                                     min_pose_inliers=15),
        ransac=RansacConfig(num_hypotheses=SFM_HYPOTHESES))


def dryrun_body(mesh: mesh_lib.Mesh) -> dict:
    """The dry run on one rank of ``mesh``; every rank returns the same
    summary."""
    from slam_loop_closing_tpu_torch.models.sfm import SfMPipeline

    n, dev = mesh.size, mesh.device
    cfg = OrbConfig(num_features=128, num_levels=1)
    b = 2 * n
    frames = np.asarray(orbit_sequence(num_frames=b, h=96, w=128,
                                       num_points=120), np.float32)

    # 1. front-end over frames; 2. ring counts; 3. pair-split RANSAC
    feats = sharded.frontend_sharded(mesh, frames, cfg)
    valid = feats.keypoints.valid
    nfeat = torch.sum(valid, dim=1, dtype=torch.int32)
    counts, _ = sharded.banded_loop_counts(mesh, feats.signed, valid, nfeat,
                                           min_gap=2)
    top = n
    flat = torch.argsort(counts.reshape(-1), descending=True,
                         stable=True)[:top]
    pq, pt = flat // b, flat % b
    x1 = feats.keypoints.xy[pt] / 100.0 - 0.5
    x2 = feats.keypoints.xy[pq] / 100.0 - 0.5
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    res = sharded.verify_pairs_sharded(
        mesh, x1, x2, valid[pq] & valid[pt], generator, 100.0,
        RansacConfig(num_hypotheses=32))

    # 4. multi-video, the video axis over the mesh
    vcfg = dataclasses.replace(
        PipelineConfig(), orb=cfg,
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=4, frame_skip=1))
    vloops = sharded.process_videos_sharded(mesh, np.stack([frames, frames]),
                                            vcfg)
    if len(vloops) != 2:
        raise AssertionError(f"{len(vloops)} loop lists for 2 videos")

    # 5. Version-B end to end with the shardable stages sharded
    bb = n * max(3, -(-24 // n))            # >= 24, a multiple of the mesh
    sfm_frames = np.asarray(orbit_sequence(num_frames=bb, h=SFM_H, w=SFM_W,
                                           num_points=250, seed=5),
                            np.float32)
    pipe = SfMPipeline(sfm_config(), max_keyframes=bb, max_points=8192,
                       max_obs=32768, use_scan=True, log=lambda *a: None,
                       device=dev)
    state, m = sharded.sfm_reconstruct_sharded(mesh, pipe, sfm_frames)
    if int(state.kf_count) < 5 or not m["loop_found"]:
        raise AssertionError(f"Version-B: {int(state.kf_count)} keyframes, "
                             f"loop {m['loop_found']} (the sharded PGO did "
                             "not run)")
    return {"ranks": n, "counts_shape": tuple(counts.shape), "pairs": top,
            "pair_inliers": res.num_inliers.tolist(),
            "video_loops": sum(len(v) for v in vloops),
            "keyframes": m["keyframes"], "loop_found": m["loop_found"],
            "e2": m["e2"]}


def summary_line(s: dict) -> str:
    """The JAX dry run's summary line for a summary of :func:`dryrun_body`."""
    return (f"dryrun_multichip({s['ranks']}): frontend+ring+verify OK "
            f"(counts {s['counts_shape']}, {s['pairs']} pairs); multi-video "
            f"sharded OK ({s['video_loops']} loops); Version-B sharded OK "
            f"({s['keyframes']} keyframes, loop={s['loop_found']}, final "
            f"reproj {s['e2']:.3f} px)")


def dryrun_multichip(n_devices: int, *, device="cuda",
                     timeout: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` ranks and print its summary line;
    returns rank 0's summary. On the CPU the ranks are spawned gloo
    processes; on CUDA one rank runs in this process (joining the process
    group if there is one), more are spawned, one GPU each. Raises if the
    ranks disagree."""
    dev = torch.device(device)
    if dev.type == "cuda" and (n_devices == 1 or dist.is_initialized()):
        summaries = [dryrun_body(mesh_lib.make_mesh(n_devices, device=dev))]
    else:
        summaries = launch.spawn(dryrun_body, n_devices, device=dev,
                                 timeout=timeout)
    if any(s != summaries[0] for s in summaries):
        raise AssertionError(f"the ranks' summaries differ: {summaries}")
    print(summary_line(summaries[0]), flush=True)
    return summaries[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ranks", type=int, nargs="?", default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL) or cpu (gloo); default cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
