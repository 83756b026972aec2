"""Command-line interface: ``extract | loop | all | reconstruct |
calibrate`` (``python -m slam_loop_closing_tpu_torch.cli``).

Port of :mod:`slam_loop_closing_tpu.cli`: the 3-mode CLI the reference
documents but never wires up (README.md:56-88 documents ``LoopClosing
extract|loop|all`` with default ``loop``; the shipped main.cpp ignores argv,
main.cpp:1041). Plus:

* ``reconstruct``: the Version-B SfM pipeline (the actual main.cpp behavior)
  ending in the OBJ export.
* ``calibrate``: chessboard camera calibration (the reference's second
  executable, calibrate.cpp).

Every compile-time constant of the reference (main.cpp:34-59,
loop_closing.hpp:31) is a flag with the reference default; ``--config`` loads
a full JSON :class:`~slam_loop_closing_tpu_torch.config.PipelineConfig`;
``--device`` names the torch device every mode computes on (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

from slam_loop_closing_tpu_torch import config as config_mod
from slam_loop_closing_tpu_torch.utils import io as io_utils

MODES = ("extract", "loop", "all", "reconstruct", "calibrate")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam-torch",
        description="SLAM loop closing / SfM on a CUDA GPU (PyTorch)")
    sub = p.add_subparsers(dest="mode")

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to compute on (default cuda)")

    def common(sp, video=True):
        if video:
            sp.add_argument("--video", help="input video file (.MOV etc.)")
        sp.add_argument("--frames", help="directory of frame_%%04d.png")
        sp.add_argument("--data-dir", default="data")
        sp.add_argument("--config", help="JSON PipelineConfig file")
        sp.add_argument("--frame-skip", type=int, default=None,
                        help="process every Nth frame (README default 3)")
        sp.add_argument("--max-frames", type=int, default=512)
        sp.add_argument("--num-features", type=int, default=None,
                        help="ORB feature budget (README default 2000)")
        sp.add_argument("--resize", type=float, default=None,
                        help="downscale factor, e.g. 0.5 (README speed tip)")
        sp.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the run "
                             "into DIR: trace.json (Chrome trace format) "
                             "and spans.json, one record a program span "
                             "(name, id, parent, request, start_ns, "
                             "end_ns, host_ms, device_ms, counters)")
        device(sp)

    sp = sub.add_parser("extract", help="video -> frame_%%04d.png")
    sp.add_argument("--video", required=True)
    sp.add_argument("--data-dir", default="data")

    sp = sub.add_parser("loop", help="multi-loop detection (Version A)")
    common(sp)
    sp.add_argument("--threshold", type=float, default=None,
                    help="loop similarity threshold (README default 0.15)")
    sp.add_argument("--min-gap", type=int, default=None,
                    help="min frame gap for loops (default 30)")
    sp.add_argument("--output", default=None,
                    help="results dir (default <data-dir>/loop_closing_results)")
    sp.add_argument("--batched", action="store_true", default=True,
                    help="use the batched all-pairs path (default)")
    sp.add_argument("--incremental", dest="batched", action="store_false",
                    help="frame-by-frame processing (reference semantics)")

    sp = sub.add_parser("all", help="extract + loop")
    common(sp)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--min-gap", type=int, default=None)
    sp.add_argument("--output", default=None)
    sp.add_argument("--batched", action="store_true", default=True)
    sp.add_argument("--incremental", dest="batched", action="store_false")

    sp = sub.add_parser("reconstruct",
                        help="full SfM + loop closure + BA -> OBJ (Version B)")
    common(sp)
    sp.add_argument("--max-keyframes", type=int, default=256)
    sp.add_argument("--no-obj", action="store_true")
    sp.add_argument("--detector", choices=("orb", "sift"), default=None,
                    help="front-end detector (default orb; reference "
                         "main.cpp uses SIFT)")
    sp.add_argument("--checkpoint", action="store_true",
                    help="save/reuse NPZ map-state checkpoints per stage")
    sp.add_argument("--scan", action="store_true",
                    help="run the keyframe pass with no per-frame readback "
                         "(fastest; no per-frame logs)")

    sp = sub.add_parser("calibrate", help="chessboard camera calibration")
    sp.add_argument("--images", default="data/calibration",
                    help="directory of chessboard PNGs (calibrate.cpp:25)")
    sp.add_argument("--cols", type=int, default=9)
    sp.add_argument("--rows", type=int, default=6)
    sp.add_argument("--square-size", type=float, default=0.03)
    sp.add_argument("--output-overlays", default=None,
                    help="write corner-overlay PNGs here (replaces imshow)")
    device(sp)
    return p


def _load_config(args) -> config_mod.PipelineConfig:
    if getattr(args, "config", None):
        cfg = config_mod.PipelineConfig.from_json(
            Path(args.config).read_text())
    else:
        cfg = config_mod.PipelineConfig()
    loop_kw = {}
    if getattr(args, "threshold", None) is not None:
        loop_kw["loop_threshold"] = args.threshold
    if getattr(args, "min_gap", None) is not None:
        loop_kw["min_loop_gap"] = args.min_gap
    if getattr(args, "frame_skip", None) is not None:
        loop_kw["frame_skip"] = args.frame_skip
    if loop_kw:
        cfg = dataclasses.replace(
            cfg, loop=dataclasses.replace(cfg.loop, **loop_kw))
    if getattr(args, "num_features", None) is not None:
        cfg = dataclasses.replace(
            cfg, orb=dataclasses.replace(cfg.orb,
                                         num_features=args.num_features))
    return cfg


def _resolve_frames(args, cfg) -> np.ndarray:
    """Get the [B, H, W] float32 grayscale frame stack from --frames or
    --video (extracting if needed, with the skip-if-exists cache)."""
    if getattr(args, "frames", None):
        frames_dir = Path(args.frames)
    elif getattr(args, "video", None):
        frames_dir = io_utils.extract_images(args.video, args.data_dir)
    else:
        raise SystemExit("need --frames or --video")
    paths = io_utils.enumerate_frames(frames_dir)
    if not paths:
        raise SystemExit(f"no frame_%04d.png found in {frames_dir}")
    resize_hw = None
    if getattr(args, "resize", None):
        from PIL import Image

        w, h = Image.open(str(paths[0])).size
        resize_hw = (int(h * args.resize), int(w * args.resize))
    frames = io_utils.load_frames_gray(paths, cfg.loop.frame_skip, resize_hw)
    print(f"Loaded {frames.shape[0]} frames "
          f"({frames.shape[1]}x{frames.shape[2]}, frame_skip="
          f"{cfg.loop.frame_skip})")
    return frames


def cmd_extract(args) -> int:
    io_utils.extract_images(args.video, args.data_dir)
    return 0


def cmd_loop(args) -> int:
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.utils import profiling

    cfg = _load_config(args)
    frames = _resolve_frames(args, cfg)
    if frames.shape[0] > args.max_frames:
        frames = frames[: args.max_frames]
    timer = profiling.StageTimer(args.device)
    with profiling.trace(getattr(args, "trace", None)):
        with timer.stage("loop_detection"):
            sys_ = LoopClosingSystem(
                cfg, max_frames=max(args.max_frames, frames.shape[0]),
                device=args.device)
            ids = [i * cfg.loop.frame_skip for i in range(frames.shape[0])]
            if args.batched:
                sys_.process_video(frames, frame_ids=ids)
            else:
                for i in range(frames.shape[0]):
                    sys_.process_frame(frames[i], frame_id=ids[i])
        with timer.stage("save_results"):
            out = Path(args.output) if args.output else (
                Path(args.data_dir) / "loop_closing_results")
            txt = sys_.save_results(out)
    n = len(sys_.get_loop_closures())
    # reference console block (README.md:150-153)
    print("\n=== Processing Complete ===")
    print(f"Total frames processed: {frames.shape[0]}")
    print(f"Loop closures detected: {n}")
    print(f"Throughput: "
          f"{timer.frames_per_sec(frames.shape[0], 'loop_detection'):.1f} "
          "frames/sec")
    print(timer.summary())
    print(f"Results: {txt}")
    return 0


def cmd_reconstruct(args) -> int:
    from slam_loop_closing_tpu_torch.models.sfm import SfMPipeline
    from slam_loop_closing_tpu_torch.utils import profiling

    cfg = _load_config(args)
    if getattr(args, "detector", None):
        cfg = dataclasses.replace(cfg, detector=args.detector)
    frames = _resolve_frames(args, cfg)
    pipe = SfMPipeline(cfg, max_keyframes=args.max_keyframes,
                       use_scan=getattr(args, "scan", False),
                       device=args.device)
    timer = profiling.StageTimer(args.device)
    with profiling.trace(getattr(args, "trace", None)):
        with timer.stage("reconstruct"):
            res = pipe.run(frames, data_dir=args.data_dir,
                           write_obj=not args.no_obj,
                           checkpoint=getattr(args, "checkpoint", False))
    print(timer.summary())
    print(f"Throughput: {timer.frames_per_sec(frames.shape[0]):.2f} "
          "frames/sec end-to-end")
    if res.obj_path:
        print(f"OBJ: {res.obj_path}")
    return 0


def cmd_calibrate(args) -> int:
    from slam_loop_closing_tpu_torch.models import calibration

    return calibration.run_cli(args)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # README parity: bare invocation or unknown first token defaults to
    # ``loop`` mode (README.md:62: "default mode ... loop").
    if not argv or (argv[0].startswith("-") and argv[0] not in ("-h", "--help")):
        argv = ["loop"] + argv
    args = _build_parser().parse_args(argv)
    if args.mode is None:
        args.mode = "loop"
    if args.mode == "extract":
        return cmd_extract(args)
    if args.mode == "loop":
        return cmd_loop(args)
    if args.mode == "all":
        return cmd_loop(args)  # _resolve_frames extracts first
    if args.mode == "reconstruct":
        return cmd_reconstruct(args)
    if args.mode == "calibrate":
        return cmd_calibrate(args)
    raise SystemExit(f"unknown mode {args.mode}")


if __name__ == "__main__":
    sys.exit(main())
