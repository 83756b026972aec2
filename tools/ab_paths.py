"""Time the port's end-to-end paths, and kernels A, E, F, G and H at their
main-path shapes, for the package of one source tree, so that two trees can be
compared in turns on one card (parent, change, change, parent):

    python3 tools/ab_paths.py --root DIR --cache CACHE_DIR [--paths a,b]

``DIR`` holds a ``slam_loop_closing_tpu_torch`` package (this checkout, or
a parent unpacked with ``git archive``); its kernels build into
``DIR/build/``. The paths are driven as this checkout's ``chip_smoke.py``
drives them (its configurations, builders and timers, called on the
package of ``DIR``). The frames are its synthetic orbits, each set
rendered when a path first needs it into ``--cache`` and read from there
by later runs. Needs one CUDA device
and nvcc. Prints one JSON line with the card's name and power limit and,
per path, every repeat:

* ``process_video`` of 96 x 1080p, frames resident (ms, 5 warm runs);
* ``process_stream`` of the same frames from host memory (per-frame median
  and p90 ms, 2 passes after a warm-up);
* BASELINE config 2's front-end, 500 x 1080p ORB-4000 grid 8 in batches of
  50, and its dense all-pairs counts (s, 2 runs), and the front-end's peak
  device memory over what was allocated before it;
* for those three, one more run under the profiler (``process_stream``: 8
  frames on a filled database): the device ms of all kernels and of the
  eight longest by name;
* ``process_videos_batched``, 6 x 48 x 540x960 (ms, 3 runs);
* ``SfMPipeline.run`` resident, ORB (96 x 540x960) and SIFT (96 x 1080p),
  no OBJ (s, 2 runs each after a warm-up), then one run stage by stage,
  each stage synchronized (s: front-end, keyframe pass, find_loop,
  backend); for SIFT also one run under the profiler: the device ms of
  kernel H's kernels and of all kernels;
* kernel A on 8 frames at the four 1080p levels, summed, and kernel G on
  the SIFT keyframe store at the keyframe step's pair and the loop
  search's pairs (``kernels``); kernel E at the shapes of
  ``KERNEL_E_SHAPES`` and kernel F on ``chip_smoke.knn2_store`` at the
  keyframe step's pair and the loop search's 300 pairs (``kernels_ef``,
  no frames); CUDA-event ms and device ms (``chip_smoke.device_ms``);
  kernel F at the keyframe step's pair alone, CUDA-event ms of 50 calls
  five times over and device ms (``kernel_f_step``, no frames); kernel H
  on octaves 0-3 of the first 8 SIFT frames, both modes, CUDA-event ms
  and device ms (``kernel_h``).

``--paths`` picks some of ``video, stream, config2, multivideo, sfm_orb,
sfm_sift, kernels, kernels_ef, kernel_f_step, kernel_h`` (all by default), to
repeat a comparison
where it is noisy.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import importlib.util
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SPECS = {"video": (96, 1080, 1920, 300, 0), "sfm": (96, 540, 960, 400, 0),
         "sift": (96, 1080, 1920, 400, 0), "c2": (500, 1080, 1920, 400, 0)}
# the frame sets each path reads
PATHS = {"video": ("video",), "stream": ("video",), "config2": ("c2",),
         "multivideo": ("mv",), "sfm_orb": ("sfm",), "sfm_sift": ("sift",),
         "kernels": ("video", "sift"), "kernels_ef": (),
         "kernel_f_step": (), "kernel_h": ("sift",)}
# kernel H's kernels by the name the profiler reports, in either tree
H_KERNELS = ("blur_level_kernel", "blur_window_kernel", "gates_kernel")
MV_VIDEOS, MV_SPEC = 6, (48, 540, 960, 300)
SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
# kernel E's (batch, matches): the live set, batch-1 sets (ORB and SIFT
# keyframe steps, twice the live size), the ORB and SIFT verification chunks
KERNEL_E_SHAPES = ((1, 2000), (1, 1000), (1, 1536), (1, 4000), (32, 1000),
                   (32, 1536))


def frames(smoke, cache: Path, keys) -> dict:
    """The uint8 frame sets ``keys`` (orbits of SPECS, "mv" the multi-video
    set), each from ``cache/<key>.npy`` or rendered into it."""
    missing = [k for k in keys if not (cache / f"{k}.npy").exists()]
    if missing:
        specs = [s for k in missing for s in (
            [MV_SPEC + (seed,) for seed in range(MV_VIDEOS)] if k == "mv"
            else [SPECS[k]])]
        with concurrent.futures.ProcessPoolExecutor(
                smoke.RENDER_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            out = iter(smoke.render_orbits(pool, specs))
        cache.mkdir(parents=True, exist_ok=True)
        for k in missing:
            got = (np.stack([next(out) for _ in range(MV_VIDEOS)])
                   if k == "mv" else next(out))
            np.save(cache / f"{k}.npy", got)
    return {k: np.load(cache / f"{k}.npy") for k in keys}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--cache", required=True)
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    paths = set(args.paths.split(","))
    if not paths <= set(PATHS):
        ap.error(f"--paths: one or more of {', '.join(PATHS)}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    from slam_loop_closing_tpu_torch.config import (LoopConfig, OrbConfig,
                                                    PipelineConfig)
    from slam_loop_closing_tpu_torch.models import sfm
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import matching, orb
    from slam_loop_closing_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA device", file=sys.stderr)
        return 1
    if not str(Path(ck.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {ck.__file__}, not the tree {root}")
    dev = "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rec = {"root": str(root), "card": card}
    t0 = time.perf_counter()
    cuda_build.load()
    rec["build_s"] = time.perf_counter() - t0
    fr = frames(smoke, Path(args.cache),
                sorted({k for p in paths for k in PATHS[p]}))

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    # process_video, resident
    cfg = smoke.slice_config()
    if "video" in paths:
        video = torch.from_numpy(fr["video"]).to(dev)
        LoopClosingSystem(cfg, max_frames=96, device=dev).process_video(video)
        rec["process_video_ms"] = [1e3 * synced(lambda: LoopClosingSystem(
            cfg, max_frames=96, device=dev).process_video(video))[0]
            for _ in range(5)]
        device_split(smoke, lambda: LoopClosingSystem(
            cfg, max_frames=96, device=dev).process_video(video),
            "process_video", rec)
        del video

    # process_stream from host memory
    def stream_pass():
        system = LoopClosingSystem(cfg, max_frames=smoke.MAX_FRAMES,
                                   log=lambda _: None, device=dev)
        lat, t_prev = [], time.perf_counter()
        for _ in system.process_stream(fr["video"]):
            t = time.perf_counter()
            lat.append(1e3 * (t - t_prev))
            t_prev = t
        return lat

    if "stream" in paths:
        stream_pass()
        lats = [stream_pass() for _ in range(2)]
        rec["process_stream_median_ms"] = [float(np.median(x)) for x in lats]
        rec["process_stream_p90_ms"] = [float(np.percentile(x, 90))
                                        for x in lats]
        # 8 more frames on a filled database, as chip_smoke.py profiles them
        system = LoopClosingSystem(cfg, max_frames=smoke.MAX_FRAMES,
                                   log=lambda _: None, device=dev)
        for _ in system.process_stream(fr["video"]):
            pass
        device_split(smoke, lambda: list(system.process_stream(
            fr["video"][:8])), "process_stream_8_frames", rec)
        del system

    # config 2: front-end in batches of 50, then the dense counts
    ocfg = OrbConfig(num_features=smoke.C2_FEATURES, grid_cell=8)
    pattern = orb.brief_matrices(ocfg, dev)

    def front_end():
        return smoke.config2_front_end(c2, ocfg, pattern, dev)

    def dense(store):
        return matching.dense_pair_counts_chunked(
            *store, min_gap=1, pairs_per_call=smoke.C2_PAIRS_PER_CALL)

    if "config2" in paths:
        c2 = torch.from_numpy(fr["c2"]).to(dev)
        store = front_end()
        dense(store)
        rec["config2_front_end_s"], rec["config2_dense_s"] = [], []
        for _ in range(2):
            del store
            t_fe, store = synced(front_end)
            rec["config2_front_end_s"].append(t_fe)
            rec["config2_dense_s"].append(synced(lambda: dense(store))[0])
        del store
        device_split(smoke, front_end, "config2_front_end", rec)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        store = front_end()
        torch.cuda.synchronize()
        rec["config2_front_end_peak_gb"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
        del store, c2
        torch.cuda.empty_cache()

    # several videos at once
    mcfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=smoke.MV_FEATURES),
        loop=LoopConfig(min_loop_gap=max(3, MV_SPEC[0] // 3)))
    if "multivideo" in paths:
        LoopClosingSystem.process_videos_batched(fr["mv"], mcfg, device=dev)
        rec["multivideo_ms"] = [1e3 * synced(
            lambda: LoopClosingSystem.process_videos_batched(
                fr["mv"], mcfg, device=dev))[0] for _ in range(3)]

    # Version-B, resident, no OBJ
    for name, key, det in (("sfm_orb", "sfm", "orb"),
                           ("sfm_sift", "sift", "sift")):
        if name not in paths:
            continue
        scfg = smoke.sfm_config(det)
        x = torch.from_numpy(fr[key]).to(dev)

        def build():
            return smoke.sfm_pipeline(scfg, x.shape[0], dev)

        build().run(x, write_obj=False)
        rec[f"{name}_s"] = [synced(lambda: build().run(
            x, write_obj=False))[0] for _ in range(2)]
        pipe = build()
        t_fe = synced(lambda: pipe._frontend(x))[0]
        t_kf, (state, _) = synced(
            lambda: pipe.run_frontend_and_keyframes_scan(x))
        t_loop, loop = synced(lambda: pipe.find_loop(state))
        t_be = synced(lambda: pipe.run_backend(state, loop))[0]
        rec[f"{name}_stages_s"] = {"front_end": t_fe,
                                   "keyframe_pass": t_kf - t_fe,
                                   "find_loop": t_loop, "backend": t_be}
        if name == "sfm_sift":
            prof = smoke.profiled(lambda: build().run(x, write_obj=False))[1]
            events = prof.key_averages()
            busy = {e.key: getattr(e, "self_device_time_total", 0.0) / 1e3
                    for e in events}
            rec["sfm_sift_h_device_ms"] = sum(
                t for k, t in busy.items() if any(n in k for n in H_KERNELS))
            rec["sfm_sift_device_ms"] = sum(busy.values())
        del x, pipe, state
        torch.cuda.empty_cache()

    if "kernels_ef" in paths:
        kernels_ef(smoke, ck, dev, rec)
    if "kernel_f_step" in paths:
        kernel_f_step(smoke, ck, dev, rec)
    if "kernel_h" in paths:
        kernel_h(smoke, ck, fr["sift"], dev, rec)

    # kernels A and G at their shapes
    if "kernels" not in paths:
        print(json.dumps(rec), flush=True)
        return 0
    thr = 20.0 / 255.0
    levels = [lv.contiguous() for lv in image_ops.pyramid(
        image_ops.ship_frames(torch.from_numpy(fr["video"][:8]).to(dev),
                              dev), 4, 1.2)]
    rec["kernel_a_ms"] = sum(smoke.cuda_ms(
        lambda: ck.fast_score_nms_blur(lv, thr), 20) for lv in levels)
    pipe = sfm.SfMPipeline(smoke.sfm_config("sift"), max_keyframes=96,
                           log=lambda *a: None, device=dev)
    desc, vd = (t.contiguous() for t in pipe._frontend(fr["sift"])[:2])
    pairs = [(c, p) for c in range(48, 96) for p in range(c - 47)]
    qi, ti = (t.contiguous() for t in torch.tensor(
        pairs, dtype=torch.int32, device=dev).T)
    rec["kernel_g_loop_ms"] = smoke.cuda_ms(
        lambda: ck.l2_knn2(desc, vd, desc, vd, qi, ti), 5)
    rec["kernel_g_step_ms"] = smoke.cuda_ms(
        lambda: ck.l2_knn2(desc, vd, desc, vd, qi[-1:], ti[-1:]), 50)
    print(json.dumps(rec), flush=True)
    return 0


def device_split(smoke, fn, name: str, rec: dict, top: int = 8) -> None:
    """One run of ``fn`` under the profiler: its wall seconds, the summed
    device ms of all its kernels and of the ``top`` kernels by device time
    (named by the profiler, so either tree's kernels show), into ``rec``."""
    _, prof, wall = smoke.profiled(fn)
    busy = {}
    for e in prof.key_averages():
        busy[e.key] = busy.get(e.key, 0.0) + getattr(
            e, "self_device_time_total", 0.0) / 1e3
    rec[f"{name}_profiled_wall_ms"] = wall * 1e3
    rec[f"{name}_device_ms"] = sum(busy.values())
    rec[f"{name}_top_kernels_ms"] = {
        k[:60]: round(v, 4) for k, v in sorted(
            busy.items(), key=lambda kv: -kv[1])[:top]}


def kernels_ef(smoke, ck, dev, rec: dict) -> None:
    """Kernels E and F at their main paths' shapes, into ``rec``."""
    import torch

    # kernel E at the live set, batch-1 sets and the verification chunks
    rng = np.random.default_rng(1)
    radii = smoke.sfm_support_radii()
    for batch, n in KERNEL_E_SHAPES:
        args = smoke.support_set(rng, batch, n, dev, *radii)[0]
        rec[f"kernel_e_{batch}x{n}_ms"] = smoke.cuda_ms(
            lambda: ck.motion_support(*args), 50)
        rec[f"kernel_e_{batch}x{n}_device_ms"] = smoke.device_ms(
            lambda: ck.motion_support(*args), 50)
    # kernel F at the keyframe step's pair and the loop search's 300 pairs
    packed, vt, (one_q, one_t), (qi, ti) = knn2_inputs(smoke, dev)
    for name, (q, t) in (("step", (one_q, one_t)), ("loop", (qi, ti))):
        rec[f"kernel_f_{name}_ms"] = smoke.cuda_ms(
            lambda: ck.hamming_knn2(packed, vt, packed, vt, q, t), 50)
        rec[f"kernel_f_{name}_device_ms"] = smoke.device_ms(
            lambda: ck.hamming_knn2(packed, vt, packed, vt, q, t), 50)



def knn2_inputs(smoke, dev):
    """``chip_smoke.knn2_store``'s store and validity, the keyframe step's
    pair and the loop search's 300 pairs, as kernel F takes them."""
    import torch

    packed, vt, _, pairs = smoke.knn2_store(np.random.default_rng(2), dev)
    loop = tuple(t.contiguous() for t in torch.tensor(
        pairs, dtype=torch.int32, device=dev).T)
    k = smoke.SFM_STORE
    step = tuple(torch.tensor([f], dtype=torch.int32, device=dev)
                 for f in (k - 1, k - 2))
    return packed, vt, step, loop


def kernel_h(smoke, ck, frames, dev, rec: dict) -> None:
    """Kernel H on octaves 0-3 of the SIFT path's first chunk of frames,
    with and without the response, into ``rec``: CUDA-event ms a call (20
    calls) and device ms."""
    import torch

    from slam_loop_closing_tpu_torch.ops import sift
    from slam_loop_closing_tpu_torch.ops.image import ship_frames

    cfg = smoke.sfm_config("sift").sift
    s = cfg.scales_per_octave
    sig = sift._chain_sigmas(s, cfg.sigma0)
    args = (s, sift._contrast_threshold(cfg), cfg.edge_threshold)
    imgs = ship_frames(torch.from_numpy(frames[:cfg.batch_chunk]).to(dev),
                       dev)
    for o, x in enumerate(smoke.sift_octaves(imgs, smoke.SIFT_OCTAVES)):
        for emit, mode in ((True, "resp"), (False, "gauss")):
            def call():
                return ck.gauss_stack_resp(x, sig, *args, emit_resp=emit)

            rec[f"kernel_h_o{o}_{mode}_ms"] = smoke.cuda_ms(call, 20)
            rec[f"kernel_h_o{o}_{mode}_device_ms"] = smoke.device_ms(call, 20)


def kernel_f_step(smoke, ck, dev, rec: dict) -> None:
    """Kernel F at the keyframe step's one pair, into ``rec``: CUDA-event ms
    a call over 50 back-to-back calls, five times, and device ms."""
    packed, vt, (q, t), _ = knn2_inputs(smoke, dev)

    def call():
        return ck.hamming_knn2(packed, vt, packed, vt, q, t)

    rec["kernel_f_step_ms_runs"] = [smoke.cuda_ms(call, 50) for _ in range(5)]
    rec["kernel_f_step_device_ms"] = smoke.device_ms(call, 50)


if __name__ == "__main__":
    sys.exit(main())
