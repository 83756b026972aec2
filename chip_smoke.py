"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds the kernels of
``slam_loop_closing_tpu_torch/csrc`` into ``build/torch_kernels/``. Phases,
each printed with its result and seconds on its own line:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: nvcc of every kernel, one process per source in parallel (the
   ptxas register/spill lines are printed);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (bitwise for integer outputs, the FAST
   score and the blur), with CUDA-event times of both;
4. slice process_video: ``LoopClosingSystem(device="cuda").process_video``
   on 96 frames of 1080p synthetic closed-loop video at ORB-2000 with one
   keypoint per 8-px cell — kernels A, B and C must launch, the orbit's
   closing loop must be found, every loop must respect the gap;
5. slice process_stream: the live per-frame API on the same 96 frames from
   host memory (``max_frames=512``, the README's assumed camera): a
   warm-up pass that counts the host syncs per frame, a timed pass —
   kernels A, B, D, E and the frame-pair count must launch, the loop set
   must equal process_video's, frame 1's pose must be accepted with
   triangulated points — then the stage split of a few frames;
6. agreement: two 1080p frames through the ORB front-end on the CPU
   (plain versions) and on the card: bitwise pyramids, identical
   keypoints, identical descriptors wherever the orientation bin agrees;
   then the 32-frame 144x192 fixture of the tests through process_video and
   through process_frame on the CPU and on the card: equal loop sets.

Each main path runs with the launch counts set to 0 just before it and read
just after. Any failure raises (exit code 1). The line before the last is
the kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

FRAMES, H, W = 96, 1080, 1920
NUM_FEATURES = 2000
MAX_FRAMES = 512          # the live database (bench_incremental.py's size)
PKG = "slam_loop_closing_tpu/ops/pallas_kernels.py"
REPLACES = {"fast_score_nms_blur": f"{PKG}:736",     # _fast_kernel
            "extract_patches": f"{PKG}:1062",         # _patch_kernel
            "band_count_tiles": f"{PKG}:356",         # _band_d1_kernel (+ :538)
            "pair_counts": f"{PKG}:378",              # _pair_d1_kernel
            "hamming_nn": f"{PKG}:57",                # _hamming_nn_kernel
            "motion_support": f"{PKG}:649"}           # _support_kernel
SOURCES = {"fast_score_nms_blur": "fast_score_nms_blur.cu",
           "extract_patches": "extract_patches.cu",
           "band_count_tiles": "band_counts.cu",
           "pair_counts": "band_counts.cu",
           "hamming_nn": "hamming_nn.cu",
           "motion_support": "motion_support.cu"}
VIDEO_KERNELS = ("fast_score_nms_blur", "extract_patches", "band_count_tiles")
STREAM_KERNELS = ("fast_score_nms_blur", "extract_patches", "pair_counts",
                  "hamming_nn", "motion_support")


def phase(name: str, t0: float, result: str) -> None:
    print(f"[{name}] {result} ({time.perf_counter() - t0:.2f} s)", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_ulp(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    import torch

    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def to_u8(frames: np.ndarray) -> np.ndarray:
    return (np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)


def slice_config():
    """bench_incremental.py's configuration: ORB-2000, one keypoint per
    8-px cell, the README's assumed camera, default loop and RANSAC rules."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig, OrbConfig,
                                                    PipelineConfig)

    return dataclasses.replace(
        PipelineConfig(), camera=CameraConfig.assumed(),
        orb=OrbConfig(num_features=NUM_FEATURES, grid_cell=8))


def check_bitwise(name: str, got, ref) -> None:
    import torch

    for g, r in zip(got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"{name} differs from its plain version")


def check_kernels(frames_dev, dev) -> dict:
    """Each kernel against its plain version at main-path shapes; returns
    {name: record} with the error and both times."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import matching

    records = {}
    thr = 20.0 / 255.0

    # A: 8 frames at each 1080p pyramid level shape (odd widths included)
    t0 = time.perf_counter()
    levels = image_ops.pyramid(image_ops.ship_frames(frames_dev[:8], dev),
                               4, 1.2)
    err, ulp, ms, plain_ms = 0.0, 0, 0.0, 0.0
    for lv in levels:
        lv = lv.contiguous()
        score, blur = ck.fast_score_nms_blur(lv, thr)
        ref_s, ref_b = ck.fast_score_nms_blur_plain(lv, thr)
        if not torch.equal(score, ref_s):
            raise AssertionError(f"FAST score+NMS differs at {tuple(lv.shape)}")
        ulp = max(ulp, max_ulp(blur, ref_b))
        err = max(err, float((blur - ref_b).abs().max()))
        ms += cuda_ms(lambda: ck.fast_score_nms_blur(lv, thr), 10)
        plain_ms += cuda_ms(lambda: ck.fast_score_nms_blur_plain(lv, thr), 3)
    if ulp > 0:
        raise AssertionError(f"blur differs from the plain version by {ulp} ulp")
    records["fast_score_nms_blur"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms)
    phase("kernel A fast_score_nms_blur", t0,
          f"4 levels x 8 frames {[tuple(lv.shape[1:]) for lv in levels]}: "
          f"score bitwise, blur {ulp} ulp; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")

    # B: 2000 keypoints per frame on all 96 blurred 1080p frames, some at
    # the borders (clamped windows)
    t0 = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(0)
    imgs = image_ops.ship_frames(frames_dev, dev)
    b, h, w = imgs.shape
    xs = torch.randint(0, w, (b, NUM_FEATURES), generator=g)
    ys = torch.randint(0, h, (b, NUM_FEATURES), generator=g)
    xy = torch.stack([xs, ys], -1).to(torch.float32).to(dev)
    got = ck.extract_patches(imgs, xy)
    ref = ck.extract_patches_plain(imgs, xy)
    if not torch.equal(got, ref):
        raise AssertionError("patch gather differs")
    ms = cuda_ms(lambda: ck.extract_patches(imgs, xy), 10)
    plain_ms = cuda_ms(lambda: ck.extract_patches_plain(imgs, xy), 3)
    records["extract_patches"] = dict(max_abs_err=float((got - ref).abs().max()),
                                      ms=ms, plain_ms=plain_ms)
    phase("kernel B extract_patches", t0,
          f"{b} frames x {NUM_FEATURES} keypoints: bitwise; kernel {ms:.3f} ms,"
          f" plain {plain_ms:.3f} ms")
    del imgs, got, ref

    # C: the band of 96 frames x 2000 descriptors at gap 30, 16-frame tiles
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    signed = (rng.integers(0, 2, (FRAMES, NUM_FEATURES, 256)) * 2 - 1).astype(
        np.int8)
    valid = rng.random((FRAMES, NUM_FEATURES)) < 0.95
    valid[7] = False                                  # an all-invalid frame
    signed[40, :50] = signed[3, :50]                  # exact duplicates
    signed = np.where(valid[..., None], signed, 0).astype(np.int8)
    packed = desc_ops.signed_to_packed(torch.from_numpy(signed).to(dev))
    vt = torch.from_numpy(valid).to(dev)
    block = 16
    pairs = matching.band_tiles(FRAMES // block, block, 30)
    qidx, tidx = torch.tensor(pairs, dtype=torch.int32, device=dev).T
    got = ck.band_count_tiles(packed, vt, qidx, tidx, block)
    ref = ck.band_count_tiles_plain(packed, vt, qidx, tidx, block)
    if not torch.equal(got, ref):
        raise AssertionError("band counts differ")
    ms = cuda_ms(lambda: ck.band_count_tiles(packed, vt, qidx, tidx, block), 5)
    plain_ms = cuda_ms(
        lambda: ck.band_count_tiles_plain(packed, vt, qidx, tidx, block), 2)
    records["band_count_tiles"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
    phase("kernel C band_count_tiles", t0,
          f"{len(pairs)} tiles of {block}x{block} frames x {NUM_FEATURES} "
          f"descriptors: bitwise (max count {int(got.max())}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    del got, ref, packed, vt
    records.update(check_live_kernels(dev))
    return records


def check_live_kernels(dev) -> dict:
    """Kernels D, E and the frame-pair count at the live path's shapes."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops

    records = {}
    rng = np.random.default_rng(1)
    n = NUM_FEATURES

    # K5: one query frame against a 512-frame database, in place
    t0 = time.perf_counter()
    signed = (rng.integers(0, 2, (MAX_FRAMES, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((MAX_FRAMES, n)) < 0.95
    valid[7] = False                                  # an all-invalid frame
    signed[MAX_FRAMES - 1, :300] = signed[3, :300]    # a revisit
    valid[MAX_FRAMES - 1, :300] = valid[3, :300] = True
    signed = np.where(valid[..., None], signed, 0).astype(np.int8)
    packed = desc_ops.signed_to_packed(torch.from_numpy(signed).to(dev))
    del signed
    vt = torch.from_numpy(valid).to(dev)
    tidx = torch.arange(MAX_FRAMES, dtype=torch.int32, device=dev)
    qidx = torch.full_like(tidx, MAX_FRAMES - 1)
    got = ck.pair_counts(packed, vt, qidx, tidx)
    ref = ck.pair_counts_plain(packed, vt, qidx, tidx)
    check_bitwise("pair_counts", [got], [ref])
    if int(got[3]) < 300 or int(got[7]) != 0:
        raise AssertionError("pair counts miss the revisit or count an empty "
                             "frame")
    ms = cuda_ms(lambda: ck.pair_counts(packed, vt, qidx, tidx), 10)
    plain_ms = cuda_ms(lambda: ck.pair_counts_plain(packed, vt, qidx, tidx), 2)
    records["pair_counts"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
    phase("kernel K5 pair_counts", t0,
          f"1 x {MAX_FRAMES} frames x {n} descriptors: bitwise (revisit "
          f"count {int(got[3])}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del packed, vt, got, ref
    torch.cuda.empty_cache()

    # D: 2000 x 2000 descriptors, duplicated targets, invalid rows, and an
    # all-invalid target set
    t0 = time.perf_counter()
    sq = (rng.integers(0, 2, (n, 256)) * 2 - 1).astype(np.int8)
    st = (rng.integers(0, 2, (n, 256)) * 2 - 1).astype(np.int8)
    st[n // 2:n // 2 + 100] = st[:100]
    sq[:100] = st[:100]                               # ties at distance 0
    pq = desc_ops.signed_to_packed(torch.from_numpy(sq).to(dev))
    pt = desc_ops.signed_to_packed(torch.from_numpy(st).to(dev))
    vq = torch.from_numpy(rng.random(n) < 0.95).to(dev)
    vt = torch.from_numpy(rng.random(n) < 0.95).to(dev)
    vt[:100] = True
    err = 0
    for valid_t in (vt, torch.zeros_like(vt)):
        got = ck.hamming_nn(pq, vq, pt, valid_t)
        ref = ck.hamming_nn_plain(pq, vq, pt, valid_t)
        check_bitwise("hamming_nn", got, ref)
        err = max(err, int((got[0] - ref[0]).abs().max()))
    ms = cuda_ms(lambda: ck.hamming_nn(pq, vq, pt, vt), 20)
    plain_ms = cuda_ms(lambda: ck.hamming_nn_plain(pq, vq, pt, vt), 5)
    records["hamming_nn"] = dict(max_abs_err=float(err), ms=ms,
                                 plain_ms=plain_ms)
    phase("kernel D hamming_nn", t0,
          f"{n} x {n} descriptors (+ all-invalid targets): bitwise; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")

    # E: 2000 matches in normalized coordinates at the system's radius/tau
    t0 = time.perf_counter()
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    system = LoopClosingSystem(slice_config(), max_frames=1, device=dev)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    flow = 12.0 + 0.02 * (xy - [W / 2, H / 2]) + rng.normal(0, 1.5, (n, 2))
    flow[: n // 4] = rng.uniform(-200, 200, (n // 4, 2))  # outliers
    f = np.array([800.0, 800.0])
    c = np.array([640.0, 360.0])
    xq = torch.from_numpy(((xy - c) / f).astype(np.float32)).to(dev)
    xt = torch.from_numpy(((xy - flow - c) / f).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    args = (xq, xt, mask, system._radius, system._tau)
    got = ck.motion_support(*args)
    ref = ck.motion_support_plain(*args)
    check_bitwise("motion_support", [got], [ref])
    ms = cuda_ms(lambda: ck.motion_support(*args), 20)
    plain_ms = cuda_ms(lambda: ck.motion_support_plain(*args), 5)
    records["motion_support"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
    phase("kernel E motion_support", t0,
          f"{n} matches, radius {system._radius:.4f} tau {system._tau:.4f} "
          f"(normalized): bitwise (max support {int(got.max())}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return records


def run_slice(frames_dev, dev):
    """The batched main path at full width; returns the launch counts of
    the timed run and its loops."""
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    cfg = slice_config()
    gap = cfg.loop.min_loop_gap
    LoopClosingSystem(cfg, max_frames=FRAMES, device=dev).process_video(
        frames_dev)                                   # warm-up
    system = LoopClosingSystem(cfg, max_frames=FRAMES, device=dev)
    timer = StageTimer(dev)
    ck.reset_launch_counts()
    with timer.stage("process_video"):
        loops = system.process_video(frames_dev)
    launches = dict(ck.LAUNCHES)
    wall = timer.stages["process_video"]
    if not all(launches[k] for k in VIDEO_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    if not loops:
        raise AssertionError("no loop closures on a closed-loop orbit")
    bad = [c for c in loops if c.current_frame_id - c.matched_frame_id < gap]
    if bad:
        raise AssertionError(f"loops violate the gap: {bad[:3]}")
    if not any(c.current_frame_id >= 3 * FRAMES // 4
               and c.matched_frame_id <= FRAMES // 4 for c in loops):
        raise AssertionError("the orbit's closing loop was not found")
    phase("slice process_video", t0,
          f"{FRAMES} x {H}x{W} ORB-{NUM_FEATURES} grid 8: {len(loops)} loops,"
          f" closing loop found; warm run {wall * 1e3:.1f} ms = "
          f"{timer.frames_per_sec(FRAMES):.1f} frames/s; launches {launches}")
    return launches, loops


def count_syncs(system, frames_u8):
    """One process_stream pass under torch's sync debug mode: the host
    syncs of every frame (each implicit one warns; the frame's readback is
    one explicit stream synchronize, counted by hand if it does not warn)
    and their source lines."""
    import torch

    per_frame, sources = [], collections.Counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            seen = 0
            for _ in system.process_stream(frames_u8):
                new = [w for w in rec[seen:]
                       if "synchroniz" in str(w.message)]
                seen = len(rec)
                per_frame.append(len(new))
                sources.update(f"{Path(w.filename).name}:{w.lineno}"
                               for w in new)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return per_frame, sources


def run_stream(frames_u8: np.ndarray, dev, video_loops) -> dict:
    """The live main path at full width: process_stream over host uint8
    frames. Returns the launch counts of the timed pass."""
    import torch

    from slam_loop_closing_tpu_torch.models.loop_closing import (
        LoopClosingSystem, _first_hit, _readback)
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    cfg = slice_config()
    gap = cfg.loop.min_loop_gap

    def build():
        return LoopClosingSystem(cfg, max_frames=MAX_FRAMES,
                                 log=lambda _: None, device=dev)

    syncs, sources = count_syncs(build(), frames_u8)      # also the warm-up
    system = build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    lat = []
    t_prev = time.perf_counter()
    for _ in system.process_stream(frames_u8):
        t = time.perf_counter()
        lat.append(t - t_prev)
        t_prev = t
    launches = dict(ck.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(launches[k] for k in STREAM_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    loops = system.get_loop_closures()
    pairs = {(c.current_frame_id, c.matched_frame_id) for c in loops}
    ref = {(c.current_frame_id, c.matched_frame_id) for c in video_loops}
    if pairs != ref:
        raise AssertionError(f"process_stream found {len(pairs)} loops, "
                             f"process_video {len(ref)}; "
                             f"{len(pairs ^ ref)} differ")
    if any(c.current_frame_id - c.matched_frame_id < gap for c in loops):
        raise AssertionError("a loop violates the gap")
    f1 = system.get_frames()[1]
    if np.allclose(f1.pose, np.eye(4)) or len(f1.points3d) <= 10:
        raise AssertionError(f"frame 1: pose accepted "
                             f"{not np.allclose(f1.pose, np.eye(4))}, "
                             f"{len(f1.points3d)} points")
    lat_ms = np.asarray(lat) * 1e3
    accepted = sum(not np.allclose(f.pose, np.eye(4))
                   for f in system.get_frames()[1:])
    phase("slice process_stream", t0,
          f"{FRAMES} x {H}x{W} uint8 from host, ORB-{NUM_FEATURES} grid 8, "
          f"max_frames {MAX_FRAMES}: {len(loops)} loops = process_video's; "
          f"poses accepted {accepted}/{FRAMES - 1}, frame 1 "
          f"{len(f1.points3d)} points; per-frame latency median "
          f"{np.median(lat_ms):.2f} ms, p90 {np.percentile(lat_ms, 90):.2f} "
          f"ms, max {lat_ms.max():.2f} ms (frame 0 {lat_ms[0]:.2f} ms, "
          f"frames >= gap median {np.median(lat_ms[gap:]):.2f} ms); peak "
          f"device memory {peak_gb:.2f} GB; launches {launches}")
    print(f"  latency ms per frame: {[round(x, 2) for x in lat_ms.tolist()]}")
    print(f"  host syncs per frame (warm-up pass): median "
          f"{int(np.median(syncs))}, frames < gap median "
          f"{int(np.median(syncs[1:gap]))}, frames >= gap median "
          f"{int(np.median(syncs[gap:]))}, max {max(syncs)}, first frame "
          f"{syncs[0]}")
    for src, cnt in sources.most_common():
        print(f"  sync source {src}: {cnt} in {FRAMES} frames")

    # stage split of frames >= gap on the filled database
    timer = StageTimer(dev)
    span = range(60, 70)
    for i in span:
        img = torch.from_numpy(frames_u8[i]).to(dev)
        with timer.stage("front-end"):
            system.detect_features(img)
        with timer.stage("geometry"):
            system._geometry(i, i - 1)
        with timer.stage("scan"):
            counts, sims = system._scan_scores(i)
            jstar, _ = _first_hit(counts, sims, cfg.loop.loop_threshold,
                                  cfg.loop.min_matches)
        with timer.stage("re-geometry"):
            geom = system._geometry(i, jstar)
        with timer.stage("readback"):
            _readback({"g": geom, "s": (counts, sims)})
    split = {k: v * 1e3 / len(span) for k, v in timer.stages.items()}
    phase("slice stage split", t0, "per frame over frames 60-69, each stage "
          "synchronized: " + ", ".join(f"{k} {v:.2f} ms"
                                       for k, v in split.items()))

    # device idle share of the live path: 8 more frames under the profiler
    t0 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_w = time.perf_counter()
        for _ in system.process_stream(frames_u8[:8]):
            pass
        wall = time.perf_counter() - t_w
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e6
    phase("slice idle share", t0, f"8 frames in {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.1f} ms (profiler self device time): idle share "
          f"{max(0.0, 1.0 - busy / wall):.0%}")
    return launches


def check_front_end_agreement(frames_dev, dev) -> None:
    """Two 1080p frames through the ORB front-end on the CPU (plain
    versions) and on the card (kernels, cuBLAS): bitwise pyramids and
    identical keypoints; at most 1% of them in another orientation bin
    (R2: the moment product sums in another order), identical descriptors
    wherever the bin agrees."""
    import torch

    from slam_loop_closing_tpu_torch.config import OrbConfig
    from slam_loop_closing_tpu_torch.ops import orb
    from slam_loop_closing_tpu_torch.ops.image import pyramid, ship_frames

    t0 = time.perf_counter()
    cfg = OrbConfig(num_features=NUM_FEATURES, grid_cell=8)
    out = {}
    for d in ("cpu", dev):
        imgs = ship_frames(frames_dev[:2].to(d), d)
        f = orb.detect_and_describe_batch(imgs, cfg)
        out[d] = [t.cpu() for t in (f.keypoints.valid, f.keypoints.xy,
                                    f.keypoints.angle, f.signed)]
        out[d].append([lv.cpu() for lv in pyramid(imgs, cfg.num_levels,
                                                  cfg.scale_factor)])
    (v0, xy0, a0, s0, p0), (v1, xy1, a1, s1, p1) = out["cpu"], out[dev]
    bad_px = [int((a != b).sum()) for a, b in zip(p0, p1)]
    if any(bad_px):
        raise AssertionError(f"pyramid differs between cpu and card: {bad_px}"
                             " pixels per level")
    if not (torch.equal(v0, v1) and torch.equal(xy0, xy1)):
        raise AssertionError("1080p keypoints differ between cpu and card")
    step = torch.tensor(2 * np.pi / 30, dtype=torch.float32)
    same = (torch.remainder(torch.round(a0 / step), 30)
            == torch.remainder(torch.round(a1 / step), 30)) & v0
    moved = int((v0 & ~same).sum())
    if moved > 0.01 * int(v0.sum()):
        raise AssertionError(f"{moved} keypoints changed orientation bin")
    if not torch.equal(s0[same], s1[same]):
        rows = int((s0[same] != s1[same]).any(-1).sum())
        raise AssertionError(f"descriptors differ where the bins agree: "
                             f"{rows} of {int(same.sum())} rows")
    phase("agreement front-end 1080p cpu vs card", t0,
          f"pyramid bitwise, {int(v0.sum())} keypoints identical, {moved} in "
          "another bin, "
          f"max angle difference {float((a0 - a1)[v0].abs().max()):.2e} rad,"
          f" descriptors equal where bins agree")


def check_cpu_agreement(dev) -> None:
    """The tests' 32-frame fixture through the plain path on the CPU and
    the kernels on the card, batched and frame by frame: the loop sets must
    be equal."""
    from slam_loop_closing_tpu_torch.config import (LoopConfig, OrbConfig,
                                                    PipelineConfig)
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

    t0 = time.perf_counter()
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=300, num_levels=2),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=20, frame_skip=1))
    frames = orbit_sequence(num_frames=32, h=144, w=192, num_points=250, seed=3)
    for path in ("process_video", "process_frame"):
        got = {}
        for d in ("cpu", dev):
            system = LoopClosingSystem(cfg, max_frames=32, log=lambda _: None,
                                       device=d)
            if path == "process_video":
                system.process_video(frames)
            else:
                for frame in frames:
                    system.process_frame(frame)
            got[d] = {(c.current_frame_id, c.matched_frame_id): c.num_matches
                      for c in system.get_loop_closures()}
        if set(got["cpu"]) != set(got[dev]):
            raise AssertionError(f"{path} loop sets differ: cpu "
                                 f"{sorted(got['cpu'])} vs card "
                                 f"{sorted(got[dev])}")
        diff = max(abs(got["cpu"][k] - got[dev][k]) for k in got["cpu"])
        phase(f"agreement cpu vs card, {path}", t0,
              f"{len(got['cpu'])} loops, equal sets; max match-count "
              f"difference {diff}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.utils import cuda_build
    from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

    dev = "cuda"
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", t0, f"{name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = cuda_build.build()
    cuda_build.load()
    log = lib.with_suffix(".log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    phase("build", t0, f"{lib.name}")

    t0 = time.perf_counter()
    frames = to_u8(orbit_sequence(num_frames=FRAMES, h=H, w=W, num_points=300))
    frames_dev = torch.from_numpy(frames).to(dev)
    phase("frames", t0, f"{FRAMES} x {H}x{W} uint8 rendered, on the card")

    records = check_kernels(frames_dev, dev)
    video_launches, video_loops = run_slice(frames_dev, dev)
    stream_launches = run_stream(frames, dev, video_loops)
    check_front_end_agreement(frames_dev, dev)
    check_cpu_agreement(dev)

    kernels = [dict(name=k, route="cuda",
                    source=f"slam_loop_closing_tpu_torch/csrc/{SOURCES[k]}",
                    replaces=REPLACES[k],
                    launches=video_launches[k] + stream_launches[k],
                    **records[k])
               for k in ck.LAUNCHES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
