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
   score and the blur), with CUDA-event times of both; kernel A also on one
   1080p frame (the live path), on a 540x960 crop's levels (ORB SfM and
   multi-video) and on frames narrower than its 64 x 16 tile, with the
   share of pixels that pass its compass pre-test; kernel J (one pyramid
   level from the level before, both outputs) and kernel M (the keypoints'
   orientation from their patches) on the front-end's levels and keypoints
   of 8 1080p frames and of one (the live path), with A and B on the same
   levels and keypoints, J beside the dense cuBLAS products it replaced
   (their differing pixels counted) and M beside the moment product;
   kernel D also with its target split forced to 1 and 16, beside a bf16
   +-1 matmul and max on operands unpacked beforehand; kernel E also on
   single sets of 4,000 and 1,531 matches (its target rows split over
   blocks), with profiler device times beside the CUDA-event ones;
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
   keypoints, at most 1% of them in another orientation bin (the count
   printed), identical descriptors wherever the orientation bin agrees;
   then the 32-frame 144x192 fixture of the tests through process_video and
   through process_frame on the CPU and on the card: equal loop sets;
7. kernel F: the Hamming top-2 kernel against its plain version at the
   Version-B shapes (one 1,000 x 1,000 keyframe-pass pair, its target rows
   split over blocks; the loop search's pair list over a 48-keyframe store
   at gap 24; invalid query and target rows, an all-invalid keyframe,
   forced ties), bitwise, and kernel E over batches of 32 match sets (the
   ORB and SIFT verification chunks, 1,000 and 1,536 matches), each shape
   with CUDA-event and profiler device times beside its bound;
8. slice SfMPipeline.run: the Version-B pipeline at
   bench_reconstruct.py's configuration (96 x 540x960 uint8 orbit frames,
   ORB-1000 grid 8, its keyframe / loop-verify gates, 1,024 RANSAC
   hypotheses, ``use_scan=True``): a warm-up pass that counts the host
   syncs of the keyframe pass, a timed run from host memory that writes
   the OBJ under a temporary directory — kernels A, B, E, F and N must
   launch, the loop must be found, the final reprojection error must be
   below the error before BA — two timed runs on frames resident on the
   card (bench_reconstruct.py's contract, no OBJ), each bitwise equal to
   the run from host memory in poses, points, point validity and final
   error (F12: no deterministic mode), a synchronized stage split, and
   the device idle share under the profiler;
9. agreement SfM: the 24-frame 144x192 fixture of tests/test_torch_sfm.py
   through ``SfMPipeline.run`` on the CPU and on the card with the same
   RANSAC minimal sets fed to both (drawn once on the CPU, replayed on the
   card): equal front-end outputs, keyframes, loop pair and loop match
   count; the loop's inlier counts within 3, the map's point and
   observation counts within 1% and the reprojection errors within 10%
   (cuSOLVER's and LAPACK's SVDs differ in the last bits, which flips a
   few points at the Sampson and parallax gates, and the pose chain moves
   with them). The
   fixture runs at 512 hypotheses, not the tests' 128: at 128 the
   generator's own draws meet a RANSAC collapse at frame 19 (the JAX
   package collapses the same way on the same draws), no loop is found,
   and the phase would not reach the loop search;
10. kernels J (float32 mode), H, B and G at the SIFT path's shapes: J's
    float32 mode down the octave halvings of 8 1080p frames against its
    plain version, bitwise, beside the dense float32 cuBLAS products it
    replaced; the octave kernel H
    against its plain version in both modes (Gaussian stack and gated
    response; gauss only) on octaves 0-3 of 8 1080p frames, bitwise,
    and its time at each octave; kernel B on that octave 0's
    gradient maps at its keypoint slots (40x40 windows, center 19),
    bitwise; the squared-L2 top-2 kernel G on the keyframe store that
    ``SfMPipeline._frontend`` builds from the 96 frames (valid rows first,
    cut to the count bucket) at the keyframe step's pair and the loop
    search's 1,176 pairs at gap 48, d1 and d2 within 1e-5 with idx equal
    away from near-ties, beside cuBLAS's float32 ``bmm`` of the cross term
    alone on the same pairs (a yardstick of the dot work); the same store
    with its rows shuffled in every frame (valid rows not packed first),
    and a 1,001-row store of integer-valued descriptors (holes, an extent
    below the row count, empty query and target frames) at both pair
    lists, bitwise; as extra checks, G on 4,000-row stores of 48
    frames (300 pairs at gap 24): bitwise on integer-valued descriptors
    with invalid rows, an all-invalid keyframe and forced ties, and within
    1e-5 on the unpacked SIFT descriptors; CUDA-event times of all;
11. slice SfMPipeline.run SIFT: the Version-B pipeline at
    bench_reconstruct.py's SIFT configuration (96 x 1080x1920 uint8 orbit
    frames, SIFT-4000, flat selection, 4 octaves, chunks of 8, f = 0.8 w,
    the same gates and 1,024 hypotheses, ``use_scan=True``), measured as
    phase 8 — kernels B, E, G, H, J's float32 mode and N must launch, the
    loop must be found, the final reprojection error must be below the
    error before BA, every run bitwise equal to the first; before it, the
    SIFT front-end on 8 of those frames in chunks of 1, 4 and 8, every
    field bitwise equal (R17);
12. agreement SIFT: the 24-frame SIFT fixture of tests/test_torch_sfm.py
    (test_sfm_sift.py's configuration, at 256 hypotheses and 32 keyframe
    slots: at the tests' 128 the port's own draws break the keyframe chain
    early) on the CPU and on the card with the CPU's minimal
    sets replayed: at least 99% of the CPU's keypoints on the card, equal
    keyframes and loop pair, map counts within 1%, reprojection errors
    within 10% (R11's terms; the front-end is not bitwise across devices:
    CUDA's atan2 and exp differ from the CPU's in the last bit);
13. kernel I: the d1-only Hamming nearest-neighbour kernel (the tensor
    cores' b1 and-popc product, as kernels C and K5) against its
    plain version, bitwise, at 8192 x 8192 rows with every target valid
    (bench_hamming.py's shape; the target rows split over blocks) and at
    2000 x 2000 with a fifth of the targets invalid and with none valid;
    CUDA-event times, G row pairs/s, and the time of the +-1 bf16 matmul
    and ``amax`` on operands unpacked beforehand (the library form; it
    materialises the [M, N] block);
14. slice config 2: BASELINE config 2 at full width and depth — 500 frames
    of 1080p uint8 resident on the card, ORB-4000 grid 8, the front-end in
    batches of 50; kernels J, A, B and M against their plain versions on
    one such batch, at the front-end's own levels and per-level keypoints
    (bitwise);
    kernel I's pair-list form on the first chunk of 8,192 frame pairs of
    that store against its plain version (bitwise) and, after the count
    rule, against the frame-pair count kernel K5, both on the store as it
    is (the orbit fills every slot) and with 5% of its rows, part of a
    frame and two whole frames marked invalid; the pair route and the tile
    route on the first 192 frames with those holes (equal matrices); then
    ``dense_pair_counts_chunked(min_gap=1)`` warm and timed — one launch
    of kernel I per chunk of 8,192 pairs, counted — and the Version-A rule
    at gap 30 / 0.15 / 50 on the matrix (loops found, the closing loop
    among them); the peak device memory of each stage (the resident frames,
    one front-end batch step by step, the store, one dense chunk); on the
    same descriptors
    ``banded_pair_counts_chunked(min_gap=1)`` (kernel C's tiles), whose
    [F, F] matrix must equal the pair route's everywhere;
15. slice multi-video: ``process_videos_batched`` on 6 videos x 48 frames x
    540x960 uint8, ORB-1000, gap 16 (bench_multivideo.py's configuration):
    kernels J, A, B and M against their plain versions on one video's
    batch,
    kernel C against its plain version on the flat padded store of all six
    videos with every video's tile list (``matching.video_band_tiles``, what
    the path gives the kernel), bitwise; then the path: kernels A and B
    launch, kernel C exactly once, and every video's loops equal
    ``process_video`` on that video alone;
16. CLI: 32 frames of the 144x192 orbit written as ``frame_%04d.png``,
    ``cli.main(["loop", "--frames", dir, "--batched", ...])`` on the card —
    ``loop_closures.txt`` parses and its loops equal the library call's,
    the PNGs of ``save_results`` exist and decode —
    ``cli.main(["reconstruct", "--frames", dir, "--no-obj", ...])`` with
    phase 9's configuration as ``--config`` (most frames become keyframes,
    BA lowers the reprojection error, no OBJ is written), and six rendered
    chessboard views through ``cli.main(["calibrate", ...])``:
    RMS below 1 px;
17. the sharded paths (``slam_loop_closing_tpu_torch.parallel``) at world
    size 1 over NCCL, each where its inputs are made: ``frontend_sharded``
    on phase 4's frames (every field bitwise equal to
    ``detect_and_describe_batch``); ``sfm_reconstruct_sharded`` (with
    ``pgo_sharded`` and ``ba_sharded`` inside) on phase 8's frames against
    the staged single-device twin (keyframes, loop and point counts equal;
    a second twin run, the sharded run and every timed call bitwise equal
    to the first twin run in poses, points, point validity and final
    error, with no deterministic mode, and one twin run under
    ``torch.use_deterministic_algorithms(True)`` equal too: F12);
    ``verify_pairs_sharded`` on 256 synthetic pairs x 1,000 matches at
    1,024 hypotheses (every field equal to
    ``estimate_essential_ransac_pairs`` with the same noise);
    ``pgo_sharded`` at BASELINE config 5 (bench_pgo.py's 10,000-pose graph,
    PCG) bitwise equal to ``optimize_pose_graph``, as are a second run,
    every timed call and a run in deterministic mode; then kernel N
    against its plain version at the BA and PGO indices of those two
    paths, in every call the paths make there (one sum, or several in
    one launch; PGO's two-source sums), each timed by CUDA events and the
    profiler beside ``index_add_``, with the wrapper's host microseconds
    a call (timing printed, not gated);
    ``banded_loop_counts`` on
    phase 14's store at gap 30 (the ring's raw matrix zero exactly on the
    tiles the JAX rule skips and the pair route's elsewhere, the band
    bitwise, the same loops, one K5 launch a step);
    ``process_videos_sharded`` on phase 15's videos (loops equal);
    the native PNG decoder on phase 16's frames where it builds (within
    1/255 of PIL, both times); last the port's dry run. Each prints its
    wall, profiler device and NCCL-kernel ms and idle share; the
    ``{"sharded_paths": ...}`` line holds them.

Synthetic frames are rendered by a pool of worker processes (numpy only).
Each main path, the sharded ones included, runs with the launch counts
set to 0 just before it and read just after; process_video, process_stream (8 frames), both SfM runs, config
2 (front-end + dense) and the multi-video path also run once under the
profiler, which gives each kernel's summed device time over that path (the
line before the kernels' JSON); kernel N's launches and device ms on each
path that runs it are printed once every path has run (``[kernel N by
path]``, and ``by_path`` in its record). Any failure raises (exit code 1).
The line
before the last is the kernels' JSON record: each kernel's launches on the
main paths, its error against the plain version, its CUDA-event time and
the plain version's, and its bound (the larger of the bytes it must move
over 3.35 TB/s and the operations it does over the H100's rate for their
type, all from this run's inputs). The rates: the b1 tensor-core rate for
kernels C, K5, D, F and I (2 x 256 one-bit operations a row pair; NVIDIA
publishes no b1 rate for this card, so the peak is the instruction rate of
``mma.sync.m16n8k256.b1`` that ``csrc/probes/probe_hamming_forms.py``
measured); for kernels J (both modes), M and N, bound by bytes, their
float32 multiplies and adds on the FMA pipe; for kernel A the min/max and float32
instructions it issues, each at its pipe's instruction rate (FMNMX at half
the FFMA rate; the rates that ``csrc/probes/probe_rates.py`` measures
agree), the arc extrema
counted only for the pixels that pass the compass pre-test; for kernel G
three tf32 products a float32 one (3xTF32) at the card's dense tf32 rate;
float32 SIMT otherwise. ``library_ms`` is null (no single
PyTorch call computes the kernel's function) except for kernel I, where it
is the matmul-and-``amax`` form at 8192 x 8192, kernel D (the
matmul-and-``max`` form at 2000 x 2000), kernels J (both modes) and M,
where it is the cuBLAS form each replaced, and kernel N, where it is
``index_add_`` (float atomics) of the same rows (a ``library`` key says
which). The last
line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX; run
without the package beside it, it fails at the package's import.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

FRAMES, H, W = 96, 1080, 1920
NUM_FEATURES = 2000
MAX_FRAMES = 512          # the live database (bench_incremental.py's size)
PKG = "slam_loop_closing_tpu/ops/pallas_kernels.py"
REPLACES = {"fast_score_nms_blur": f"{PKG}:736",     # _fast_kernel
            "l2_knn2": f"{PKG}:256",                  # _l2_knn2_kernel
            "gauss_stack_resp": f"{PKG}:1421",        # _gauss_stack_resp_kernel
                                                      # (+ :1284)
            "extract_patches": f"{PKG}:1062",         # _patch_kernel
            "band_count_tiles": f"{PKG}:356",         # _band_d1_kernel (+ :538)
            "pair_counts": f"{PKG}:378",              # _pair_d1_kernel
            "hamming_nn": f"{PKG}:57",                # _hamming_nn_kernel
            "hamming_knn2": f"{PKG}:239",             # _hamming_knn2_kernel
            "motion_support": f"{PKG}:649",           # _support_kernel
            "hamming_d1": f"{PKG}:140",               # _hamming_d1_kernel
            # no TPU kernel: the XLA work of the JAX package's
            # resize_bilinear (its pyramid's matmuls) and
            # orientation_from_patches (the moment sums)
            "pyramid_level": "slam_loop_closing_tpu/ops/image.py:92",
            "orient_moments": "slam_loop_closing_tpu/ops/orb.py:176",
            # the SIFT octave halving (jax.image.resize's matmuls) and the
            # scatter-adds (.at[].add) of BA's and PGO's normal equations
            "resize_f32": "slam_loop_closing_tpu/ops/sift.py:456",
            "segment_sum": "slam_loop_closing_tpu/ops/ba.py:129-189, "
                           "slam_loop_closing_tpu/ops/pgo.py:93-138"}
SOURCES = {"fast_score_nms_blur": "fast_score_nms_blur.cu",
           "extract_patches": "extract_patches.cu",
           "band_count_tiles": "band_counts.cu",
           "pair_counts": "band_counts.cu",
           "hamming_nn": "hamming_nn.cu",
           "hamming_knn2": "hamming_nn.cu",
           "motion_support": "motion_support.cu",
           "l2_knn2": "l2_knn2.cu",
           "gauss_stack_resp": "gauss_stack_resp.cu",
           "hamming_d1": "hamming_d1.cu",
           "pyramid_level": "pyramid_level.cu",
           "resize_f32": "pyramid_level.cu",
           "orient_moments": "orient_moments.cu",
           "segment_sum": "segment_sum.cu"}
ORB_KERNELS = ("pyramid_level", "fast_score_nms_blur", "extract_patches",
               "orient_moments")   # the ORB front-end's
VIDEO_KERNELS = ORB_KERNELS + ("band_count_tiles",)
STREAM_KERNELS = ORB_KERNELS + ("pair_counts", "hamming_nn", "motion_support")
SFM_FRAMES, SFM_H, SFM_W = 96, 540, 960   # bench_reconstruct.py's defaults
SFM_FEATURES = 1000
SFM_STORE, SFM_GAP = 48, 24     # kernel F's loop-search check: K/2 gap
SUPPORT_EXTRA_SIZES = (4000, 1531)   # kernel E at batch 1 beside the live 2000
SIFT_STORE_ROWS = 1536      # rows a frame of the SIFT keyframe store (the
                            # count bucket of SIFT-4000's 927-1,413 valid)
SFM_KERNELS = ORB_KERNELS + ("hamming_knn2", "motion_support",
                             "segment_sum")
# CPU vs card on the SfM fixture: float gates (the Sampson threshold, the
# parallax gate) flip for a few points near their thresholds, so inlier and
# map counts agree within these bounds, not exactly
SFM_INLIERS_ATOL = 3            # loop inlier / pose-inlier counts
SFM_COUNT_RTOL = 0.01           # map point and observation counts
SFM_RTOL = 0.1                  # reprojection errors (a map a few points
                                # and a pose chain apart: 4.7% after BA)
SIFT_FRAMES, SIFT_H, SIFT_W = 96, 1080, 1920   # bench_reconstruct.py's SIFT
SIFT_FEATURES = 4000                           # configuration
SIFT_KERNELS = ("extract_patches", "motion_support", "l2_knn2",
                "gauss_stack_resp", "resize_f32", "segment_sum")
SIFT_G_ATOL = 1e-5          # kernel G on real descriptors: dots summed in
                            # another order than cuBLAS's
SIFT_KEYPOINTS_AGREE = 0.99  # CPU keypoints found on the card (phase 12)
SIFT_FIXTURE_HYPOTHESES = 256
D1_BENCH_ROWS = 8192                # bench_hamming.py's shape
C2_FRAMES, C2_H, C2_W = 500, 1080, 1920   # BASELINE config 2
C2_FEATURES, C2_BATCH, C2_PAIRS_PER_CALL = 4000, 50, 8192
C2_KERNELS = ORB_KERNELS + ("hamming_d1",)
HOLE_FRAMES = (5, 70)       # frames marked wholly invalid in the store checks
C2_HOLE_DEPTH = 192         # frames of the two routes' comparison with holes
MV_VIDEOS, MV_FRAMES, MV_H, MV_W = 6, 48, 540, 960   # bench_multivideo.py
MV_FEATURES = 1000
MV_KERNELS = ORB_KERNELS + ("band_count_tiles",)
CLI_FRAMES, CLI_H, CLI_W = 32, 144, 192   # the tests' orbit fixture
# the multi-loop fixture of tests/test_torch_loop_closing.py
ML_FRAMES, ML_H, ML_W, ML_POINTS, ML_SEED = 96, 240, 320, 800, 3
ML_FEATURES, ML_GAP, ML_DY = 500, 16, 16.0
RENDER_WORKERS = 8
# bounds: the H100 SXM's published peaks (NVIDIA's H100 datasheet; the
# dense rates, half the "with sparsity" ones), and a rate that NVIDIA does
# not publish as measured on the card (NVIDIA H100 80GB HBM3, 700 W)
HBM_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ = 132, 1.98e9
# "b1": one-bit and-popc on the tensor cores. No published rate: 10.1e15 is
# the instruction rate of mma.sync.m16n8k256.b1 alone, 8 and 16 warps an SM,
# measured by csrc/probes/probe_hamming_forms.py: 8.0x the rate it measures
# for mma.sync.m16n8k32.s8.
# "tf32": 495 TFLOP/s dense, the card's rate (reached by wgmma; the
# mma.sync.m16n8k8 that kernel G issues runs 270-275 at 8-32 warps an SM in
# csrc/probes/probe_rates.py, so G's bound is not reachable in its form).
# "ffma": float32 multiply, add or FMA instructions, 128 a clock an SM at
# the boost clock (the 67 TFLOP/s counts an FMA as two flops), and "fmnmx":
# float min/max, 64 a clock an SM (the CUDA C++ Programming Guide's
# throughput table, compute capability 9.0); csrc/probes/probe_rates.py
# measures 29.3-29.8 and 16.3-16.5 T/s, the same half ratio at the clock
# the card holds under load.
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12, "b1": 10.1e15,
                  "tf32": 495e12, "ffma": 128 * SMS * BOOST_HZ,
                  "fmnmx": 64 * SMS * BOOST_HZ}
# kernel A's instructions a pixel, by the pipe they issue on: every pixel
# pays the compass pre-test (8 compares, counted on the min/max pipe, and 16
# subtracts), the NMS (9 maxima) and the blur (2 x (7 multiplies + 6
# adds)); a pixel that passes the pre-test adds the arc extrema by doubling
# (2 x 3 x 16 min/max for the windows of 2, 4 and 8, 2 x 16 for the
# 9-windows, 2 x 15 for the best and worst arcs, 2 maxima for the score)
# and 4 subtracts
FAST_MINMAX_PER_PX, FAST_F32_PER_PX = 17, 42
FAST_MINMAX_PER_PASS, FAST_F32_PER_PASS = 160, 4
SIFT_OCTAVES = 4        # kernel H's octaves of a 1080p chunk checked


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time of work that moves ``nbytes`` (each input read once,
    each output written once) and does ``ops`` operations of ``kind``:
    ``bound_ms``, ``bound_by`` and a null ``library_ms``."""
    return bound_pipes(nbytes, {kind: ops})


def bound_pipes(nbytes: float, ops: dict) -> dict:
    """:func:`bound` of work that issues ``ops[kind]`` operations on each of
    several pipes, which run side by side: the slowest pipe counts."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[k] * 1e3 for k, n in ops.items())
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def support_set(rng, batch: int, n: int, dev, radius: float, tau: float):
    """(arguments of kernel E, valid matches): ``batch`` sets of ``n``
    matches in normalized coordinates ([n, 2] points for one set, as the
    live path passes them), a smooth flow with a third of outliers and a
    fifth of the rows masked out."""
    import torch

    xq = rng.uniform(-0.6, 0.6, (batch, n, 2))
    flow = 0.02 + 0.002 * rng.normal(size=(batch, n, 2))
    flow[:, : n // 3] = rng.uniform(-0.3, 0.3, (batch, n // 3, 2))
    mask = rng.random((batch, n)) < 0.8
    pick = (lambda x: x[0]) if batch == 1 else (lambda x: x)
    xq_d = torch.from_numpy(pick(xq).astype(np.float32)).to(dev)
    xt_d = torch.from_numpy(pick(xq - flow).astype(np.float32)).to(dev)
    mask_d = torch.from_numpy(pick(mask)).to(dev)
    return (xq_d, xt_d, mask_d, radius, tau), int(mask.sum())


def support_record(ck, args, reps: int, plain_reps: int) -> dict:
    """Kernel E's CUDA-event time on ``args`` beside its plain version's and
    its bound: per pair of valid matches 10 float32 instructions on the FMA
    pipe (4 subtracts, 4 multiplies, 2 adds, none an FMA) and 2 compares
    (the min/max pipe); 21 bytes a match (two points, the mask, the
    count)."""
    mask = args[2]
    nv = mask.reshape(-1, mask.shape[-1]).sum(-1).double()
    pairs = float((nv * nv).sum())
    return dict(shape=list(mask.shape), max_abs_err=0.0,
                ms=cuda_ms(lambda: ck.motion_support(*args), reps),
                device_ms=device_ms(lambda: ck.motion_support(*args), reps),
                plain_ms=cuda_ms(lambda: ck.motion_support_plain(*args),
                                 plain_reps),
                **bound_pipes(mask.numel() * (16 + 1 + 4),
                              {"ffma": 10 * pairs, "fmnmx": 2 * pairs}))


def pair_work(nv_q: np.ndarray, nv_t: np.ndarray, qidx, tidx) -> float:
    """Valid (query row, target row) combinations of a frame-pair list,
    from the valid row counts of each store's frames."""
    return float(np.sum(nv_q[np.asarray(qidx)].astype(np.float64)
                        * nv_t[np.asarray(tidx)]))


# the port's CUDA kernels by the name the profiler reports, to the wrapper
# that launches them (kernel C and K5 share one kernel; so do H's levels
# and gates, and the two passes of I and of G)
KERNEL_NAMES = {"fast_score_nms_blur_kernel": "fast_score_nms_blur",
                "extract_patches_kernel": "extract_patches",
                "band_counts_kernel": "band_count_tiles / pair_counts",
                "hamming_nn_kernel": "hamming_nn",
                "hamming_knn2_kernel": "hamming_knn2",
                "hamming_d1_kernel": "hamming_d1",
                "min_over_splits_kernel": "hamming_d1",
                "motion_support_kernel": "motion_support",
                "l2_knn2_kernel": "l2_knn2",
                "merge_splits_kernel": "l2_knn2",
                "blur_window_kernel": "gauss_stack_resp",
                "dog_gates_kernel": "gauss_stack_resp",
                "pyramid_level_kernel": "pyramid_level",
                "resize_f32_kernel": "resize_f32",
                "orient_moments_kernel": "orient_moments",
                "segment_sum_kernel": "segment_sum"}
def kernel_device_ms(prof, path: str, device_ms: dict) -> None:
    """Each kernel's summed device time (ms) in a profile of one run of a
    main path, by wrapper name: kept in ``device_ms[path]`` and printed."""
    out = collections.Counter()
    for e in prof.key_averages():
        for fn, name in KERNEL_NAMES.items():
            if fn in e.key:
                out[name] += getattr(e, "self_device_time_total", 0.0) / 1e3
    device_ms[path] = {k: round(v, 4) for k, v in sorted(out.items())}
    print(f"  device ms by kernel over {path} (profiler): {device_ms[path]}",
          flush=True)


def profiled(fn):
    """``fn()`` under the profiler, device activity only (with the CPU's op
    events as well, the sum of self device times counts each kernel twice),
    synchronized: (its result, the profile, its wall seconds)."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return out, prof, wall


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


def device_ms(fn, reps: int) -> float:
    """Mean device time (ms) of one ``fn()`` over ``reps`` calls after a
    warm-up: the summed self device time of every kernel and memset the
    calls ran, under the profiler. Unlike :func:`cuda_ms` it leaves out the
    host's time between launches, which sets the pace of a small call."""
    import torch

    fn()
    torch.cuda.synchronize()
    # two sessions, the second counted: a process's first session can miss
    # kernels that ran while the tracer started
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e3 / reps


def max_ulp(a, b) -> int:
    """Largest distance in float32 units in the last place."""
    import torch

    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def to_u8(frames: np.ndarray) -> np.ndarray:
    return (np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)


def _render_chunk(job) -> np.ndarray:
    """uint8 frames of one chunk of an orbit (runs in a worker process)."""
    from slam_loop_closing_tpu_torch.utils.synth_video import \
        render_cylinder_trajectory

    thetas, h, w, num_points, seed = job
    return to_u8(render_cylinder_trajectory(thetas, np.zeros(len(thetas)), h,
                                            w, num_points, seed=seed))


def render_orbits(pool, specs) -> list[np.ndarray]:
    """``orbit_sequence`` of every (num_frames, h, w, num_points, seed) of
    ``specs`` as uint8, the frames spread over the pool's workers: the
    texture depends on the seed only, so a chunk of angles renders the same
    frames as the whole orbit."""
    jobs, owner = [], []
    for i, (n, h, w, num_points, seed) in enumerate(specs):
        thetas = 2 * np.pi * np.arange(n) / n
        chunk = max(1, min(16, -(-n // RENDER_WORKERS)))
        for s in range(0, n, chunk):
            jobs.append((thetas[s:s + chunk], h, w, num_points, seed))
            owner.append(i)
    parts = list(pool.map(_render_chunk, jobs))
    return [np.concatenate([p for p, o in zip(parts, owner) if o == i])
            for i in range(len(specs))]


def slice_config():
    """bench_incremental.py's configuration: ORB-2000, one keypoint per
    8-px cell, the README's assumed camera, default loop and RANSAC rules."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig, OrbConfig,
                                                    PipelineConfig)

    return dataclasses.replace(
        PipelineConfig(), camera=CameraConfig.assumed(),
        orb=OrbConfig(num_features=NUM_FEATURES, grid_cell=8))


@contextlib.contextmanager
def forced_splits(ck, splits: int):
    """Every kernel's target split set to ``splits`` inside the block."""
    saved = ck._target_splits
    ck._target_splits = lambda *a: splits
    try:
        yield
    finally:
        ck._target_splits = saved


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
    err, ulp, ms, plain_ms, px, passing = 0.0, 0, 0.0, 0.0, 0, 0
    for lv in levels:
        lv = lv.contiguous()
        px += lv.numel()
        passing += int(ck.fast_compass_pass(lv, thr).sum())
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
    # one frame at each level (the live path), the levels of a 540x960 crop
    # (ORB SfM and multi-video), frames narrower than one 64 x 16 tile
    crop = image_ops.pyramid(image_ops.ship_frames(
        frames_dev[:8, :SFM_H, :SFM_W], dev), 4, 1.2)
    extra = ([lv[:1].contiguous() for lv in levels]
             + [lv.contiguous() for lv in crop]
             + [levels[0][:2, :21, :50].contiguous(),
                levels[3][:2, 100:140, 200:263].contiguous()])
    for x in extra:
        check_bitwise(f"kernel A at {tuple(x.shape)}",
                      ck.fast_score_nms_blur(x, thr),
                      ck.fast_score_nms_blur_plain(x, thr))
    one_ms = sum(cuda_ms(lambda: ck.fast_score_nms_blur(x, thr), 20)
                 for x in extra[:4])
    # one frame read, the score and the blur written; the instructions by
    # pipe, the arc extrema only where this run's pixels pass the pre-test
    records["fast_score_nms_blur"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound_pipes(12 * px, {
            "fmnmx": FAST_MINMAX_PER_PX * px + FAST_MINMAX_PER_PASS * passing,
            "ffma": FAST_F32_PER_PX * px + FAST_F32_PER_PASS * passing}))
    phase("kernel A fast_score_nms_blur", t0,
          f"4 levels x 8 frames {[tuple(lv.shape[1:]) for lv in levels]}: "
          f"score bitwise, blur {ulp} ulp; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound "
          f"{records['fast_score_nms_blur']['bound_ms']:.4f} ms "
          f"({records['fast_score_nms_blur']['bound_by']}); "
          f"{passing / px:.2%} of the pixels pass the compass pre-test; "
          f"bitwise also at {[tuple(x.shape) for x in extra]}; one frame "
          f"at the 4 levels {one_ms:.4f} ms")

    # J and M at the batched path's shapes (8 frames) and the live path's
    # (one frame), with A and B on the same levels and keypoints
    from slam_loop_closing_tpu_torch.config import OrbConfig
    cfg = OrbConfig(num_features=NUM_FEATURES, grid_cell=8)
    imgs8 = image_ops.ship_frames(frames_dev[:8], dev)
    records.update(check_front_end_kernels(
        f"8 x {H}x{W}, ORB-{NUM_FEATURES} grid 8", imgs8, cfg, reps=10))
    check_front_end_kernels(f"one {H}x{W} frame (the live path)", imgs8[:1],
                            cfg)
    del imgs8

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
    out_bytes = got.numel() * 4
    records["extract_patches"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
        **bound(min(out_bytes, imgs.numel() * 4) + out_bytes
                + xy.numel() * 4, 0, "f32"))
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
    # the b1 and-popc product: 2 x 256 operations per valid row pair
    nv = valid.sum(1).reshape(-1, block).sum(1)
    records["band_count_tiles"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
        **bound(packed.numel() * 4 + vt.numel() + got.numel() * 4,
                512 * pair_work(nv, nv, qidx.cpu(), tidx.cpu()), "b1"))
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
    nv = valid.sum(1)
    records["pair_counts"] = dict(
        max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
        **bound(packed.numel() * 4 + vt.numel() + got.numel() * 4,
                512 * pair_work(nv, nv, qidx.cpu(), tidx.cpu()), "b1"))
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
    # the target split forced to 1 and to 16 (each slab's merge)
    for splits in (1, 16):
        with forced_splits(ck, splits):
            check_bitwise(f"hamming_nn, {splits} splits",
                          ck.hamming_nn(pq, vq, pt, vt),
                          ck.hamming_nn_plain(pq, vq, pt, vt))
    ms = cuda_ms(lambda: ck.hamming_nn(pq, vq, pt, vt), 20)
    dms = device_ms(lambda: ck.hamming_nn(pq, vq, pt, vt), 20)
    plain_ms = cuda_ms(lambda: ck.hamming_nn_plain(pq, vq, pt, vt), 5)
    # the library form: one +-1 bf16 matmul on the tensor cores and a row
    # max with its index, on operands unpacked beforehand (validity not
    # applied)
    sq_b = desc_ops.bits_to_signed(desc_ops.packed_to_bits(pq)).to(
        torch.bfloat16)
    st_b = desc_ops.bits_to_signed(desc_ops.packed_to_bits(pt)).to(
        torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.max(sq_b @ st_b.T, dim=1), 20)
    records["hamming_nn"] = dict(
        max_abs_err=float(err), ms=ms, device_ms=dms, plain_ms=plain_ms,
        **bound(2 * n * 33 + 8 * n,
                512.0 * int(vq.sum()) * int(vt.sum()), "b1"))
    records["hamming_nn"].update(
        library_ms=library_ms,
        library="bf16 +-1 matmul + max with index, operands unpacked "
                "beforehand")
    phase("kernel D hamming_nn", t0,
          f"{n} x {n} descriptors (+ all-invalid targets, splits 1 and 16 "
          f"forced): bitwise; kernel {ms:.4f} ms (device {dms:.4f} ms), "
          f"plain {plain_ms:.3f} ms, bf16 matmul + max {library_ms:.4f} ms, "
          f"bound {records['hamming_nn']['bound_ms']:.5f} ms "
          f"({records['hamming_nn']['bound_by']})")
    del sq_b, st_b

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
    rec = support_record(ck, args, 20, 5)
    rec["max_abs_err"] = float((got - ref).abs().max())
    rec["shapes"] = {}
    # batch 1 at twice the live size and at sizes that are no multiple of
    # a slab (512), a stage (512) or a split's floor (64)
    extra = []
    for m in SUPPORT_EXTRA_SIZES:
        a = support_set(rng, 1, m, dev, system._radius, system._tau)[0]
        check_bitwise(f"motion_support ({m} matches)",
                      [ck.motion_support(*a)], [ck.motion_support_plain(*a)])
        extra.append(f"{m}: {cuda_ms(lambda: ck.motion_support(*a), 20):.4f}"
                     f" ms (device "
                     f"{device_ms(lambda: ck.motion_support(*a), 20):.4f} ms)")
        if m == 4000:
            rec["shapes"]["batch 1 x 4000"] = support_record(ck, a, 20, 3)
    records["motion_support"] = rec
    phase("kernel E motion_support", t0,
          f"{n} matches, radius {system._radius:.4f} tau {system._tau:.4f} "
          f"(normalized): bitwise (max support {int(got.max())}); kernel "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms), plain "
          f"{rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); batch 1, bitwise: "
          f"{', '.join(extra)}")
    return records


def run_slice(frames_dev, dev, device_ms: dict):
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
    _, prof, _ = profiled(lambda: LoopClosingSystem(
        cfg, max_frames=FRAMES, device=dev).process_video(frames_dev))
    kernel_device_ms(prof, "process_video", device_ms)
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


def run_stream(frames_u8: np.ndarray, dev, video_loops,
               device_ms: dict) -> dict:
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
    _, prof, wall = profiled(
        lambda: list(system.process_stream(frames_u8[:8])))
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e6
    phase("slice idle share", t0, f"8 frames in {wall * 1e3:.1f} ms, device "
          f"busy {busy * 1e3:.1f} ms (profiler, kernel time): idle share "
          f"{max(0.0, 1.0 - busy / wall):.0%}")
    kernel_device_ms(prof, "process_stream, 8 frames", device_ms)
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


def sfm_config(detector: str = "orb"):
    """bench_reconstruct.py's configurations: ORB-1000 with one keypoint
    per 8-px cell at 540x960, or SIFT-4000 (flat selection, 4 octaves) at
    1080x1920; its camera (f = 0.8 w, no distortion), keyframe and
    loop-verify gates, and 1,024 RANSAC hypotheses."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig,
                                                    KeyframeConfig,
                                                    LoopVerifyConfig,
                                                    OrbConfig, PipelineConfig,
                                                    RansacConfig, SiftConfig)

    h, w = (SIFT_H, SIFT_W) if detector == "sift" else (SFM_H, SFM_W)
    cam = CameraConfig(fx=0.8 * w, fy=0.8 * w, cx=w / 2, cy=h / 2, k1=0.0,
                       k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return dataclasses.replace(
        PipelineConfig(), camera=cam, detector=detector,
        orb=OrbConfig(num_features=SFM_FEATURES, grid_cell=8),
        sift=SiftConfig(num_features=SIFT_FEATURES),
        keyframe=KeyframeConfig(min_median_displacement=2.0,
                                max_median_displacement=300.0,
                                min_tracked_features=60,
                                min_inlier_ratio=0.25, min_inliers=40),
        loop_verify=LoopVerifyConfig(min_matches=60, min_inliers=40,
                                     min_inlier_ratio=0.4,
                                     min_pose_inliers=20),
        ransac=RansacConfig(num_hypotheses=1024))


def knn2_store(rng, dev):
    """Kernel F's check store: (packed words [48, 1000, 8], validity on the
    card, validity in numpy, the loop search's pair list at gap 24), with
    duplicated targets (rows 500-519 copy 400-419), the last keyframe's
    first 100 rows equal to rows 400-499 of the one before, and keyframe 5
    all invalid."""
    import torch

    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops

    k, n = SFM_STORE, SFM_FEATURES
    signed = (rng.integers(0, 2, (k, n, 256)) * 2 - 1).astype(np.int8)
    valid = rng.random((k, n)) < 0.95
    signed[:, 500:520] = signed[:, 400:420]   # duplicated targets
    valid[:, 400:420] = valid[:, 500:520] = True
    signed[k - 1, :100] = signed[k - 2, 400:500]   # queries equal to targets
    valid[k - 1, :100] = True
    valid[5] = False                          # an all-invalid keyframe
    packed = desc_ops.signed_to_packed(torch.from_numpy(signed).to(dev))
    pairs = [(c, p) for c in range(SFM_GAP, k)
             for p in range(0, c - SFM_GAP + 1)]
    return packed, torch.from_numpy(valid).to(dev), valid, pairs


def check_sfm_kernels(dev) -> dict:
    """Kernel F at the keyframe pass's and the loop search's shapes, and
    kernel E over verification chunks of 32 match sets (ORB's 1,000 rows
    and the SIFT store's 1,536)."""
    import torch

    from slam_loop_closing_tpu_torch.models import sfm
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    k, n = SFM_STORE, SFM_FEATURES
    packed, vt, valid, pairs = knn2_store(rng, dev)
    loop_q, loop_t = torch.tensor(pairs, dtype=torch.int32, device=dev).T
    one_q = torch.tensor([k - 1], dtype=torch.int32, device=dev)
    one_t = torch.tensor([k - 2], dtype=torch.int32, device=dev)
    big = 2 ** 30
    times = {}
    for shape, (qi, ti) in (("keyframe pass", (one_q, one_t)),
                            ("loop search", (loop_q, loop_t))):
        got = ck.hamming_knn2(packed, vt, packed, vt, qi, ti)
        ref = ck.hamming_knn2_plain(packed, vt, packed, vt, qi, ti)
        check_bitwise(f"hamming_knn2 ({shape})", got, ref)
        times[shape] = (
            cuda_ms(lambda: ck.hamming_knn2(packed, vt, packed, vt, qi, ti),
                    20),
            cuda_ms(lambda: ck.hamming_knn2_plain(packed, vt, packed, vt, qi,
                                                  ti), 3),
            device_ms(lambda: ck.hamming_knn2(packed, vt, packed, vt, qi,
                                              ti), 20))
    d1, idx, d2 = (t.cpu().numpy() for t in got)
    inv_q = ~valid[np.asarray(pairs)[:, 0]]
    empty_t = np.asarray(pairs)[:, 1] == 5
    if not ((d1[inv_q] == big) & (idx[inv_q] == 0) & (d2[inv_q] == big)).all():
        raise AssertionError("invalid query rows are not (2^30, 0, 2^30)")
    if not ((d1[empty_t] == big) & (d2[empty_t] == big)).all():
        raise AssertionError("an all-invalid target frame gave a match")
    d1, idx, d2 = (t.cpu().numpy()[0] for t in ck.hamming_knn2(
        packed, vt, packed, vt, one_q, one_t))
    if not ((d1[:20] == 0) & (d2[:20] == 0)
            & (idx[:20] == np.arange(400, 420))).all():
        raise AssertionError("forced ties: d2 must equal d1 at the lowest idx")
    # bound: the b1 mma's 512 operations a pair of valid rows (as kernel
    # I's); bytes: the store's words and validity once, 12 bytes out a row
    nv = valid.sum(1)
    shapes = {}
    for shape, pl in (("keyframe pass", [(k - 1, k - 2)]),
                      ("loop search", pairs)):
        shapes[shape] = dict(
            shape=[len(pl), n, n], max_abs_err=0.0, ms=times[shape][0],
            plain_ms=times[shape][1], device_ms=times[shape][2],
            **bound(len({f for pr in pl for f in pr}) * n * 33
                    + 12 * len(pl) * n,
                    512 * pair_work(nv, nv, *zip(*pl)), "b1"))
    records = {"hamming_knn2": dict(shapes["loop search"], shapes=shapes)}
    phase("kernel F hamming_knn2", t0,
          f"{n} x {n} rows; bitwise; invalid rows, an all-invalid keyframe "
          f"and forced ties checked; " + "; ".join(
              f"{sh} ({r['shape'][0]} pairs): kernel {r['ms']:.4f} ms "
              f"(device {r['device_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})" for sh, r in shapes.items()))
    del packed, vt

    # E over a verification chunk: 32 match sets in normalized coordinates
    t0 = time.perf_counter()
    c = sfm.VERIFY_CHUNK
    shapes, out = {}, []
    for m, label in ((n, "ORB"), (SIFT_STORE_ROWS, "SIFT")):
        args, nv = support_set(rng, c, m, dev, *sfm_support_radii())
        got = ck.motion_support(*args)
        check_bitwise(f"motion_support (batched, {m})", [got],
                      [ck.motion_support_plain(*args)])
        rec = support_record(ck, args, 20, 3)
        shapes[f"verification chunk {c} x {m}"] = rec
        out.append(f"{c} x {m} ({label}, {nv} valid matches, max support "
                   f"{int(got.max())}): kernel {rec['ms']:.4f} ms (device "
                   f"{rec['device_ms']:.4f} ms), plain "
                   f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
                   f"({rec['bound_by']})")
    records["motion_support_shapes"] = shapes
    phase("kernel E motion_support, batched", t0,
          "verification chunks, bitwise: " + "; ".join(out))
    return records


def sfm_support_radii() -> tuple[float, float]:
    """Kernel E's radius and tau on the ORB SfM path, in normalized
    coordinates (f = 0.8 w)."""
    cfg = sfm_config()
    focal = 0.8 * SFM_W
    w_est = 2.0 * cfg.camera.cx
    return (max(cfg.match.motion_radius_frac * w_est, 24.0) / focal,
            max(cfg.match.motion_tau_frac * w_est, 8.0) / focal)


def count_syncs_in(fn):
    """``fn()`` under torch's sync debug mode: (its result, the number of
    host syncs, a Counter of their source lines)."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    new = [w for w in rec if "synchroniz" in str(w.message)]
    return out, len(new), collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in new)


def sfm_pipeline(cfg, n: int, dev):
    """A resident ``SfMPipeline`` of ``n`` keyframe slots with the map sizes
    of bench_reconstruct.py, the keyframe pass as a scan, silent."""
    from slam_loop_closing_tpu_torch.models import sfm

    return sfm.SfMPipeline(cfg, max_keyframes=n, max_points=65536,
                           max_obs=262144, log=lambda *a: None,
                           use_scan=True, device=dev)


def same_bits(a, b) -> bool:
    """Every element of two tensors has the same bits (NaN included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def map_distance(a, b) -> tuple[bool, float]:
    """(whether two maps, each a (MapState, final error) pair, are bitwise
    equal in their poses, points, point validity and final error; the
    largest pose distance between them)."""
    import torch

    (sa, ea), (sb, eb) = a, b
    same = (same_bits(sa.poses, sb.poses) and same_bits(sa.points, sb.points)
            and same_bits(sa.point_valid, sb.point_valid)
            and np.float32(ea).tobytes() == np.float32(eb).tobytes())
    return same, float(torch.amax(torch.abs(sa.poses - sb.poses)))


def run_sfm(frames: np.ndarray, cfg, label: str, kernels, dev,
            device_ms: dict) -> dict:
    """A Version-B main path at full width on host uint8 ``frames``;
    returns the launch counts of the timed run from host memory."""
    import tempfile

    import torch

    from slam_loop_closing_tpu_torch.models import sfm
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    n, h, w = frames.shape

    def build():
        return sfm_pipeline(cfg, n, dev)

    # warm-up, stage by stage; the keyframe pass counts its host syncs
    pipe = build()
    (state, _), syncs, sources = count_syncs_in(
        lambda: pipe.run_frontend_and_keyframes_scan(frames))
    pipe.run_backend(state, pipe.find_loop(state))
    phase(f"slice SfM {label} warm-up", t0, f"{n} x {h}x{w}; keyframe pass "
          f"host syncs {syncs} in {n - 1} steps ({syncs / (n - 1):.1f} a "
          "step, front-end included)")
    for src, cnt in sources.most_common():
        print(f"  keyframe-pass sync source {src}: {cnt}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipe = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t_run = time.perf_counter()
        res = pipe.run(frames, data_dir=tmp)
        wall = time.perf_counter() - t_run
        launches = dict(ck.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        obj = Path(res.obj_path)
        if not (obj.is_file() and Path(tmp).resolve() in obj.resolve().parents):
            raise AssertionError(f"no OBJ under the temporary directory: {obj}")
        obj_vertices = obj.read_text().count("\nv ")
    if not all(launches[k] for k in kernels):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    if not res.loop.found:
        raise AssertionError("no loop closure on a closed-loop orbit")
    if not res.reproj_final < res.reproj_before_ba:
        raise AssertionError(f"BA did not lower the reprojection error: "
                             f"{res.reproj_before_ba} -> {res.reproj_final}")
    c = {k: int(getattr(res.state, k)) for k in
         ("kf_count", "point_count", "obs_count")}
    phase(f"slice SfMPipeline.run {label}", t0,
          f"{n} x {h}x{w} uint8 from host, {label}, 1024 hypotheses, "
          f"use_scan: {wall:.3f} s = {n / wall:.2f} frames/s (OBJ included);"
          f" keyframes {c['kf_count']}, points {c['point_count']}, "
          f"observations {c['obs_count']}; loop {res.loop.curr_kf} <-> "
          f"{res.loop.past_kf} ({res.loop.num_matches} matches, "
          f"{res.loop.num_inliers} inliers, {res.loop.num_pose_inliers} pose "
          f"inliers); reprojection {res.reproj_before_ba:.4f} -> "
          f"{res.reproj_after_ba:.4f} -> {res.reproj_final:.4f} px; OBJ "
          f"{obj_vertices} vertices; peak device memory {peak_gb:.2f} GB; "
          f"launches {launches}")

    # bench_reconstruct.py's contract: frames resident on the card, no OBJ
    # every run the same bits (F12): no deterministic mode
    t0 = time.perf_counter()
    frames_dev = torch.from_numpy(frames).to(dev)
    walls, dists = [], []
    for _ in range(2):
        pipe = build()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        res_dev = pipe.run(frames_dev, write_obj=False)
        walls.append(time.perf_counter() - t_run)
        same, dist = map_distance((res.state, res.reproj_final),
                                  (res_dev.state, res_dev.reproj_final))
        dists.append(dist)
        if not same:
            raise AssertionError(
                f"two runs of SfMPipeline.run {label} differ: poses "
                f"{dist} apart, final errors {res.reproj_final} and "
                f"{res_dev.reproj_final}")
    if (res_dev.loop.curr_kf, res_dev.loop.past_kf) != (res.loop.curr_kf,
                                                        res.loop.past_kf):
        raise AssertionError("resident frames found another loop")
    phase(f"slice SfMPipeline.run {label}, frames resident", t0,
          f"runs {', '.join(f'{t:.3f}' for t in walls)} s = "
          f"{', '.join(f'{n / t:.2f}' for t in walls)} frames/s; poses, "
          f"points, point validity and final error bitwise equal to the "
          f"run from host memory (pose distances {dists})")

    # stage split, each stage synchronized; the loop search's two device
    # calls timed through the module's names
    t0 = time.perf_counter()
    timer = StageTimer(dev)
    originals = {name: getattr(sfm, name) for name in ("_pair_ratio_counts",
                                                       "_verify_loop_scores")}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            with timer.stage(name):
                return fn(*args, **kwargs)
        return wrapper

    pipe = build()
    try:
        sfm._pair_ratio_counts = timed("  loop pair counts",
                                       originals["_pair_ratio_counts"])
        sfm._verify_loop_scores = timed("  loop verification",
                                        originals["_verify_loop_scores"])
        with timer.stage("front-end"):
            pipe._frontend(frames_dev)
        with timer.stage("front-end + keyframe pass"):
            state, _ = pipe.run_frontend_and_keyframes_scan(frames_dev)
        with timer.stage("find_loop"):
            loop = pipe.find_loop(state)
        with timer.stage("backend"):
            pipe.run_backend(state, loop)
    finally:
        for name, fn in originals.items():
            setattr(sfm, name, fn)
    split = {k: v * 1e3 for k, v in timer.stages.items()}
    split["keyframe pass"] = (split["front-end + keyframe pass"]
                              - split["front-end"])
    phase(f"slice SfM {label} stage split", t0,
          "ms, each stage synchronized: "
          + ", ".join(f"{k.strip()} {v:.1f}" for k, v in split.items()))

    # device idle share of one resident run; device activity only (with
    # the CPU's op events the trace also takes minutes to read)
    t0 = time.perf_counter()
    pipe = build()
    _, prof, wall = profiled(lambda: pipe.run(frames_dev, write_obj=False))
    busy = sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()) / 1e6
    phase(f"slice SfM {label} idle share", t0, f"one resident run "
          f"{wall:.3f} s under the profiler, device busy {busy:.3f} s "
          f"(kernel time): idle share {max(0.0, 1.0 - busy / wall):.0%}")
    kernel_device_ms(prof, f"SfMPipeline.run {label}", device_ms)
    return launches


def sfm_fixture():
    """(config, frames) of the 24-frame SfM fixture of the tests, at 512
    RANSAC hypotheses."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig,
                                                    KeyframeConfig,
                                                    LoopVerifyConfig,
                                                    OrbConfig, PipelineConfig,
                                                    RansacConfig)
    from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

    cfg = dataclasses.replace(
        PipelineConfig(),
        camera=CameraConfig(fx=0.8 * 192, fy=0.8 * 192, cx=96.0, cy=72.0,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
        orb=OrbConfig(num_features=300, num_levels=2),
        keyframe=KeyframeConfig(min_median_displacement=2.0,
                                max_median_displacement=150.0,
                                min_tracked_features=40, min_inlier_ratio=0.3,
                                min_inliers=25),
        loop_verify=LoopVerifyConfig(min_matches=40, min_inliers=30,
                                     min_inlier_ratio=0.5,
                                     min_pose_inliers=15),
        ransac=RansacConfig(num_hypotheses=512))
    return cfg, orbit_sequence(num_frames=24, h=144, w=192, num_points=250,
                               seed=5)


def check_sfm_agreement(dev) -> None:
    """The 24-frame fixture through SfMPipeline.run on the CPU and on the
    card, the CPU's RANSAC minimal sets replayed on the card."""
    import torch

    from slam_loop_closing_tpu_torch.models import sfm

    t0 = time.perf_counter()
    cfg, frames = sfm_fixture()
    drawn = []
    draw = sfm._minimal_sets

    def record(generator, mask, quality, rcfg):
        idx = draw(generator, mask, quality, rcfg)
        drawn.append(idx)
        return idx

    def replay(generator, mask, quality, rcfg):
        idx = next(replayed)
        if idx.shape[:-2] != mask.shape[:-1]:
            raise AssertionError("the card draws minimal sets for other "
                                 "match sets than the CPU")
        return idx.to(mask.device)

    out = {}
    try:
        for d, seam in (("cpu", record), (dev, replay)):
            replayed = iter(drawn)
            sfm._minimal_sets = seam
            pipe = sfm.SfMPipeline(cfg, max_keyframes=32, max_points=8192,
                                   max_obs=32768, log=lambda *a: None,
                                   device=d)
            front = [t.cpu() for t in pipe._frontend(frames)]
            res = pipe.run(frames, write_obj=False)
            k = int(res.state.kf_count)
            out[d] = dict(
                front=front, keyframes=res.state.kf_frame[:k].cpu().tolist(),
                loop=(res.loop.found, res.loop.curr_kf, res.loop.past_kf,
                      res.loop.num_matches),
                inliers=np.array([res.loop.num_inliers,
                                  res.loop.num_pose_inliers]),
                counts=np.array([int(res.state.point_count),
                                 int(res.state.obs_count)]),
                errs=np.array([res.reproj_before_ba, res.reproj_after_ba,
                               res.reproj_final]))
    finally:
        sfm._minimal_sets = draw
    if next(replayed, None) is not None:
        raise AssertionError("the card drew fewer minimal sets than the CPU")
    cpu, card = out["cpu"], out[dev]
    if not all(torch.equal(a, b) for a, b in zip(cpu["front"],
                                                 card["front"])):
        raise AssertionError("front-end outputs differ between cpu and card")
    for key in ("keyframes", "loop"):
        if cpu[key] != card[key]:
            raise AssertionError(f"SfM {key} differ: cpu {cpu[key]} vs card "
                                 f"{card[key]}")
    d_inl = np.abs(card["inliers"] - cpu["inliers"])
    rel_counts = np.abs(card["counts"] - cpu["counts"]) / cpu["counts"]
    rel = np.abs(card["errs"] - cpu["errs"]) / cpu["errs"]
    if (not cpu["loop"][0] or (d_inl > SFM_INLIERS_ATOL).any()
            or (rel_counts > SFM_COUNT_RTOL).any() or (rel > SFM_RTOL).any()):
        raise AssertionError(
            f"cpu vs card: loop inliers {cpu['inliers']} vs "
            f"{card['inliers']}, points/observations {cpu['counts']} vs "
            f"{card['counts']}, reprojection errors {cpu['errs']} vs "
            f"{card['errs']}")
    phase("agreement SfM cpu vs card", t0,
          f"24-frame fixture, same minimal sets: front-end bitwise, "
          f"{len(cpu['keyframes'])} keyframes and loop {cpu['loop'][1:]} "
          f"equal; loop inliers cpu {cpu['inliers'].tolist()} card "
          f"{card['inliers'].tolist()}; points/observations cpu "
          f"{cpu['counts'].tolist()} card {card['counts'].tolist()}; "
          f"reprojection errors cpu {cpu['errs'].tolist()} card "
          f"{card['errs'].tolist()}, max relative difference {rel.max():.2e}")


def check_l2_store(label: str, desc, vd, shapes) -> tuple[float, dict]:
    """Kernel G against its plain version on one store at each
    ``(name, (qidx, tidx))`` of ``shapes``: d1 and d2 within SIFT_G_ATOL,
    idx equal away from near-ties, the same rows matched. Returns (the
    largest |d1, d2| difference, {name: (kernel ms, plain ms)})."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck

    err, times = 0.0, {}
    for name, (qi, ti) in shapes:
        got = ck.l2_knn2(desc, vd, desc, vd, qi, ti)
        ref = ck.l2_knn2_plain(desc, vd, desc, vd, qi, ti)
        rows = ref[0] < 1e29          # a valid query with a valid target
        e = max(float((got[0] - ref[0])[rows].abs().max()),
                float((got[2] - ref[2])[rows].abs().max()))
        far = rows & ((ref[2] - ref[0]).abs() >= SIFT_G_ATOL)
        if (e > SIFT_G_ATOL or not torch.equal(got[1][far], ref[1][far])
                or not torch.equal(rows, got[0] < 1e29)):
            raise AssertionError(f"l2_knn2 on {label} ({name}): max |d| "
                                 f"difference {e:.2e}, idx equal away from "
                                 f"ties: {torch.equal(got[1][far], ref[1][far])}")
        err = max(err, e)
        del got, ref
        times[name] = (
            cuda_ms(lambda: ck.l2_knn2(desc, vd, desc, vd, qi, ti), 5),
            cuda_ms(lambda: ck.l2_knn2_plain(desc, vd, desc, vd, qi, ti), 2))
    return err, times


def bmm_cross_ms(desc, qidx, tidx, chunk: int = 64) -> float:
    """CUDA-event milliseconds of cuBLAS's float32 ``torch.bmm`` of the
    cross term q.t alone over the pairs (``qidx``, ``tidx``) of ``desc``
    [F, N, 128], a chunk of pairs a call, operands gathered beforehand: a
    yardstick of kernel G's dot work (it takes no top-2)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmul must not run in TF32 here")
    q = [desc.index_select(0, qidx[s:s + chunk].long())
         for s in range(0, qidx.shape[0], chunk)]
    t = [desc.index_select(0, tidx[s:s + chunk].long()).transpose(1, 2)
         for s in range(0, tidx.shape[0], chunk)]
    out = torch.empty((chunk, desc.shape[1], desc.shape[1]),
                      device=desc.device)

    def run():
        for a, b in zip(q, t):
            torch.bmm(a, b, out=out[:a.shape[0]])

    return cuda_ms(run, 3)


def sift_octaves(imgs, count: int) -> list:
    """The inputs of the first ``count`` octaves of ``[B, H, W]`` frames as
    the SIFT path makes them: each half the last, by kernel J's float32
    mode."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck

    out = [imgs.contiguous()]
    for _ in range(count - 1):
        h, w = out[-1].shape[-2:]
        out.append(ck.resize_f32(out[-1], h // 2, w // 2))
    return out


def check_resize_f32(imgs) -> dict:
    """Kernel J's float32 mode down the SIFT path's halvings of ``imgs``
    (octave 0 -> 1 -> 2 -> 3), each against its plain version, bitwise;
    CUDA-event times summed over the three, beside the dense float32
    cuBLAS products of ``image.resize_bilinear`` (the form it replaced) on
    the same inputs, and its bound: the input read and the output written
    once, 4 bytes a pixel; per output of each pass T multiplies and T - 1
    adds on the FMA pipe."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import image as image_ops

    t0 = time.perf_counter()
    rec = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0)
    nbytes = ops = 0.0
    dense_px, x, shapes = 0, imgs, []
    for _ in range(SIFT_OCTAVES - 1):
        b, h, w = x.shape
        nh, nw = h // 2, w // 2
        got = ck.resize_f32(x, nh, nw)
        check_bitwise(f"kernel J's float32 mode at {tuple(x.shape)}", [got],
                      [ck.resize_f32_plain(x, nh, nw)])
        dense_px += int((image_ops.resize_bilinear(x, nh, nw) != got).sum())
        rec["ms"] += cuda_ms(lambda: ck.resize_f32(x, nh, nw), 20)
        rec["device_ms"] += device_ms(lambda: ck.resize_f32(x, nh, nw), 20)
        rec["plain_ms"] += cuda_ms(lambda: ck.resize_f32_plain(x, nh, nw), 3)
        rec["library_ms"] += cuda_ms(
            lambda: image_ops.resize_bilinear(x, nh, nw), 20)
        taps = [image_ops.resize_taps(*a, torch.float32)[1].shape[1]
                for a in ((h, nh), (w, nw))]
        mid = nh * w if h <= w else h * nw
        nbytes += 4 * (x.numel() + got.numel())
        ops += b * sum((2 * t - 1) * n for t, n in zip(taps, (mid, nh * nw)))
        shapes.append(tuple(x.shape))
        x = got
    library_ms = rec.pop("library_ms")
    rec.update(max_abs_err=0.0, **bound_pipes(nbytes, {"ffma": ops}))
    rec.update(library_ms=library_ms,
               library="the dense float32 products it replaced "
                       "(image.resize_bilinear: two cuBLAS GEMMs a halving)")
    phase("kernel J float32 mode (SIFT octave halving)", t0,
          f"halvings of {shapes}: bitwise; summed kernel {rec['ms']:.4f} ms "
          f"(device {rec['device_ms']:.4f} ms), "
          f"plain {rec['plain_ms']:.3f} ms, dense cuBLAS products "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}); the dense products differ from the fixed "
          f"order at {dense_px} pixels")
    return rec


def check_sift_chunks(frames: np.ndarray, dev) -> None:
    """R17's gate on the SIFT path: the SIFT run's front-end (SIFT-4000,
    flat selection, 4 octaves) on 8 1080p frames in chunks of 1, 4 and 8,
    every field of the features bitwise equal."""
    import torch

    from slam_loop_closing_tpu_torch.ops import sift
    from slam_loop_closing_tpu_torch.ops.image import ship_frames

    t0 = time.perf_counter()
    cfg = sfm_config("sift").sift
    imgs = ship_frames(frames[:8], dev)
    runs = {c: sift.detect_and_describe_batch(
        imgs, dataclasses.replace(cfg, batch_chunk=c)) for c in (1, 4, 8)}
    for c in (4, 8):
        for name, a, b in zip(runs[1]._fields, runs[1], runs[c]):
            if not torch.equal(a, b):
                raise AssertionError(f"the SIFT front-end's {name} at chunk "
                                     f"{c} differs from chunk 1's")
    phase("SIFT front-end across chunks", t0,
          f"8 x {SIFT_H}x{SIFT_W}, SIFT-{cfg.num_features}, chunks of 1, 4 "
          f"and 8: every field bitwise equal "
          f"({int(runs[1].valid.sum())} keypoints)")


def gauss_stack_bound(sig, s: int, b: int, h: int, w: int,
                      emit_resp: bool) -> dict:
    """Kernel H's bound for ``b`` frames of ``h x w``, by pipe. The chain:
    a tap is one multiply and one add on the FMA pipe (no FMA, for the plain
    order), the first multiply of a pass has no add: 4 x taps - 2 a level
    and pixel. The gates add S+2 DoG subtracts on that pipe and, on the
    min/max pipe, per DoG plane the row maxima of three (2 maxima and 2
    minima for each of 4 rows, shared by 2 output rows: 8), the pair of
    rows above and below (2) and the full 3x3 (2), per centre plane its
    left/right pair (2) and the centre-excluded 3x3 (2), and per response
    plane the merge of its three (4): 12 (S+2) + 8 S a pixel. Bytes: the
    frames read once, the levels and response planes written once."""
    from slam_loop_closing_tpu_torch.ops import sift

    px = b * h * w
    taps = sum(len(t) for t in sift.chain_taps(sig))
    ffma = px * (4 * taps - 2 * len(sig))
    if not emit_resp:
        return bound_pipes(4 * px * (1 + len(sig)), {"ffma": ffma})
    return bound_pipes(4 * px * (1 + len(sig) + s),
                       {"ffma": ffma + px * (s + 2),
                        "fmnmx": px * (12 * (s + 2) + 8 * s)})


def check_sift_kernels(frames: np.ndarray, dev) -> dict:
    """Kernel H on octaves 0-3 of a chunk of 1080p frames, both modes,
    bitwise, and its time at each; kernel B on that octave's gradient maps
    at its keypoints (the descriptor's 40x40 windows), bitwise; kernel G on
    the keyframe store the pipeline's own front-end builds from all the
    frames (valid rows first, cut to the count bucket) at the keyframe
    step's pair and the loop search's pair list, within SIFT_G_ATOL, and as
    extra checks on 4,000-row stores: bitwise on integer-valued
    descriptors, within SIFT_G_ATOL on the unpacked SIFT descriptors of 48
    frames."""
    import torch

    from slam_loop_closing_tpu_torch.models import sfm
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import sift
    from slam_loop_closing_tpu_torch.ops.image import ship_frames

    records = {}
    t0 = time.perf_counter()
    cfg = sfm_config("sift").sift
    s = cfg.scales_per_octave
    sig = sift._chain_sigmas(s, cfg.sigma0)
    args = (s, sift._contrast_threshold(cfg), cfg.edge_threshold)
    imgs = ship_frames(frames[:cfg.batch_chunk], dev)
    records["resize_f32"] = check_resize_f32(imgs)
    t0 = time.perf_counter()
    octaves = sift_octaves(imgs, SIFT_OCTAVES)
    extrema, lines = [], []
    for o, x in enumerate(octaves):
        for emit in (True, False):
            got = ck.gauss_stack_resp(x, sig, *args, emit_resp=emit)
            ref = ck.gauss_stack_resp_plain(x, sig, *args, emit_resp=emit)
            if not (torch.equal(got[0], ref[0])
                    and (not emit or torch.equal(got[1], ref[1]))):
                raise AssertionError(f"kernel H differs from its plain version"
                                     f" at {tuple(x.shape)}, emit_resp={emit}")
            if emit:
                extrema.append(int((got[1] > 0).sum()))
        del got, ref
        if o == 0:
            continue
        t = [cuda_ms(lambda: ck.gauss_stack_resp(x, sig, *args,
                                                 emit_resp=emit), 20)
             for emit in (True, False)]
        lines.append(f"octave {o} {tuple(x.shape)}: {t[0]:.4f} / {t[1]:.4f}")
    ms = cuda_ms(lambda: ck.gauss_stack_resp(imgs, sig, *args), 10)
    plain_ms = cuda_ms(lambda: ck.gauss_stack_resp_plain(imgs, sig, *args), 2)
    gauss_ms = cuda_ms(lambda: ck.gauss_stack_resp(imgs, sig, s,
                                                   emit_resp=False), 10)
    gauss_plain_ms = cuda_ms(lambda: ck.gauss_stack_resp_plain(
        imgs, sig, s, emit_resp=False), 2)
    b, h, w = imgs.shape
    records["gauss_stack_resp"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        **gauss_stack_bound(sig, s, b, h, w, True))
    gauss_bound = gauss_stack_bound(sig, s, b, h, w, False)
    phase("kernel H gauss_stack_resp", t0,
          f"{b} x {h}x{w}, octaves 0-{len(octaves) - 1}, both modes: bitwise "
          f"({extrema} extrema); octave 0, gauss + response: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{records['gauss_stack_resp']['bound_ms']:.4f} ms "
          f"({records['gauss_stack_resp']['bound_by']}); gauss only: kernel "
          f"{gauss_ms:.3f} ms, plain {gauss_plain_ms:.3f} ms, bound "
          f"{gauss_bound['bound_ms']:.4f} ms ({gauss_bound['bound_by']}); "
          f"kernel ms, gauss + response / gauss only, "
          + "; ".join(lines))
    del octaves, x
    torch.cuda.empty_cache()

    # B at the SIFT path's shape: the 40x40 windows of octave 0's gradient
    # maps at that octave's keypoint slots
    t0 = time.perf_counter()
    budget = sift._level_budgets(cfg.num_features, cfg.num_octaves)[0]
    _, _, _, kp_valid, mag, ang, xy_oct = sift._detect_octave(imgs, 0, budget,
                                                              cfg)
    pargs = (xy_oct, sift.PATCH, sift.PATCH_CENTER)
    for m in (mag, ang):
        check_bitwise("extract_patches (SIFT 40x40 windows)",
                      [ck.extract_patches(m, *pargs)],
                      [ck.extract_patches_plain(m, *pargs)])
    b_ms = cuda_ms(lambda: ck.extract_patches(mag, *pargs), 10)
    b_plain_ms = cuda_ms(lambda: ck.extract_patches_plain(mag, *pargs), 3)
    out_bytes = 4 * xy_oct.shape[0] * xy_oct.shape[1] * sift.PATCH ** 2
    b_bound = bound(min(out_bytes, mag.numel() * 4) + out_bytes
                    + xy_oct.numel() * 4, 0, "f32")
    phase("kernel B extract_patches, SIFT", t0,
          f"{b} x {h}x{w} gradient maps, {xy_oct.shape[1]} keypoint slots a "
          f"frame ({int(kp_valid.sum()) // b} valid), {sift.PATCH}x"
          f"{sift.PATCH} at center {sift.PATCH_CENTER}, magnitude and angle: "
          f"bitwise; kernel {b_ms:.3f} ms, plain {b_plain_ms:.3f} ms, bound "
          f"{b_bound['bound_ms']:.4f} ms ({b_bound['bound_by']}) a map")
    del imgs, mag, ang, xy_oct, kp_valid
    torch.cuda.empty_cache()

    # G on the pipeline's own keyframe store: every frame is a keyframe of
    # the SIFT run (phase 11), so the store is the front-end's output
    t0 = time.perf_counter()
    n_kf = len(frames)
    pipe = sfm.SfMPipeline(sfm_config("sift"), max_keyframes=n_kf,
                           log=lambda *a: None, device=dev)
    desc, vd = (t.contiguous() for t in pipe._frontend(frames)[:2])
    del pipe
    nv = vd.sum(1).cpu().numpy()
    gap = max(3, n_kf // 2)                 # SfMPipeline.find_loop's pairs
    pairs = [(c, p) for c in range(gap, n_kf) for p in range(0, c - gap + 1)
             if nv[c] >= 100 and nv[p] >= 100]
    if not pairs:
        raise AssertionError(f"no loop-search pair: {nv.tolist()} valid rows")
    loop_q, loop_t = torch.tensor(pairs, dtype=torch.int32, device=dev).T
    step = (torch.tensor([n_kf - 1], dtype=torch.int32, device=dev),
            torch.tensor([n_kf - 2], dtype=torch.int32, device=dev))
    err, times = check_l2_store("the packed SIFT store", desc, vd,
                                (("keyframe step", step),
                                 ("loop search", (loop_q, loop_t))))
    ms, plain_ms = times["loop search"]
    kf, nb = desc.shape[:2]
    # 2 x 128 float32 operations per valid row pair, each three tf32
    # products on the tensor cores (3xTF32); the store read once
    records["l2_knn2"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(kf * nb * (128 * 4 + 1) + 12 * len(pairs) * nb,
                3 * 256 * pair_work(nv, nv, *zip(*pairs)), "tf32"))
    yard_ms = bmm_cross_ms(desc[:, :int(ck.frame_extents(vd).max())], loop_q,
                           loop_t)
    phase("kernel G l2_knn2, pipeline store", t0,
          f"{kf} x {nb} rows (the front-end's valid-first store at its count "
          f"bucket; {int(nv.min())}-{int(nv.max())} valid a frame, mean "
          f"{nv.mean():.0f}): max |d1, d2| difference {err:.2e}, idx equal "
          f"away from ties; kernel {times['keyframe step'][0]:.3f} / "
          f"{ms:.3f} ms, plain {times['keyframe step'][1]:.3f} / "
          f"{plain_ms:.3f} ms (1 pair / {len(pairs)} pairs at gap {gap}), "
          f"bound {records['l2_knn2']['bound_ms']:.3f} ms "
          f"({records['l2_knn2']['bound_by']}); yardstick: cuBLAS float32 "
          f"bmm of the cross term alone on the same pairs (rows cut at the "
          f"largest extent, no top-2) {yard_ms:.3f} ms")

    # the same store with its rows shuffled in every frame (valid rows not
    # packed first, extents near the row count), and a 1,001-row store of
    # integer-valued descriptors (rows no multiple of the kernel's tiles;
    # holes, an extent below the row count, all-invalid query and target
    # frames), at the same pair lists
    t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(7)
    perm = torch.argsort(torch.rand((kf, nb), generator=gen), dim=1).to(dev)
    desc_s = torch.gather(desc, 1, perm[..., None].expand(-1, -1, 128))
    vd_s = torch.gather(vd, 1, perm)
    err_s, times_s = check_l2_store("the shuffled SIFT store", desc_s, vd_s,
                                    (("keyframe step", step),
                                     ("loop search", (loop_q, loop_t))))
    del desc_s, vd_s, perm
    rng = np.random.default_rng(5)
    d_int = torch.from_numpy(rng.integers(0, 16, (kf, 1001, 128)).astype(
        np.float32)).to(dev)
    v_np = rng.random((kf, 1001)) < 0.9
    v_np[3, 600:] = False
    v_np[10] = v_np[60] = False
    v_int = torch.from_numpy(v_np).to(dev)
    for name, (qi, ti) in (("keyframe step", step),
                           ("loop search", (loop_q, loop_t))):
        check_bitwise(f"l2_knn2 on a 1,001-row integer store ({name})",
                      ck.l2_knn2(d_int, v_int, d_int, v_int, qi, ti),
                      ck.l2_knn2_plain(d_int, v_int, d_int, v_int, qi, ti))
    phase("kernel G l2_knn2, shuffled and 1,001-row stores", t0,
          f"the pipeline store with its rows shuffled in every frame: max "
          f"|d1, d2| difference {err_s:.2e}, idx equal away from ties; "
          f"kernel {times_s['keyframe step'][0]:.3f} / "
          f"{times_s['loop search'][0]:.3f} ms; a {kf} x 1,001-row integer "
          f"store (holes, an extent of 600, two empty frames): bitwise at 1 "
          f"pair and at {len(pairs)} pairs")
    del d_int, v_int, desc, vd
    torch.cuda.empty_cache()

    # extra checks on 4,000-row stores: integer-valued descriptors (bitwise,
    # invalid rows, an all-invalid keyframe, forced ties) and the unpacked
    # SIFT descriptors of 48 frames
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    k, n = SFM_STORE, SIFT_FEATURES
    pairs = [(c, p) for c in range(SFM_GAP, k)
             for p in range(0, c - SFM_GAP + 1)]
    loop_q, loop_t = torch.tensor(pairs, dtype=torch.int32, device=dev).T
    one_q = torch.tensor([k - 1], dtype=torch.int32, device=dev)
    one_t = torch.tensor([k - 2], dtype=torch.int32, device=dev)
    shapes = (("keyframe step", (one_q, one_t)), ("loop search",
                                                  (loop_q, loop_t)))
    ints = rng.integers(0, 16, (k, n, 128)).astype(np.float32)
    valid = rng.random((k, n)) < 0.95
    ints[:, 500:520] = ints[:, 400:420]       # duplicated targets
    valid[:, 400:420] = valid[:, 500:520] = True
    ints[k - 1, :100] = ints[k - 2, 400:500]  # queries equal to targets
    valid[k - 1, :100] = True
    valid[5] = False                          # an all-invalid keyframe
    d_int = torch.from_numpy(ints).to(dev)
    v_int = torch.from_numpy(valid).to(dev)
    del ints
    for name, (qi, ti) in shapes:
        check_bitwise(f"l2_knn2 on integer descriptors ({name})",
                      ck.l2_knn2(d_int, v_int, d_int, v_int, qi, ti),
                      ck.l2_knn2_plain(d_int, v_int, d_int, v_int, qi, ti))
    d1, idx, d2 = (t.cpu().numpy() for t in ck.l2_knn2(
        d_int, v_int, d_int, v_int, loop_q, loop_t))
    inv_q = ~valid[np.asarray(pairs)[:, 0]]
    empty_t = np.asarray(pairs)[:, 1] == 5
    big = np.float32(1e30)
    if not ((d1[inv_q] == big) & (idx[inv_q] == 0) & (d2[inv_q] == big)).all():
        raise AssertionError("invalid query rows are not (1e30, 0, 1e30)")
    if not ((d1[empty_t] == big) & (d2[empty_t] == big)).all():
        raise AssertionError("an all-invalid target frame gave a match")
    d1, idx, d2 = (t.cpu().numpy()[0] for t in ck.l2_knn2(
        d_int, v_int, d_int, v_int, one_q, one_t))
    if not ((d1[:20] == 0) & (d2[:20] == 0)
            & (idx[:20] == np.arange(400, 420))).all():
        raise AssertionError("forced ties: d2 must equal d1 at the lowest idx")
    del d_int, v_int

    f = sift.detect_and_describe_batch(ship_frames(frames[:k], dev), cfg)
    desc, vd = f.descriptors.contiguous(), f.valid.contiguous()
    del f
    raw_err, raw = check_l2_store("unpacked SIFT descriptors", desc, vd,
                                  shapes)
    phase("kernel G l2_knn2, 4,000-row stores", t0,
          f"integer-valued: 1 pair and {len(pairs)} pairs of a {k}-keyframe "
          f"store at gap {SFM_GAP}, bitwise (invalid rows, an all-invalid "
          f"keyframe, forced ties); the unpacked SIFT descriptors of {k} "
          f"1080p frames ({int(vd.sum()) // k} valid a frame): max |d1, d2| "
          f"difference {raw_err:.2e}, idx equal away from ties; kernel "
          f"{raw['keyframe step'][0]:.3f} / {raw['loop search'][0]:.3f} ms, "
          f"plain {raw['keyframe step'][1]:.3f} / "
          f"{raw['loop search'][1]:.3f} ms (1 pair / {len(pairs)} pairs)")
    del desc, vd
    torch.cuda.empty_cache()
    return records


def sift_fixture():
    """(config, frames) of the 24-frame SIFT fixture of the tests
    (test_sfm_sift.py's configuration) at SIFT_FIXTURE_HYPOTHESES."""
    from slam_loop_closing_tpu_torch.config import (CameraConfig,
                                                    KeyframeConfig,
                                                    LoopVerifyConfig,
                                                    MatchConfig,
                                                    PipelineConfig,
                                                    RansacConfig, SiftConfig)
    from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

    cfg = dataclasses.replace(
        PipelineConfig(), detector="sift",
        camera=CameraConfig(fx=0.8 * 192, fy=0.8 * 192, cx=96.0, cy=72.0,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
        sift=SiftConfig(num_features=400, num_octaves=2),
        match=MatchConfig(ratio_threshold=0.85),
        keyframe=KeyframeConfig(min_median_displacement=2.0,
                                max_median_displacement=150.0,
                                min_tracked_features=25, min_inlier_ratio=0.3,
                                min_inliers=15),
        loop_verify=LoopVerifyConfig(min_matches=25, min_inliers=15,
                                     min_inlier_ratio=0.4,
                                     min_pose_inliers=8),
        ransac=RansacConfig(num_hypotheses=SIFT_FIXTURE_HYPOTHESES))
    return cfg, orbit_sequence(num_frames=24, h=144, w=192, num_points=250,
                               seed=11)


def check_sift_agreement(dev) -> None:
    """The SIFT fixture on the CPU and on the card: the front-end's
    keypoints, then ``SfMPipeline.run`` with the CPU's minimal sets
    replayed on the card (a draw for a match set of another shape, which a
    keypoint near a gate can cause, is the card's own and counted)."""
    import torch

    from slam_loop_closing_tpu_torch.models import sfm
    from slam_loop_closing_tpu_torch.ops import sift
    from slam_loop_closing_tpu_torch.ops.image import ship_frames

    t0 = time.perf_counter()
    cfg, frames = sift_fixture()
    kps = {}
    for d in ("cpu", dev):
        f = sift.detect_and_describe_batch(ship_frames(frames, d), cfg.sift)
        kps[d] = (f.xy.cpu().numpy(), f.valid.cpu().numpy())
    (xy0, v0), (xy1, v1) = kps["cpu"], kps[dev]
    found = 0
    for i in range(len(frames)):
        a, b = xy0[i][v0[i]], xy1[i][v1[i]]
        if len(a) and len(b):
            dist = np.abs(a[:, None] - b[None]).max(-1)
            found += int((dist.min(1) <= 1e-3).sum())
    share = found / max(int(v0.sum()), 1)
    if share < SIFT_KEYPOINTS_AGREE:
        raise AssertionError(f"{share:.1%} of the CPU's SIFT keypoints on the "
                             "card")

    drawn, stats = [], collections.Counter()
    draw = sfm._minimal_sets

    def record(generator, mask, quality, rcfg):
        idx = draw(generator, mask, quality, rcfg)
        drawn.append((idx, mask.shape))
        return idx

    def replay(generator, mask, quality, rcfg):
        idx, shape = next(replayed, (None, None))
        if shape != mask.shape:
            stats["own"] += 1
            return draw(generator, mask, quality, rcfg)
        stats["replayed"] += 1
        return idx.to(mask.device)

    out = {}
    try:
        for d, seam in (("cpu", record), (dev, replay)):
            replayed = iter(drawn)
            sfm._minimal_sets = seam
            res = sfm.SfMPipeline(cfg, max_keyframes=32, max_points=8192,
                                  max_obs=32768, log=lambda *a: None,
                                  device=d).run(frames, write_obj=False)
            k = int(res.state.kf_count)
            out[d] = dict(
                keyframes=res.state.kf_frame[:k].cpu().tolist(),
                loop=(res.loop.found, res.loop.curr_kf, res.loop.past_kf),
                counts=np.array([int(res.state.point_count),
                                 int(res.state.obs_count)]),
                errs=np.array([res.reproj_before_ba, res.reproj_after_ba,
                               res.reproj_final]))
    finally:
        sfm._minimal_sets = draw
    cpu, card = out["cpu"], out[dev]
    for key in ("keyframes", "loop"):
        if cpu[key] != card[key]:
            raise AssertionError(f"SIFT SfM {key} differ: cpu {cpu[key]} vs "
                                 f"card {card[key]}")
    rel_counts = np.abs(card["counts"] - cpu["counts"]) / cpu["counts"]
    rel = np.abs(card["errs"] - cpu["errs"]) / cpu["errs"]
    if (rel_counts > SFM_COUNT_RTOL).any() or (rel > SFM_RTOL).any():
        raise AssertionError(
            f"SIFT cpu vs card: points/observations {cpu['counts']} vs "
            f"{card['counts']}, reprojection errors {cpu['errs']} vs "
            f"{card['errs']}")
    phase("agreement SIFT cpu vs card", t0,
          f"24-frame SIFT fixture: {share:.2%} of {int(v0.sum())} CPU "
          f"keypoints on the card ({int(v1.sum())} there); "
          f"{stats['replayed']} draws replayed, {stats['own']} the card's "
          f"own; {len(cpu['keyframes'])} keyframes and loop {cpu['loop']} "
          f"equal; points/observations cpu {cpu['counts'].tolist()} card "
          f"{card['counts'].tolist()}; reprojection errors cpu "
          f"{cpu['errs'].tolist()} card {card['errs'].tolist()}")


def check_front_end_kernels(name: str, imgs, cfg, reps: int = 0) -> dict:
    """Kernels J, A, B and M against their plain versions at the shapes
    ``orb.detect_and_describe_batch`` gives them for one batch ``imgs``
    [B, H, W] float32 under the ORB config ``cfg``: each pyramid level from
    the level before through kernel J (the bfloat16 and the float32 level),
    every level of the whole batch through kernel A, then that level's own
    keypoints (its share of the feature budget) on its blurred frames
    through kernel B, and the orientation of all the batch's keypoints from
    their patches through kernel M. Bitwise. The plain FAST runs over the
    batch 10 frames at a time, which bounds its memory and changes nothing
    per frame. With ``reps``, returns J's and M's records: CUDA-event times
    of the kernels, of their plain versions and of the cuBLAS forms they
    replaced (J: the dense float32 products of ``image.resize_bilinear``
    at bfloat16, the first level's rounding of the frames included; M: the
    [K, 1024] @ [1024, 2] moment product), and their bounds."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import fast as fast_ops
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import orb

    t0 = time.perf_counter()
    thr = cfg.fast_threshold / 255.0
    h, w = imgs.shape[-2:]
    levels, prev = [imgs], imgs
    j = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0,
             ops=0.0)
    for lvl in range(1, cfg.num_levels):
        s = cfg.scale_factor ** lvl
        nh, nw = max(8, int(round(h / s))), max(8, int(round(w / s)))
        got = ck.pyramid_level(prev, nh, nw)
        check_bitwise(f"kernel J ({name}, level {lvl})", got,
                      ck.pyramid_level_plain(prev, nh, nw))
        if reps:
            x = prev

            def dense():
                y = image_ops.resize_bilinear(x.to(torch.bfloat16), nh, nw)
                return y, y.to(torch.float32)

            j["dense_px"] = j.get("dense_px", 0) + int(
                (dense()[0] != got[0]).sum())
            j["ms"] += cuda_ms(lambda: ck.pyramid_level(x, nh, nw), reps)
            j["device_ms"] += device_ms(lambda: ck.pyramid_level(x, nh, nw),
                                        reps)
            j["plain_ms"] += cuda_ms(
                lambda: ck.pyramid_level_plain(x, nh, nw), 3)
            j["library_ms"] += cuda_ms(dense, reps)
            # the input read once, both levels written once; per output of
            # each pass T multiplies and T - 1 adds on the FMA pipe
            taps = [image_ops.resize_taps(*a)[1].shape[1]
                    for a in ((x.shape[1], nh), (x.shape[2], nw))]
            mid = nh * x.shape[2] if x.shape[1] <= x.shape[2] else \
                x.shape[1] * nw
            j["nbytes"] += x.numel() * x.element_size() + got[0].numel() * 6
            j["ops"] += x.shape[0] * sum(
                (2 * t - 1) * n for t, n in zip(taps, (mid, nh * nw)))
        levels.append(got[1])
        prev = got[0]
    budgets = orb._level_budgets(cfg.num_features, cfg.num_levels,
                                 cfg.scale_factor)
    patches, valid = [], []
    for lv, budget in zip(levels, budgets):
        shape = f"{name}, level {tuple(lv.shape)}"
        score, blur = ck.fast_score_nms_blur(lv, thr)
        for s in range(0, lv.shape[0], 10):
            check_bitwise(f"kernel A ({shape})",
                          [score[s:s + 10], blur[s:s + 10]],
                          ck.fast_score_nms_blur_plain(lv[s:s + 10], thr))
        xy, _, val, blurred = fast_ops.detect_with_blur(
            lv, threshold=thr, num_features=budget, nms_radius=cfg.nms_radius,
            border=cfg.border, grid_cell=cfg.grid_cell)
        got = ck.extract_patches(blurred, xy)
        check_bitwise(f"kernel B ({shape}, {budget} keypoints)", [got],
                      [ck.extract_patches_plain(blurred, xy)])
        patches.append(got)
        valid.append(val)
    flat = torch.cat(patches, 1).reshape(-1, orb.PATCH, orb.PATCH)
    val = torch.cat(valid, 1).reshape(-1)
    del patches, valid
    mw = orb._moment_weights_on(flat.device)
    ang = ck.orient_moments(flat, val, mw)
    check_bitwise(f"kernel M ({name}, {flat.shape[0]} keypoints)", [ang],
                  [ck.orient_moments_plain(flat, val, mw)])
    phase(f"kernels J, A, B and M, {name}", t0,
          f"one front-end batch of {imgs.shape[0]} frames, levels "
          f"{[tuple(lv.shape[1:]) for lv in levels]} with {budgets} keypoints "
          f"a frame: levels, score, blur, patches and "
          f"{flat.shape[0]} angles bitwise")
    if not reps:
        return {}
    k = flat.shape[0]
    records = {"pyramid_level": dict(
        max_abs_err=0.0, ms=j["ms"], device_ms=j["device_ms"],
        plain_ms=j["plain_ms"],
        **bound_pipes(j["nbytes"], {"ffma": j["ops"]}))}
    records["pyramid_level"].update(
        library_ms=j["library_ms"],
        library="the dense float32 products it replaced "
                "(image.resize_bilinear at bfloat16, two cuBLAS GEMMs and "
                "two roundings a level)")
    records["orient_moments"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: ck.orient_moments(flat, val, mw),
                                    reps),
        plain_ms=cuda_ms(lambda: ck.orient_moments_plain(flat, val, mw), 3),
        # the patches, the validity and the angles; 2 x 1,024 multiplies
        # and 2 x 1,023 adds a keypoint on the FMA pipe
        **bound_pipes(k * (orb.PATCH * orb.PATCH * 4 + 1 + 4),
                      {"ffma": k * 4094.0}))
    records["orient_moments"].update(
        library_ms=cuda_ms(lambda: flat.reshape(k, -1) @ mw, reps),
        library="the [K, 1024] @ [1024, 2] float32 cuBLAS product it "
                "replaced (without the atan2)")
    print(f"  kernel J, 3 levels: {j['ms']:.4f} ms (device "
          f"{j['device_ms']:.4f} ms), plain {j['plain_ms']:.3f} "
          f"ms, dense products {j['library_ms']:.3f} ms, bound "
          f"{records['pyramid_level']['bound_ms']:.4f} ms "
          f"({records['pyramid_level']['bound_by']}); kernel M, {k} "
          f"keypoints: {records['orient_moments']['ms']:.4f} ms, plain "
          f"{records['orient_moments']['plain_ms']:.3f} ms, cuBLAS product "
          f"{records['orient_moments']['library_ms']:.4f} ms, bound "
          f"{records['orient_moments']['bound_ms']:.4f} ms "
          f"({records['orient_moments']['bound_by']}); the dense products "
          f"differ from J's fixed order at {j['dense_px']} pixels of the "
          f"batch's levels", flush=True)
    return records


def _random_words(gen, *shape):
    """Uniform random descriptor words [..., 8] int32 on the generator's
    device."""
    import torch

    return torch.randint(-2 ** 31, 2 ** 31, (*shape, 8), generator=gen,
                         device=gen.device, dtype=torch.int64).to(torch.int32)


def check_d1_kernel(dev) -> dict:
    """Kernel I's single-pair form against its plain version at the bench
    shape and with invalid targets; returns the bench shape's numbers."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    n = D1_BENCH_ROWS
    pq, pt = _random_words(gen, n), _random_words(gen, n)
    pt[n // 2:n // 2 + 64] = pq[:64]                  # distance 0
    vt = torch.ones(n, dtype=torch.bool, device=dev)
    got = ck.hamming_nn_d1(pq, pt, vt)
    ref = ck.hamming_nn_d1_plain(pq, pt, vt)
    check_bitwise("hamming_nn_d1 8192 x 8192", [got], [ref])
    if int(got[:64].max()) != 0 or int(got.max()) > 256:
        raise AssertionError("kernel I misses the planted duplicates")
    ms = cuda_ms(lambda: ck.hamming_nn_d1(pq, pt, vt), 20)
    plain_ms = cuda_ms(lambda: ck.hamming_nn_d1_plain(pq, pt, vt), 5)
    # the library form: one +-1 matmul on the tensor cores and a row max,
    # on operands unpacked to bf16 beforehand (exact: |dot| <= 256)
    sq = desc_ops.bits_to_signed(desc_ops.packed_to_bits(pq)).to(torch.bfloat16)
    st = desc_ops.bits_to_signed(desc_ops.packed_to_bits(pt)).to(torch.bfloat16)

    def library():
        return torch.amax(sq @ st.T, dim=1)

    lib = ((256 - library().to(torch.float32)) * 0.5).to(torch.int32)
    check_bitwise("matmul-and-amax form", [lib], [ref])
    library_ms = cuda_ms(library, 20)
    b = bound(2 * n * 32 + n + n * 4, 512.0 * n * n, "b1")
    bench = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                 bound_by=b["bound_by"], library_ms=library_ms,
                 g_row_pairs_per_s=n * n / ms / 1e6)
    phase("kernel I hamming_nn_d1", t0,
          f"{n} x {n} rows, all targets valid: bitwise; kernel {ms:.3f} ms = "
          f"{bench['g_row_pairs_per_s']:.1f} G row pairs/s, plain "
          f"{plain_ms:.3f} ms, bf16 matmul + amax {library_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    del sq, st, lib

    t0 = time.perf_counter()
    m = NUM_FEATURES
    pq, pt = _random_words(gen, m), _random_words(gen, m)
    pt[100:140] = pq[:40]
    vt = torch.rand(m, generator=gen, device=dev) < 0.8
    vt[100:120] = True
    vt[120:140] = False                # duplicates 20-39 are invalid targets
    for valid_t in (vt, torch.zeros_like(vt)):
        got = ck.hamming_nn_d1(pq, pt, valid_t)
        check_bitwise("hamming_nn_d1 2000 x 2000", [got],
                      [ck.hamming_nn_d1_plain(pq, pt, valid_t)])
    if not bool((got == 2 ** 30).all()):
        raise AssertionError("no valid target must give 2^30 on every row")
    got = ck.hamming_nn_d1(pq, pt, vt)
    if int(got[:20].max()) != 0 or int(got[20:40].min()) == 0:
        raise AssertionError("kernel I counts an invalid target row")
    ms_b = cuda_ms(lambda: ck.hamming_nn_d1(pq, pt, vt), 20)
    phase("kernel I invalid targets", t0,
          f"{m} x {m} rows, {int(vt.sum())} targets valid, and none valid "
          f"(2^30 everywhere): bitwise; kernel {ms_b:.3f} ms")
    return bench


def with_holes(valid):
    """A copy of the validity [F, N] with frames ``HOLE_FRAMES`` wholly
    invalid, the last fifth of frame 3's rows and a seeded 5% of all rows."""
    import torch

    gen = torch.Generator(device=valid.device).manual_seed(5)
    holes = valid & (torch.rand(valid.shape, generator=gen,
                                device=valid.device) >= 0.05)
    holes[list(HOLE_FRAMES)] = False
    holes[3, -(valid.shape[1] // 5):] = False
    return holes


def check_d1_pairs(packed, valid, bench: dict, dev) -> dict:
    """Kernel I's pair-list form on the first chunk of config 2's pairs, on
    the store in place: against its plain version and, after the count
    rule, against the frame-pair count kernel. Returns kernel I's record."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import matching

    t0 = time.perf_counter()
    f, n = valid.shape
    pq, pt = torch.tril_indices(f, f, offset=-1, device=dev)
    pq, pt = pq[:C2_PAIRS_PER_CALL], pt[:C2_PAIRS_PER_CALL]
    p_cnt = pq.shape[0]
    # the orbit fills every slot of every frame: first the chunk on a copy
    # of the validity with holes, so short and empty frames are seen too
    holes = with_holes(valid)
    got = ck.hamming_d1_pairs(packed, packed, holes, pq, pt)
    check_bitwise("hamming_d1_pairs, validity with holes", [got],
                  [ck.hamming_d1_pairs_plain(packed, packed, holes, pq, pt)])
    check_bitwise("kernel I + count rule vs pair_counts, validity with holes",
                  [matching.all_pairs_good_counts(packed, holes, pq, pt)],
                  [ck.pair_counts(packed, holes, pq, pt)])
    got = ck.hamming_d1_pairs(packed, packed, valid, pq, pt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = ck.hamming_d1_pairs_plain(packed, packed, valid, pq, pt)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    check_bitwise("hamming_d1_pairs", [got], [ref])
    err = float((got - ref).abs().max())
    del ref
    counts = matching.all_pairs_good_counts(packed, valid, pq, pt)
    k5 = ck.pair_counts(packed, valid, pq, pt)
    check_bitwise("kernel I + count rule vs pair_counts", [counts], [k5])
    ms = cuda_ms(lambda: ck.hamming_d1_pairs(packed, packed, valid, pq, pt), 3)
    k5_ms = cuda_ms(lambda: ck.pair_counts(packed, valid, pq, pt), 3)
    nv = valid.sum(1).cpu().numpy()
    # every query row of a pair against the pair's valid target rows
    work = pair_work(np.full(f, n), nv, pq.cpu(), pt.cpu())
    b = bound(packed.numel() * 4 + valid.numel() + 8 * p_cnt + got.numel() * 4,
              512.0 * work, "b1")
    phase("kernel I hamming_d1_pairs", t0,
          f"{p_cnt} pairs of the {f} x {n}-row store in place: bitwise "
          f"against the plain version on all pairs, counts equal "
          f"pair_counts' (max {int(counts.max())}), both also with "
          f"{int((valid & ~holes).sum())} rows marked invalid (frames "
          f"{HOLE_FRAMES} whole); kernel {ms:.3f} ms = "
          f"{p_cnt * n * n / ms / 1e6:.1f} G row pairs/s, plain "
          f"{plain_ms:.1f} ms (one run), pair_counts {k5_ms:.3f} ms, bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=bench["library_ms"],
                library_at=f"{D1_BENCH_ROWS} x {D1_BENCH_ROWS} rows, one pair",
                shape=f"{p_cnt} pairs x {n} x {n} rows",
                single_pair_8192=bench)


def config2_memory(frames_dev, cfg, pattern, signed, valid, dev) -> None:
    """Peak device memory of config 2 by stage, each as the rise over what
    was allocated when the stage began: one front-end batch step by step
    (the steps of ``orb.detect_and_describe_batch``, every intermediate kept
    alive as it keeps them) and as the one call, the store, and one dense
    chunk of pairs."""
    import torch

    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
    from slam_loop_closing_tpu_torch.ops import fast as fast_ops
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import matching, orb

    t0 = time.perf_counter()
    gb = 1e9

    def staged(fn):
        """(result, peak rise in GB, rise kept after the stage in GB)"""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return (out, (torch.cuda.max_memory_allocated() - base) / gb,
                (torch.cuda.memory_allocated() - base) / gb)

    resident = torch.cuda.memory_allocated() / gb
    steps = []
    imgs, pk, kept = staged(
        lambda: image_ops.ship_frames(frames_dev[:C2_BATCH], dev))
    steps.append(f"float32 frames +{pk:.2f} (kept {kept:.2f})")
    levels, pk, kept = staged(
        lambda: image_ops.pyramid(imgs, cfg.num_levels, cfg.scale_factor))
    steps.append(f"pyramid +{pk:.2f} (kept {kept:.2f})")
    budgets = orb._level_budgets(cfg.num_features, cfg.num_levels,
                                 cfg.scale_factor)
    dets, pk, kept = staged(lambda: [fast_ops.detect_with_blur(
        lv, threshold=cfg.fast_threshold / 255.0, num_features=budget,
        nms_radius=cfg.nms_radius, border=cfg.border,
        grid_cell=cfg.grid_cell) for lv, budget in zip(levels, budgets)])
    steps.append(f"kernel A and top-K on every level +{pk:.2f} (kept "
                 f"{kept:.2f}: the blurred levels)")
    patches, pk, kept = staged(lambda: torch.cat(
        [orb.extract_patches_fast(d[3], d[0]) for d in dets], dim=1))
    steps.append(f"kernel B's [{C2_BATCH}, {cfg.num_features}, 32, 32] "
                 f"patches +{pk:.2f} (kept {kept:.2f})")
    val = torch.cat([d[2] for d in dets], dim=1).reshape(-1)
    flat = patches.reshape(-1, orb.PATCH, orb.PATCH)

    def describe():
        ang = orb.orientation_from_patches(
            flat, val, orb._moment_weights_on(torch.device(dev)))
        return orb.brief_from_patches_binned(flat, ang, val, pattern)

    _, pk, kept = staged(describe)
    steps.append(f"orientation and the 30 BRIEF products +{pk:.2f} (kept "
                 f"{kept:.2f})")
    del imgs, levels, dets, patches, flat, val
    _, batch_pk, _ = staged(lambda: orb.detect_and_describe_batch(
        image_ops.ship_frames(frames_dev[:C2_BATCH], dev), cfg, pattern))
    packed, pk_store, kept_store = staged(
        lambda: desc_ops.signed_to_packed(signed))
    f = valid.shape[0]
    pq, pt = torch.tril_indices(f, f, offset=-1, device=dev)
    _, pk_chunk, _ = staged(lambda: matching.all_pairs_good_counts(
        packed, valid, pq[:C2_PAIRS_PER_CALL], pt[:C2_PAIRS_PER_CALL]))
    phase("config 2 memory by stage", t0,
          f"GB, each stage's peak over its start: resident before "
          f"{resident:.2f} (the uint8 frames {frames_dev.numel() / gb:.2f}, "
          f"the signed store {signed.numel() / gb:.2f}); one front-end batch "
          f"of {C2_BATCH} as one call +{batch_pk:.2f}, step by step: "
          + "; ".join(steps) + f"; packing the store +{pk_store:.2f} (kept "
          f"{kept_store:.2f}); one dense chunk of {C2_PAIRS_PER_CALL} pairs "
          f"+{pk_chunk:.2f} (the [P, N] int32 distances "
          f"{C2_PAIRS_PER_CALL * valid.shape[1] * 4 / gb:.2f})")


def config2_front_end(frames_dev, cfg, pattern, dev):
    """BASELINE config 2's front-end over the resident uint8 frames in
    batches of C2_BATCH: the store's (signed descriptors, validity)."""
    import torch

    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import orb

    s_chunks, v_chunks = [], []
    for s in range(0, frames_dev.shape[0], C2_BATCH):
        feats = orb.detect_and_describe_batch(
            image_ops.ship_frames(frames_dev[s:s + C2_BATCH], dev), cfg,
            pattern)
        s_chunks.append(feats.signed)
        v_chunks.append(feats.keypoints.valid)
    return torch.cat(s_chunks), torch.cat(v_chunks)


def run_config2(frames_u8: np.ndarray, bench: dict, dev, device_ms: dict,
                mesh, sharded_rec: dict):
    """BASELINE config 2, the dense all-pairs main path at full width, and
    the ring's banded counts on its store: returns (launch counts of the
    timed run, kernel I's record, the ring's launch counts)."""
    import torch

    from slam_loop_closing_tpu_torch.config import LoopConfig, OrbConfig
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import matching, orb

    t0 = time.perf_counter()
    cfg = OrbConfig(num_features=C2_FEATURES, grid_cell=8)
    loop_cfg = LoopConfig()                  # gap 30, threshold 0.15, >= 50
    b = frames_u8.shape[0]
    frames_dev = torch.from_numpy(frames_u8).to(dev)
    pattern = orb.brief_matrices(cfg, dev)

    def front_end():
        return config2_front_end(frames_dev, cfg, pattern, dev)

    # warm-up pass: its store feeds kernel I's check and the dense warm-up
    signed, valid = front_end()
    nfeat = valid.sum(1).cpu().numpy().astype(np.int64)
    phase("config 2 store", t0,
          f"{b} x {C2_H}x{C2_W} uint8 on the card, ORB-{C2_FEATURES} grid 8, "
          f"batches of {C2_BATCH}: valid rows a frame {nfeat.min()}-"
          f"{nfeat.max()}")
    check_front_end_kernels(
        f"config 2's batch of {C2_BATCH} x {C2_H}x{C2_W}, ORB-{C2_FEATURES}",
        image_ops.ship_frames(frames_dev[:C2_BATCH], dev), cfg)
    record = check_d1_pairs(desc_ops.signed_to_packed(signed), valid, bench,
                            dev)

    # both dense routes on the first frames of the store with holes in its
    # validity (the descriptors stay: an invalid row is masked, not read)
    t0 = time.perf_counter()
    d = min(b, C2_HOLE_DEPTH)
    holes = with_holes(valid[:d])
    by_pairs = matching.dense_pair_counts_chunked(
        signed[:d], holes, min_gap=1, pairs_per_call=C2_PAIRS_PER_CALL)
    by_tiles = matching.banded_pair_counts_chunked(signed[:d], holes, 1)
    if not np.array_equal(by_pairs, by_tiles) or by_pairs[HOLE_FRAMES[1]].any(
            ) or by_pairs[:, HOLE_FRAMES[0]].any():
        raise AssertionError(
            f"with holes in the validity the pair route and the tile route "
            f"differ at {int((by_pairs != by_tiles).sum())} of {d * d} "
            f"entries, or an empty frame has counts")
    phase("config 2 routes, validity with holes", t0,
          f"the first {d} frames, {int((valid[:d] & ~holes).sum())} rows "
          f"marked invalid (frames {HOLE_FRAMES} whole): the pair route's and "
          f"the tile route's [{d}, {d}] matrices equal, empty frames count 0")
    del holes, by_pairs, by_tiles

    t0 = time.perf_counter()
    n_pairs = b * (b - 1) // 2
    chunks = -(-n_pairs // C2_PAIRS_PER_CALL)
    matching.dense_pair_counts_chunked(
        signed, valid, min_gap=1, pairs_per_call=C2_PAIRS_PER_CALL)  # warm
    del signed, valid
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t_fe = time.perf_counter()
    signed, valid = front_end()
    torch.cuda.synchronize()
    t_dense = time.perf_counter()
    t_fe = t_dense - t_fe
    cnp = matching.dense_pair_counts_chunked(
        signed, valid, min_gap=1, pairs_per_call=C2_PAIRS_PER_CALL)
    t_dense = time.perf_counter() - t_dense
    launches = dict(ck.LAUNCHES)
    if launches["hamming_d1"] != chunks:
        raise AssertionError(f"kernel I launched {launches['hamming_d1']} "
                             f"times for {chunks} chunks of pairs")
    if not all(launches[k] for k in C2_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the Version-A rule on the dense matrix, the gap applied at decision
    denom = np.maximum(np.minimum(nfeat[:, None], nfeat[None, :]), 1)
    sims = cnp / denom
    q = np.arange(b)[:, None]
    t = np.arange(b)[None, :]
    loops = ((t <= q - loop_cfg.min_loop_gap)
             & (sims > loop_cfg.loop_threshold)
             & (cnp >= loop_cfg.min_matches))
    if cnp.shape != (b, b) or np.triu(cnp).any() or not np.isfinite(sims).all():
        raise AssertionError("the dense matrix is not a finite strict lower "
                             "triangle")
    if not loops[3 * b // 4:, :b // 4].any():
        raise AssertionError("the orbit's closing loop was not found")
    row_pairs = n_pairs * float(C2_FEATURES) ** 2
    phase("slice config 2", t0,
          f"front-end {t_fe:.3f} s = {b / t_fe:.1f} frames/s; "
          f"dense_pair_counts_chunked(min_gap=1): {n_pairs} frame pairs in "
          f"{chunks} launches of kernel I, {t_dense:.3f} s = "
          f"{n_pairs / t_dense:.0f} frame pairs/s = "
          f"{row_pairs / t_dense / 1e9:.1f} G row pairs/s; front-end + dense "
          f"{t_fe + t_dense:.3f} s = {b / (t_fe + t_dense):.2f} frames/s; "
          f"{int(loops.sum())} loops at gap {loop_cfg.min_loop_gap}, closing "
          f"loop found; peak device memory {peak_gb:.2f} GB; launches "
          f"{launches}")

    _, prof, _ = profiled(lambda: matching.dense_pair_counts_chunked(
        *front_end(), min_gap=1, pairs_per_call=C2_PAIRS_PER_CALL))
    kernel_device_ms(prof, "config 2, front-end + dense", device_ms)
    config2_memory(frames_dev, cfg, pattern, signed, valid, dev)
    del frames_dev

    # the same band through kernel C's tiles
    t0 = time.perf_counter()
    matching.banded_pair_counts_chunked(signed, valid, 1)           # warm
    torch.cuda.synchronize()
    t_tiles = time.perf_counter()
    tiles = matching.banded_pair_counts_chunked(signed, valid, 1)
    t_tiles = time.perf_counter() - t_tiles
    if not np.array_equal(tiles, cnp):
        raise AssertionError(
            f"the pair route and the tile route differ at "
            f"{int((tiles != cnp).sum())} of {b * b} entries")
    phase("config 2 tile route", t0,
          f"banded_pair_counts_chunked(min_gap=1), 8-frame tiles through "
          f"kernel C: the same [{b}, {b}] matrix; {t_tiles:.3f} s = "
          f"{row_pairs / t_tiles / 1e9:.1f} G row pairs/s (pair route "
          f"{t_dense:.3f} s)")
    ring_launches = run_sharded_band(mesh, signed, valid, nfeat, cnp,
                                     loop_cfg.min_loop_gap, device_ms,
                                     sharded_rec)
    return launches, record, ring_launches


def run_multivideo(videos_u8: np.ndarray, dev, device_ms: dict, mesh,
                   sharded_rec: dict):
    """bench_multivideo.py's main path, then ``process_videos_sharded`` on
    the same videos; returns both timed runs' launches."""
    import torch

    from slam_loop_closing_tpu_torch.config import (LoopConfig, OrbConfig,
                                                    PipelineConfig)
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import matching, orb

    v, b = videos_u8.shape[:2]
    cfg = dataclasses.replace(
        PipelineConfig(), orb=OrbConfig(num_features=MV_FEATURES),
        loop=LoopConfig(min_loop_gap=max(3, b // 3)))

    # the kernels at this path's shapes: A and B on one video's batch, C on
    # the flat padded store of all videos with every video's tile list
    check_front_end_kernels(
        f"one video of {b} x {MV_H}x{MV_W}, ORB-{MV_FEATURES}",
        image_ops.ship_frames(videos_u8[0], dev), cfg.orb)
    t0 = time.perf_counter()
    pattern = orb.brief_matrices(cfg.orb, dev)
    feats = [orb.detect_and_describe_batch(image_ops.ship_frames(video, dev),
                                           cfg.orb, pattern)
             for video in videos_u8]
    valid = torch.stack([f.keypoints.valid for f in feats])
    valid[1, 7] = False                        # an empty frame in one video
    packed, vflat, qidx, tidx, _, _ = matching.video_band_tiles(
        torch.stack([f.signed for f in feats]), valid, cfg.loop.min_loop_gap)
    got = ck.band_count_tiles(packed, vflat, qidx, tidx, 16)
    check_bitwise("band_count_tiles on the videos' flat store", [got],
                  [ck.band_count_tiles_plain(packed, vflat, qidx, tidx, 16)])
    phase("kernel C, multi-video", t0,
          f"the flat store of {v} videos padded to {packed.shape[0]} frames x "
          f"{packed.shape[1]} rows (one frame emptied), {qidx.shape[0]} tiles "
          f"of 16x16 frames, block indices {qidx.tolist()} x {tidx.tolist()}:"
          f" bitwise (max count {int(got.max())})")
    del feats, packed, vflat, got

    t0 = time.perf_counter()
    LoopClosingSystem.process_videos_batched(videos_u8, cfg, device=dev)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t_run = time.perf_counter()
    loops = LoopClosingSystem.process_videos_batched(videos_u8, cfg,
                                                     device=dev)
    t_run = time.perf_counter() - t_run
    launches = dict(ck.LAUNCHES)
    if launches["band_count_tiles"] != 1 or not all(
            launches[k] for k in MV_KERNELS):
        raise AssertionError(f"multi-video launches: {launches}")
    for i in range(v):
        alone = LoopClosingSystem(cfg, max_frames=b, device=dev
                                  ).process_video(videos_u8[i])
        if not alone or loops[i] != alone:
            raise AssertionError(
                f"video {i}: {len(loops[i])} loops batched, {len(alone)} "
                f"alone, first differing "
                f"{[(x, y) for x, y in zip(loops[i], alone) if x != y][:2]}")
    phase("slice process_videos_batched", t0,
          f"{v} videos x {b} x {MV_H}x{MV_W} uint8 from host, "
          f"ORB-{MV_FEATURES}, gap {cfg.loop.min_loop_gap}: loops per video "
          f"{[len(x) for x in loops]}, each equal to process_video alone; "
          f"warm run {t_run * 1e3:.1f} ms = {v * b / t_run:.1f} frames/s; "
          f"launches {launches}")
    _, prof, _ = profiled(lambda: LoopClosingSystem.process_videos_batched(
        videos_u8, cfg, device=dev))
    kernel_device_ms(prof, "process_videos_batched", device_ms)
    return launches, run_sharded_videos(mesh, videos_u8, cfg, loops,
                                        device_ms, sharded_rec)


def run_multi_loop(dev) -> dict:
    """The multi-loop fixture through ``process_video`` on the CPU and on
    the card, against its ground truth, and the tensor-core kernels on its
    unsaturated store; returns the card run's launch counts."""
    import torch

    from slam_loop_closing_tpu_torch.config import (LoopConfig, OrbConfig,
                                                    PipelineConfig)
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import matching
    from slam_loop_closing_tpu_torch.utils.synth_video import (
        ground_truth_loop_pairs, multi_loop_sequence)

    t0 = time.perf_counter()
    frames, thetas, ys = multi_loop_sequence(
        num_frames=ML_FRAMES, h=ML_H, w=ML_W, num_points=ML_POINTS,
        seed=ML_SEED, distractor_dy=ML_DY)
    truth = set(zip(*(v.tolist() for v in np.nonzero(
        ground_truth_loop_pairs(thetas, ys, ML_GAP)))))
    dth = np.abs(thetas[:, None] - thetas[None, :])
    dth = np.minimum(dth, 2 * np.pi - dth)
    dy = np.abs(ys[:, None] - ys[None, :])
    cfg = dataclasses.replace(
        PipelineConfig(),
        orb=OrbConfig(num_features=ML_FEATURES, num_levels=2),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=ML_GAP,
                        frame_skip=1))
    got, launches = {}, None
    for d in ("cpu", dev):
        system = LoopClosingSystem(cfg, max_frames=ML_FRAMES,
                                   log=lambda _: None, device=d)
        ck.reset_launch_counts()
        system.process_video(frames)
        launches = dict(ck.LAUNCHES)
        got[d] = {(c.current_frame_id, c.matched_frame_id): c.num_matches
                  for c in system.get_loop_closures()}
    if not all(launches[k] for k in VIDEO_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    loops = set(got[dev])
    if loops != set(got["cpu"]):
        raise AssertionError(
            f"multi-loop fixture: the loop sets differ at "
            f"{sorted(loops ^ set(got['cpu']))[:10]}")
    band = [(q, t) for q in range(ML_FRAMES) for t in range(q - ML_GAP + 1)]
    non_loops = len(band) - len(loops)
    if len(loops) < 100 or non_loops < 100:
        raise AssertionError(f"the fixture does not discriminate: "
                             f"{len(loops)} loops, {non_loops} non-loops")
    if not truth or not truth <= loops:
        raise AssertionError(f"true revisits missed: {sorted(truth - loops)}")
    hard = [p for p in loops if dy[p] >= ML_DY - 2.0 and dth[p] < 0.2]
    diff = max(abs(got["cpu"][k] - got[dev][k]) for k in loops)
    phase("slice multi-loop process_video", t0,
          f"{ML_FRAMES} x {ML_H}x{ML_W} ORB-{ML_FEATURES}, gap {ML_GAP}: CPU "
          f"and card give the same {len(loops)} loops of {len(band)} band "
          f"pairs ({non_loops} non-loops), max match-count difference "
          f"{diff}; all {len(truth)} true revisit pairs are loops; the raw "
          f"rule also joins {len(hard)} distractor pairs (geometric "
          f"verification rejects those); launches {launches}")

    # the kernels on this store: distances of every size, not only near 0
    t0 = time.perf_counter()
    packed = system.db.packed[:ML_FRAMES]
    valid = system.db.valid[:ML_FRAMES]
    check_bitwise("tensor-core tile product",
                  [ck.hamming_tile_product(packed[0], packed[ML_FRAMES - 1])],
                  [ck.hamming_tile_product_plain(packed[0],
                                                 packed[ML_FRAMES - 1])])
    block = 16
    qidx, tidx = torch.tensor(
        matching.band_tiles(ML_FRAMES // block, block, ML_GAP),
        dtype=torch.int32, device=dev).T
    tiles = ck.band_count_tiles(packed, valid, qidx, tidx, block)
    check_bitwise("band_count_tiles on the multi-loop store", [tiles],
                  [ck.band_count_tiles_plain(packed, valid, qidx, tidx,
                                             block)])
    pq, pt = torch.tensor(band, dtype=torch.int32, device=dev).T
    d1 = ck.hamming_d1_pairs(packed, packed, valid, pq, pt)
    check_bitwise("hamming_d1_pairs on the multi-loop store", [d1],
                  [ck.hamming_d1_pairs_plain(packed, packed, valid, pq, pt)])
    counts = ck.pair_counts(packed, valid, pq, pt)
    check_bitwise("pair_counts on the multi-loop store", [counts],
                  [ck.pair_counts_plain(packed, valid, pq, pt)])
    check_bitwise("kernel I + count rule vs pair_counts, multi-loop store",
                  [matching.all_pairs_good_counts(packed, valid, pq, pt)],
                  [counts])
    lo, hi = int(counts.min()), int(counts.max())
    if not lo < 50 < 150 < hi:
        raise AssertionError(f"the store saturates: counts {lo}-{hi}")
    phase("kernels C, I, K5 on the multi-loop store", t0,
          f"{ML_FRAMES} x {packed.shape[1]} rows: the raw [64, 64] product "
          f"equals popc(q & t); {qidx.shape[0]} tiles of {block}x{block} "
          f"frames, {len(band)} band pairs: bitwise; counts {lo}-{hi}, "
          f"nearest distances {int(d1.min())}-"
          f"{int(d1[d1 < 2 ** 30].max())}")
    return launches


# ---------------------------------------------------------------------------
# the sharded paths (parallel/) at world size 1 over NCCL
# ---------------------------------------------------------------------------

TIMING_RUNS = 5          # synchronized calls a sharded phase times


def sharded_timing(fn):
    """``fn()`` timed and profiled after the caller's own first run: the
    median wall seconds of ``TIMING_RUNS`` synchronized calls (each call's
    in ``walls_ms``), then one call under the profiler: its device ms
    (kernels, copies and memsets), the ms of the kernels whose name has
    "nccl", its idle share and the profile; ``outs`` holds every call's
    result, for the caller to check."""
    import torch

    walls, outs = [], []
    for _ in range(TIMING_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    out, prof, pwall = profiled(fn)
    outs.append(out)
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / 1e3
    nccl = sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if "nccl" in e.key.lower()) / 1e3
    return dict(wall_ms=float(np.median(walls)), walls_ms=walls,
                device_ms=busy, nccl_ms=nccl,
                idle=max(0.0, 1.0 - busy / (pwall * 1e3)), prof=prof,
                outs=outs)


def timing_text(t: dict) -> str:
    return (f"wall {t['wall_ms']:.2f} ms a call (median of {TIMING_RUNS}: "
            f"{', '.join(f'{w:.2f}' for w in t['walls_ms'])}); under the "
            f"profiler device "
            f"{t['device_ms']:.3f} ms (NCCL kernels {t['nccl_ms']:.4f} ms), "
            f"idle share {t['idle']:.0%}")


def sharded_phase(name: str, t0: float, result: str, t: dict,
                  device_ms: dict, sharded: dict) -> None:
    sharded[name] = {k: round(v, 4) for k, v in t.items()
                     if isinstance(v, float)}
    sharded[name]["walls_ms"] = [round(w, 4) for w in t["walls_ms"]]
    phase(f"sharded {name}", t0, f"{result}; {timing_text(t)}")
    kernel_device_ms(t["prof"], f"sharded {name}", device_ms)


def counted(ck, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (its result, the counts)."""
    ck.reset_launch_counts()
    out = fn()
    return out, dict(ck.LAUNCHES)


def run_sharded_frontend(mesh, frames_dev, device_ms: dict,
                         sharded_rec: dict) -> dict:
    """``frontend_sharded`` on the headline's 96 x 1080p frames, bitwise
    equal to ``detect_and_describe_batch``; returns its launches."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import image as image_ops
    from slam_loop_closing_tpu_torch.ops import orb
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    cfg = slice_config().orb
    pattern = orb.brief_matrices(cfg, mesh.device)
    ref = orb.detect_and_describe_batch(
        image_ops.ship_frames(frames_dev, mesh.device), cfg, pattern)

    def check(got):
        for a, b, what in zip(
                (*got.keypoints, got.descriptors, got.signed),
                (*ref.keypoints, ref.descriptors, ref.signed),
                (*orb.Keypoints._fields, "descriptors", "signed")):
            if not torch.equal(a, b):
                raise AssertionError(f"frontend_sharded's {what} differ from "
                                     "detect_and_describe_batch's")

    got, launches = counted(ck, lambda: sharded.frontend_sharded(
        mesh, frames_dev, cfg, pattern))
    check(got)
    if not all(launches[k] for k in ORB_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    t = sharded_timing(lambda: sharded.frontend_sharded(mesh, frames_dev,
                                                        cfg, pattern))
    for out in t["outs"]:
        check(out)
    sharded_phase("frontend_sharded", t0,
                  f"{frames_dev.shape[0]} x {H}x{W} ORB-{NUM_FEATURES} grid "
                  f"8 on {mesh.size} rank: every field of every call bitwise "
                  f"equal to detect_and_describe_batch "
                  f"({int(got.keypoints.valid.sum())} keypoints); launches "
                  f"{launches}", t, device_ms,
                  sharded_rec)
    return launches


def run_sharded_band(mesh, signed, valid, nfeat, cnp, gap: int,
                     device_ms: dict, sharded_rec: dict) -> dict:
    """``banded_loop_counts`` on config 2's store against the pair route's
    matrix ``cnp`` (every t < q): the ring's raw matrix zero exactly on the
    tiles the JAX rule skips and ``cnp`` elsewhere, the band's counts and
    similarities bitwise the single-device route's, the same loops; returns
    its launches."""
    import torch

    from slam_loop_closing_tpu_torch.config import LoopConfig
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import matching
    from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    block = 8
    b = signed.shape[0]
    m = mesh.size * block
    sp, _ = mesh_lib.pad_to_multiple(signed, m)
    vp, _ = mesh_lib.pad_to_multiple(valid, m)
    raw, raw_launches = counted(ck, lambda: sharded.ring_similarity_counts(
        mesh, sp, vp, min_gap=gap, block=block))
    raw = raw[:b, :b].cpu().numpy()
    q = np.arange(b)[:, None] // block * block
    t = np.arange(b)[None, :] // block * block
    computed = t <= q + block - 1 - gap
    if not np.array_equal(raw, np.where(computed, cnp, 0)):
        raise AssertionError(
            f"the ring's raw matrix differs from the pair route's on the "
            f"computed tiles, or is not zero on the skipped ones, at "
            f"{int((raw != np.where(computed, cnp, 0)).sum())} entries")
    nf = torch.from_numpy(nfeat).to(mesh.device)
    (counts, sims), launches = counted(ck, lambda: sharded.banded_loop_counts(
        mesh, signed, valid, nf, gap, block=block))
    band = np.arange(b)[None, :] <= np.arange(b)[:, None] - gap
    counts = counts.cpu().numpy()
    ref_counts = np.where(band, cnp, 0)
    ref_sims = torch.where(torch.from_numpy(band).to(mesh.device),
                           matching.similarity(
                               torch.from_numpy(ref_counts).to(mesh.device),
                               nf[:, None], nf[None, :]), 0.0)
    if not np.array_equal(counts, ref_counts) or not torch.equal(sims,
                                                                 ref_sims):
        raise AssertionError("banded_loop_counts differs from the pair "
                             "route's counts or similarities in the band")
    rule = LoopConfig()
    sims, ref_sims = sims.cpu().numpy(), ref_sims.cpu().numpy()
    got = band & (sims > rule.loop_threshold) & (counts >= rule.min_matches)
    loops = band & (ref_sims > rule.loop_threshold) & (
        ref_counts >= rule.min_matches)
    if not got.any() or not np.array_equal(got, loops):
        raise AssertionError(f"the ring's loops differ from the pair "
                             f"route's: {int((got != loops).sum())} pairs")
    if launches["pair_counts"] != mesh.size or raw_launches[
            "pair_counts"] != mesh.size:
        raise AssertionError(f"the ring launched K5 {launches['pair_counts']} "
                             f"times in {mesh.size} steps")
    pairs = int(computed.sum())
    nv = nfeat.astype(np.float64)
    k5 = bound(b * signed.shape[1] * (32 + 1) + b * b * 4,
               2 * 256 * float((nv[:, None] * nv[None, :])[computed].sum()),
               "b1")
    tt = sharded_timing(lambda: sharded.banded_loop_counts(
        mesh, signed, valid, nf, gap, block=block))
    for c, s in tt["outs"]:
        if not (np.array_equal(c.cpu().numpy(), counts)
                and np.array_equal(s.cpu().numpy(), sims)):
            raise AssertionError("a timed call of banded_loop_counts differs "
                                 "from the checked one")
    sharded_phase("banded_loop_counts", t0,
                  f"config 2's store, {b} x {signed.shape[1]} rows, gap "
                  f"{gap}, {block}x{block}-frame tiles on {mesh.size} rank: "
                  f"raw ring zero on the skipped tiles and equal to the pair "
                  f"route's matrix on the {pairs} computed frame pairs; band "
                  f"counts bitwise (every timed call the same); "
                  f"{int(got.sum())} loops, the same set; "
                  f"one K5 launch a step (its bound {k5['bound_ms']:.2f} ms, "
                  f"by {k5['bound_by']}); launches {launches}", tt,
                  device_ms, sharded_rec)
    return launches


def run_sharded_videos(mesh, videos_u8, cfg, loops, device_ms: dict,
                       sharded_rec: dict) -> dict:
    """``process_videos_sharded`` on the multi-video configuration, equal
    to ``process_videos_batched``'s ``loops``; returns its launches."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    got, launches = counted(ck, lambda: sharded.process_videos_sharded(
        mesh, videos_u8, cfg))
    if got != loops:
        raise AssertionError("process_videos_sharded's loops differ from "
                             "process_videos_batched's")
    if launches["band_count_tiles"] != 1 or not all(
            launches[k] for k in MV_KERNELS):
        raise AssertionError(f"multi-video sharded launches: {launches}")
    t = sharded_timing(lambda: sharded.process_videos_sharded(
        mesh, videos_u8, cfg))
    if any(out != loops for out in t["outs"]):
        raise AssertionError("a timed call of process_videos_sharded gave "
                             "other loops")
    v, b = videos_u8.shape[:2]
    sharded_phase("process_videos_sharded", t0,
                  f"{v} videos x {b} x {MV_H}x{MV_W} uint8 from host on "
                  f"{mesh.size} rank: loops per video "
                  f"{[len(x) for x in got]}, equal to process_videos_batched"
                  f" in every call;"
                  f" launches {launches}", t, device_ms, sharded_rec)
    return launches


VERIFY_PAIRS, VERIFY_POINTS, VERIFY_HYPOTHESES = 256, 1000, 1024


def run_sharded_verify(mesh, device_ms: dict, sharded_rec: dict) -> None:
    """``verify_pairs_sharded`` on 256 synthetic pairs x 1,000 matches at
    1,024 hypotheses: every field equal to
    ``estimate_essential_ransac_pairs`` with the same generator seed."""
    import torch

    from slam_loop_closing_tpu_torch.config import RansacConfig
    from slam_loop_closing_tpu_torch.ops import lie, ransac
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    dev = mesh.device
    rng = np.random.default_rng(7)
    p, n = VERIFY_PAIRS, VERIFY_POINTS
    X = np.stack([rng.uniform(-3, 3, (p, n)), rng.uniform(-2, 2, (p, n)),
                  rng.uniform(4, 12, (p, n))], -1)
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.05, (p, 3)),
                                 dtype=torch.float32)).numpy()
    tr = np.stack([np.full(p, -1.0), rng.normal(0, 0.1, p),
                   rng.normal(0, 0.1, p)], -1)
    Xc = np.einsum("pij,pnj->pni", R, X) + tr[:, None]
    x1 = X[..., :2] / X[..., 2:]
    x2 = Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 5e-4, (p, n, 2))
    out = rng.random((p, n)) < rng.uniform(0.1, 0.4, (p, 1))
    x2[out] = rng.uniform(-0.5, 0.5, (int(out.sum()), 2))
    x1, x2 = (torch.tensor(a, dtype=torch.float32, device=dev)
              for a in (x1, x2))
    mask = torch.tensor(rng.random((p, n)) > 0.05, device=dev)
    cfg = RansacConfig(num_hypotheses=VERIFY_HYPOTHESES)
    focal = 0.8 * SFM_W

    def gen():
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        return g

    ref = ransac.estimate_essential_ransac_pairs(x1, x2, mask, gen(), focal,
                                                 cfg)

    def check(got):
        for field, a, b in zip(ransac.EssentialResult._fields, got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"verify_pairs_sharded's {field} "
                                     "differs from "
                                     "estimate_essential_ransac_pairs'")

    check(sharded.verify_pairs_sharded(mesh, x1, x2, mask, gen(), focal, cfg))
    inl = ref.num_inliers.cpu().numpy()
    t = sharded_timing(lambda: sharded.verify_pairs_sharded(
        mesh, x1, x2, mask, gen(), focal, cfg))
    for out in t["outs"]:
        check(out)
    sharded_phase("verify_pairs_sharded", t0,
                  f"{p} pairs x {n} matches (10-40% outliers), "
                  f"{VERIFY_HYPOTHESES} hypotheses on {mesh.size} rank: every "
                  f"field of every call equal to "
                  f"estimate_essential_ransac_pairs given the same noise; "
                  f"{int(ref.ok.sum())} pairs ok, inliers "
                  f"{inl.min()}-{inl.max()}", t, device_ms, sharded_rec)


@contextlib.contextmanager
def fixed_scatter_order():
    """``torch.use_deterministic_algorithms(True)`` inside the block: every
    PyTorch op with a nondeterministic CUDA version takes its deterministic
    one or raises. BA and PGO sum through kernel N in a fixed order with or
    without the mode (F12), so a run inside the block must give the bits of
    a run outside it; cuBLAS is held to its fixed-workspace setting
    (``CUBLAS_WORKSPACE_CONFIG``), which the mode requires."""
    import torch

    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before


PGO_POSES, PGO_LOOPS, PGO_ITERATIONS, PGO_CG = 10_000, 100, 10, 50


def pgo_config5_graph(dev, n_poses=PGO_POSES, n_loops=PGO_LOOPS,
                      noise=0.01, seed=0):
    """BASELINE config 5's graph as benchmarks/bench_pgo.py builds it: a
    noisy circle of ``n_poses`` poses, sequential edges and ``n_loops``
    loop edges of weight 10 across half the circle."""
    import torch

    from slam_loop_closing_tpu_torch.ops import pgo

    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    c, s = np.cos(angles), np.sin(angles)
    clean_R = np.zeros((n_poses, 3, 3))
    clean_R[:, 0, 0], clean_R[:, 0, 1] = c, -s
    clean_R[:, 1, 0], clean_R[:, 1, 1] = s, c
    clean_R[:, 2, 2] = 1.0
    clean_t = np.stack([c, s, np.zeros(n_poses)], -1) * 50
    params = np.concatenate([np.zeros((n_poses, 2)), angles[:, None],
                             clean_t], -1)
    params[1:] += rng.normal(0, noise, params[1:].shape)
    loop_ids = rng.integers(n_poses // 2, n_poses, n_loops)
    ef = np.concatenate([np.arange(n_poses - 1), loop_ids - n_poses // 2])
    et = np.concatenate([np.arange(1, n_poses), loop_ids])
    Rr = clean_R[et] @ clean_R[ef].transpose(0, 2, 1)
    tr = clean_t[et] - np.einsum("eij,ej->ei", Rr, clean_t[ef])
    w = np.where(et == ef + 1, 1.0, 10.0)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    g = pgo.PoseGraph(
        e_from=torch.tensor(ef, device=dev), e_to=torch.tensor(et, device=dev),
        R_rel=f32(Rr), t_rel=f32(tr), weight=f32(w),
        mask=torch.ones(len(ef), dtype=torch.bool, device=dev))
    return f32(params), g


def run_sharded_pgo(mesh, device_ms: dict, sharded_rec: dict,
                    n_shapes: dict) -> dict:
    """``pgo_sharded`` at BASELINE config 5 (PCG) against
    ``optimize_pose_graph``, with no deterministic mode: a second
    single-device run, the sharded run and every timed call bitwise equal
    to the first run (F12), and one run under
    ``torch.use_deterministic_algorithms(True)`` as well. Keeps the graph's
    edge index for kernel N's check (``n_shapes``); returns the sharded
    run's launches."""
    import torch

    from slam_loop_closing_tpu_torch.config import PgoConfig
    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.ops import pgo
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    params, g = pgo_config5_graph(mesh.device)
    n_shapes["PGO config 5"] = (torch.cat([g.e_from, g.e_to]),
                                params.shape[0], g.e_from.shape[0])
    cfg = PgoConfig(dense_solver_max_poses=0, cg_iterations=PGO_CG)
    ref, costs = pgo.optimize_pose_graph(params, g, cfg, PGO_ITERATIONS)
    (got, _), launches = counted(ck, lambda: sharded.pgo_sharded(
        mesh, params, g, cfg, PGO_ITERATIONS))
    runs = {"a second single-device run": pgo.optimize_pose_graph(
        params, g, cfg, PGO_ITERATIONS)[0], "the sharded run": got}
    with fixed_scatter_order():
        runs["the run in deterministic mode"] = pgo.optimize_pose_graph(
            params, g, cfg, PGO_ITERATIONS)[0]
    c0, c1 = float(costs[0]), float(costs[-1])
    if not c1 < 0.5 * c0:
        raise AssertionError(f"optimize_pose_graph: cost {c0} -> {c1}")
    dist = {k: float(torch.amax(torch.abs(v - ref))) for k, v in runs.items()}
    for what, v in runs.items():
        if not same_bits(v, ref):
            raise AssertionError(f"PGO at config 5: {what} differs from the "
                                 f"first run by up to {dist[what]}")
    if not launches["segment_sum"]:
        raise AssertionError(f"pgo_sharded did not launch kernel N: "
                             f"{launches}")
    t_single = sharded_timing(lambda: pgo.optimize_pose_graph(
        params, g, cfg, PGO_ITERATIONS))
    t = sharded_timing(lambda: sharded.pgo_sharded(mesh, params, g, cfg,
                                                   PGO_ITERATIONS))
    timed = max(float(torch.amax(torch.abs(out[0] - ref)))
                for out in t_single["outs"] + t["outs"])
    if not all(same_bits(out[0], ref)
               for out in t_single["outs"] + t["outs"]):
        raise AssertionError(f"a timed call of PGO differs from the first "
                             f"run by up to {timed}")
    sharded_phase("pgo_sharded", t0,
                  f"BASELINE config 5: {PGO_POSES} poses, {PGO_LOOPS} loop "
                  f"edges, {PGO_ITERATIONS} iterations of PCG "
                  f"({PGO_CG} CG steps) on {mesh.size} rank: cost {c0:.6g} "
                  f"-> {c1:.6g}; with no deterministic mode "
                  + ", ".join(f"{k} {v:.3g}" for k, v in dist.items())
                  + f" from the first run (bitwise equal), every timed call "
                  f"{timed:.3g}; kernel N launches {launches['segment_sum']};"
                  f" optimize_pose_graph alone: {timing_text(t_single)}", t,
                  device_ms, sharded_rec)
    return launches


def backend_indices(pipe, state, loop) -> dict:
    """Kernel N's indices at a Version-B run's backend, after its BA
    (name -> (index, segments, rows of the first source or None)): BA's
    camera and point index of the active observations (an invalid
    observation joins no segment) and the dense PGO's block index of the
    keyframe graph."""
    import torch

    obs = pipe._active_obs(state)
    dev = obs.cam.device
    k = int(state.kf_count)
    pb = pipe._bucket(int(state.point_count) + 1, state.points.shape[0])
    ef = torch.cat([torch.arange(k - 1, device=dev),
                    torch.tensor([loop.past_kf], device=dev)])
    et = torch.cat([torch.arange(1, k, device=dev),
                    torch.tensor([loop.curr_kf], device=dev)])
    return {"BA cameras": (torch.where(obs.valid, obs.cam.long(), -1),
                           state.poses.shape[0], None),
            "BA points": (torch.where(obs.valid, obs.point.long(), -1), pb,
                          None),
            "PGO keyframes, dense blocks": (
                torch.cat([ef * k + ef, et * k + et, ef * k + et,
                           et * k + ef]), k * k, None)}


def run_sharded_sfm(mesh, frames: np.ndarray, device_ms: dict,
                    sharded_rec: dict, n_shapes: dict) -> dict:
    """``sfm_reconstruct_sharded`` (with ``ba_sharded`` and ``pgo_sharded``
    inside) at the Version-B ORB configuration against the staged
    single-device twin, with no deterministic mode: a second twin run, the
    sharded run and every timed call bitwise equal to the first twin run in
    poses, points, point validity and final error (F12), and one twin run
    under ``torch.use_deterministic_algorithms(True)`` as well. Keeps the
    twin's BA and PGO indices for kernel N's check (``n_shapes``); returns
    the sharded run's launches."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    from slam_loop_closing_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    n = frames.shape[0]
    cfg = sfm_config()
    frames_dev = torch.from_numpy(frames).to(mesh.device)

    def twin():
        pipe = sfm_pipeline(cfg, n, mesh.device)
        s1, _ = pipe.run_frontend_and_keyframes_scan(frames_dev)
        loop1 = pipe.find_loop(s1)
        s1 = pipe.optimize(s1, loop1)
        s1, _ = pipe.bundle_adjust(s1)
        s1 = pipe.remove_outliers(s1)
        s1, errs2 = pipe.bundle_adjust(s1, outer_iterations=3)
        return s1, loop1, errs2, pipe

    s1, loop1, errs2, pipe = twin()
    e2 = float(errs2[-1])
    torch.cuda.synchronize()
    t_twin = time.perf_counter() - t0
    n_shapes.update(backend_indices(pipe, s1, loop1))
    t1 = time.perf_counter()
    (s2, m), launches = counted(
        ck, lambda: sharded.sfm_reconstruct_sharded(
            mesh, sfm_pipeline(cfg, n, mesh.device), frames_dev))
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t1
    s3, _, errs3, _ = twin()
    with fixed_scatter_order():
        s4, _, errs4, _ = twin()
    ref = (s1, e2)
    runs = {"a second twin run": (s3, float(errs3[-1])),
            "the sharded run": (s2, m["e2"]),
            "the twin in deterministic mode": (s4, float(errs4[-1]))}
    dist = {}
    for what, run in runs.items():
        same, dist[what] = map_distance(run, ref)
        if not same:
            raise AssertionError(
                f"sfm_reconstruct_sharded's phase: {what} differs from the "
                f"first twin run: poses {dist[what]} apart, final errors "
                f"{run[1]} and {e2}")
    if not (m["loop_found"] == loop1.found and loop1.found
            and int(s2.kf_count) == int(s1.kf_count)
            and int(s2.point_count) == int(s1.point_count)):
        raise AssertionError(
            f"sfm_reconstruct_sharded against the staged twin: keyframes "
            f"{int(s2.kf_count)}/{int(s1.kf_count)}, points "
            f"{int(s2.point_count)}/{int(s1.point_count)}, loop "
            f"{m['loop_found']}/{loop1.found}")
    if not all(launches[k] for k in SFM_KERNELS):
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    t = sharded_timing(lambda: sharded.sfm_reconstruct_sharded(
        mesh, sfm_pipeline(cfg, n, mesh.device), frames_dev))
    timed = []
    for s5, m5 in t["outs"]:
        same, d = map_distance((s5, m5["e2"]), ref)
        timed.append(d)
        if not same:
            raise AssertionError(
                f"a timed call of sfm_reconstruct_sharded differs from the "
                f"first twin run: poses {d} apart, final errors {m5['e2']} "
                f"and {e2}")
    sharded_phase("sfm_reconstruct_sharded", t0,
                  f"{n} x {SFM_H}x{SFM_W} resident, ORB-{SFM_FEATURES} grid "
                  f"8, 1024 hypotheses on {mesh.size} rank: keyframes "
                  f"{m['keyframes']}, points {int(s2.point_count)}, loop "
                  f"found, as the staged twin; with no deterministic mode "
                  + ", ".join(f"{k} {v:.3g}" for k, v in dist.items())
                  + f" from the first twin run in poses (poses, points, "
                  f"point validity and final error bitwise equal), every "
                  f"timed call {max(timed):.3g}; reprojection "
                  f"{m['e0']:.4f} -> {m['e1']:.4f} -> {m['ef']:.4f} -> "
                  f"{m['e2']:.4f} px (twin's final {e2:.4f}); first twin run "
                  f"{t_twin:.3f} s in all, sharded {t_sh:.3f} s; launches "
                  f"{launches}", t, device_ms, sharded_rec)
    return launches


# kernel N's calls at each index, as the path makes them: the row shapes
# of the sums of one launch (BA: H alone, the record; H and g, a
# Gauss-Newton step's launch; the squared errors. PGO at config 5: the CG
# product, the record; the gradient and the diagonal, a PCG step's first
# launch; both with the from- and to-edges' terms as two sources)
N_SHAPE_CALLS = {"BA cameras": (((6, 6),), ((6, 6), (6,)), ((),)),
                 "BA points": (((3, 3),), ((3, 3), (3,)), ((),)),
                 "PGO keyframes, dense blocks": (((6, 6),),),
                 "PGO config 5": (((6,),), ((6,), (6, 6)))}
N_RECORD = "BA cameras, 36"   # the longest segments
N_REPS, N_ROUNDS = 50, 7    # kernel N's and index_add_'s timing, in turns


def alternating_ms(fns, reps: int, rounds: int) -> list:
    """Each of ``fns``' :func:`cuda_ms` of ``reps`` calls, the functions
    in turns, ``rounds`` times: (median, least, most) for each. A
    host-paced call's time moves between rounds about as much as between
    two forms, so forms are compared in turns."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn, reps))
    return [(float(np.median(t)), min(t), max(t)) for t in times]


def host_us(fn, reps: int) -> float:
    """Microseconds of the host's own time a call of ``fn()``: ``reps``
    calls enqueued back to back (the card keeps up), before the one
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def check_segment_sum(n_shapes: dict, dev) -> dict:
    """Kernel N against its plain version at the indices the Version-B ORB
    run and BASELINE config 5 give it (``n_shapes``: name -> (index,
    segments, rows of the first source or None)), in every call the path
    makes there (``N_SHAPE_CALLS``), on random float32 rows: bitwise. For
    each call, CUDA-event times (the median of ``N_ROUNDS`` rounds, in
    turns with ``index_add_``) and profiler times, the wrapper's host
    microseconds a call, the plain version's time, ``index_add_`` of the
    same rows (float atomics: the call it replaced; one a sum) and the
    bound: each row read once with its order entry, the offsets, the sums
    written once; an add a float on the FMA pipe. The record is the BA
    cameras' 6x6 normal matrices (the longest segments); ``shapes`` holds
    the rest."""
    import torch

    from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(14)
    shapes, lines = {}, []
    for name, (index, n, split) in n_shapes.items():
        plan = ck.segment_plan(index, n)
        e = index.shape[0]
        lengths = plan.offsets[1:] - plan.offsets[:-1]
        longest, n_long = int(lengths.max()), int(plan.long_count)
        keep = (index >= 0) & (index < n)
        idx = index[keep].long()
        for widths in N_SHAPE_CALLS[name]:
            vals = [torch.randn((e, *w), generator=gen, device=dev)
                    for w in widths]
            sums = [v if split is None else (v[:split], v[split:])
                    for v in vals]
            d = [math.prod(w) for w in widths]
            key = f"{name}, {'+'.join(map(str, d))}"
            got = ck.segment_sums(plan, *sums)
            check_bitwise(f"kernel N at {key}",
                          [g.view(torch.int32) for g in got],
                          [ck.segment_sum_plain(v, plan).view(torch.int32)
                           for v in vals])
            kept = [v[keep] for v in vals]

            def call():
                return ck.segment_sums(plan, *sums)

            def library():
                return [torch.zeros((n, *v.shape[1:]), device=dev).index_add_(
                    0, idx, v) for v in kept]

            (ms, ms_lo, ms_hi), (lib, lib_lo, lib_hi) = alternating_ms(
                (call, library), N_REPS, N_ROUNDS)
            rec = dict(
                rows=e, segments=n, width=d, longest_segment=longest,
                long_segments=n_long, max_abs_err=0.0, ms=ms,
                ms_range=[ms_lo, ms_hi], device_ms=device_ms(call, 20),
                host_us=host_us(call, 200),
                plain_ms=cuda_ms(lambda: [ck.segment_sum_plain(v, plan)
                                          for v in vals], 1),
                **bound_pipes(4 * (e * sum(d) + e + n + 1 + n * sum(d)),
                              {"ffma": e * sum(d)}))
            rec["library_ms"], rec["library_ms_range"] = lib, [lib_lo,
                                                                lib_hi]
            shapes[key] = rec
            lines.append(f"{key} ({e} rows, {n} segments, {n_long} long, "
                         f"longest {longest}): {ms:.4f} ms ({ms_lo:.4f}-"
                         f"{ms_hi:.4f}; device {rec['device_ms']:.4f}, host "
                         f"{rec['host_us']:.1f} us), plain "
                         f"{rec['plain_ms']:.2f}, index_add_ {lib:.4f} "
                         f"({lib_lo:.4f}-{lib_hi:.4f}), bound "
                         f"{rec['bound_ms']:.5f}")
    phase("kernel N segment_sum", t0, "bitwise at every shape; "
          + "; ".join(lines))
    main = dict(shapes.pop(N_RECORD))
    for key in ("rows", "segments", "width", "longest_segment",
                "long_segments"):
        main.pop(key)
    main["library"] = ("index_add_ of the same rows (float atomics, the "
                       "call it replaced)")
    main["shapes"] = shapes
    return main


def kernel_n_by_path(paths: dict, device_ms: dict) -> dict:
    """Kernel N's launches (``paths``: path -> launch counts of its run)
    and summed device ms (profiler) on each main path that runs it."""
    by_path = {p: dict(launches=c["segment_sum"],
                       device_ms=device_ms.get(p, {}).get("segment_sum"))
               for p, c in paths.items() if c["segment_sum"]}
    print(f"[kernel N by path] {json.dumps(by_path)}", flush=True)
    return by_path


def run_sharded_dryrun(mesh, sharded_rec: dict) -> None:
    """The port's dry run of every sharded stage at world size 1."""
    from slam_loop_closing_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s = dryrun.dryrun_multichip(mesh.size, device=mesh.device)
    line = buf.getvalue().strip()
    if line != dryrun.summary_line(s) or not s["loop_found"]:
        raise AssertionError(f"dry run: {line!r}")
    sharded_rec["dryrun"] = line
    phase("sharded dry run", t0, line)


def run_native_decoder(frames_u8: np.ndarray) -> None:
    """The native PNG decoder (``utils.native``): whether it builds and,
    where it does, the CLI frames decoded by it and by PIL (within 1/255),
    with both times."""
    from slam_loop_closing_tpu_torch.utils import io as io_utils
    from slam_loop_closing_tpu_torch.utils import native

    t0 = time.perf_counter()
    if not native.available():
        phase("native decoder", t0, "did not build or load ("
              + str(native.last_error).replace("\n", " ")[-600:]
              + "): the CLI reads frames with PIL")
        return
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, f in enumerate(frames_u8):
            paths.append(Path(tmp) / f"frame_{i:04d}.png")
            io_utils._write_png(paths[-1], f)
        t = time.perf_counter()
        got = native.load_frames_gray_native(paths)
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        pil = np.stack([io_utils.load_frame_gray(p) for p in paths])
        t_pil = time.perf_counter() - t
        via_io = io_utils.load_frames_gray(paths)
    err = float(np.abs(got - pil).max())
    if not err <= 1 / 255 or not np.array_equal(via_io, got):
        raise AssertionError(f"native decode differs from PIL by {err} or "
                             "utils.io does not read with it")
    phase("native decoder", t0,
          f"built ({native.library_path().name}); {len(paths)} CLI frames "
          f"{CLI_H}x{CLI_W}: within {err:.3g} of PIL (bound 1/255), "
          f"utils.io.load_frames_gray reads with it; native "
          f"{t_native * 1e3:.2f} ms, PIL {t_pil * 1e3:.2f} ms")


def _cli(argv) -> str:
    """Run the port's CLI in this process; its console output."""
    from slam_loop_closing_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def run_cli(frames_u8: np.ndarray, dev) -> None:
    """The CLI's loop, reconstruct and calibrate modes on the card."""
    from PIL import Image

    from slam_loop_closing_tpu_torch.config import PipelineConfig
    from slam_loop_closing_tpu_torch.models.loop_closing import \
        LoopClosingSystem
    from slam_loop_closing_tpu_torch.utils import io as io_utils
    from slam_loop_closing_tpu_torch.utils import synth_video

    t0 = time.perf_counter()
    small = ["--frame-skip", "1", "--num-features", "300", "--device", dev]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        seq = tmp / "seq"
        seq.mkdir()
        for i, f in enumerate(frames_u8):
            io_utils._write_png(seq / f"frame_{i:04d}.png", f)
        out = _cli(["loop", "--frames", str(seq), "--batched", "--min-gap",
                    "20", "--output", str(tmp / "results")] + small)
        text = (tmp / "results" / "loop_closures.txt").read_text()
        found = [(int(a), int(b), int(c), d) for a, b, c, d in re.findall(
            r"Frame (\d+) <-> Frame (\d+)\n  Matches: (\d+)\n"
            r"  Similarity: (\S+)", text)]
        cfg = PipelineConfig()
        cfg = dataclasses.replace(
            cfg, orb=dataclasses.replace(cfg.orb, num_features=300),
            loop=dataclasses.replace(cfg.loop, min_loop_gap=20, frame_skip=1))
        system = LoopClosingSystem(cfg, max_frames=512, device=dev)
        ref = system.process_video(io_utils.load_frames_gray(
            io_utils.enumerate_frames(seq)))
        want = [(c.current_frame_id, c.matched_frame_id, c.num_matches,
                 f"{c.similarity_score:g}") for c in ref]
        if not found or found != want:
            raise AssertionError(f"loop_closures.txt holds {len(found)} loops, "
                                 f"the library call {len(want)}, or they "
                                 "differ")
        for needle in ("=== Processing Complete ===",
                       f"Total frames processed: {len(frames_u8)}",
                       f"Loop closures detected: {len(found)}",
                       "Throughput: ", "Results: "):
            if needle not in out:
                raise AssertionError(f"the console block lacks {needle!r}")
        pngs = sorted((tmp / "results").glob("*.png"))
        names = {p.name for p in pngs}
        expect = {f"loop_{a}_{b}.png" for a, b, _, _ in found} | {
            f"matches_{i}_{i - 1}.png"
            for i in range(cfg.loop.viz_every, len(frames_u8),
                           cfg.loop.viz_every)}
        if names != expect:
            raise AssertionError(f"save_results wrote {sorted(names)[:4]}..., "
                                 f"expected {sorted(expect)[:4]}...")
        for p in pngs:
            with Image.open(p) as im:
                im.load()
                if im.size != (2 * CLI_W, CLI_H) or im.mode != "RGB":
                    raise AssertionError(f"{p.name}: {im.size} {im.mode}")
        phase("cli loop", t0,
              f"{len(frames_u8)} x {CLI_H}x{CLI_W} PNGs, --batched on the "
              f"card: {len(found)} loops in loop_closures.txt = the library "
              f"call's; {len(pngs)} PNGs decode")

        t0 = time.perf_counter()
        (tmp / "sfm.json").write_text(sfm_fixture()[0].to_json())
        out = _cli(["reconstruct", "--frames", str(seq), "--no-obj", "--scan",
                    "--max-keyframes", "32", "--config", str(tmp / "sfm.json"),
                    "--frame-skip", "1", "--data-dir", str(tmp / "data"),
                    "--device", dev])
        if "frames/sec end-to-end" not in out or "OBJ:" in out or (
                tmp / "data" / "reconstruction").exists():
            raise AssertionError("cli reconstruct --no-obj: " + out[-300:])
        kf = int(re.search(r"Total keyframes: (\d+)", out).group(1))
        before = float(re.search(
            r"Reprojection error BEFORE BA: (\S+) px", out).group(1))
        final = float(re.search(
            r"FINAL reprojection error: (\S+) px", out).group(1))
        if kf < len(frames_u8) // 2 or not final < before:
            raise AssertionError(f"cli reconstruct: {kf} keyframes, "
                                 f"reprojection {before} -> {final} px")
        loop = re.search(r"Best loop closure: (.*)", out)
        phase("cli reconstruct", t0,
              f"--no-obj --scan on the card, the SfM fixture's configuration:"
              f" {kf} keyframes, loop {loop.group(1) if loop else 'none'}, "
              f"reprojection {before:g} -> {final:g} px, no OBJ written")

        t0 = time.perf_counter()
        _, boards = synth_video.chessboard_views()
        calib = tmp / "calib"
        calib.mkdir()
        for i, img in enumerate(boards):
            io_utils._write_png(calib / f"board_{i}.png", to_u8(img))
        out = _cli(["calibrate", "--images", str(calib), "--device", dev,
                    "--output-overlays", str(tmp / "overlays")])
        rms = float(re.search(r"reprojection error: (\S+) px", out).group(1))
        fx = float(re.search(r"K =\n\[\[\s*(\S+)", out).group(1))
        if not rms < 1.0 or abs(fx - 300.0) > 15.0 or len(
                list((tmp / "overlays").glob("corners_*.png"))) != len(boards):
            raise AssertionError(f"cli calibrate: RMS {rms} px, fx {fx}")
        phase("cli calibrate", t0,
              f"{len(boards)} chessboard views: RMS {rms:.4f} px (< 1), fx "
              f"{fx:.2f} (true 300), overlays written")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the repository's root", file=sys.stderr)
        return 1
    from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
    from slam_loop_closing_tpu_torch.utils import cuda_build
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
    mesh = mesh_lib.make_mesh(device=dev)
    sharded_rec: dict = {}
    phase("mesh", t0, f"{mesh.size} rank, backend "
          f"{torch.distributed.get_backend()}, {mesh.device} (NCCL across "
          "GPUs needs more than one card: not measured here)")

    t0 = time.perf_counter()
    specs = [(FRAMES, H, W, 300, 0), (SFM_FRAMES, SFM_H, SFM_W, 400, 0),
             (SIFT_FRAMES, SIFT_H, SIFT_W, 400, 0),
             (C2_FRAMES, C2_H, C2_W, 400, 0), (CLI_FRAMES, CLI_H, CLI_W, 250, 3)]
    specs += [(MV_FRAMES, MV_H, MV_W, 300, seed) for seed in range(MV_VIDEOS)]
    with concurrent.futures.ProcessPoolExecutor(
            RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn")
            ) as pool:
        frames, sfm_frames, sift_frames, c2_frames, cli_frames, *videos = \
            render_orbits(pool, specs)
    frames_dev = torch.from_numpy(frames).to(dev)
    phase("frames", t0, f"{sum(sp[0] for sp in specs)} uint8 orbit frames "
          f"rendered by {RENDER_WORKERS} worker processes ({FRAMES} x {H}x{W}"
          f", {SFM_FRAMES} x {SFM_H}x{SFM_W}, {SIFT_FRAMES} x {SIFT_H}x"
          f"{SIFT_W}, {C2_FRAMES} x {C2_H}x{C2_W}, {MV_VIDEOS} x {MV_FRAMES} "
          f"x {MV_H}x{MV_W}, {CLI_FRAMES} x {CLI_H}x{CLI_W})")

    records, device_ms = check_kernels(frames_dev, dev), {}
    video_launches, video_loops = run_slice(frames_dev, dev, device_ms)
    stream_launches = run_stream(frames, dev, video_loops, device_ms)
    fe_launches = run_sharded_frontend(mesh, frames_dev, device_ms,
                                       sharded_rec)
    check_front_end_agreement(frames_dev, dev)
    check_cpu_agreement(dev)
    del frames, frames_dev
    torch.cuda.empty_cache()
    sfm_records = check_sfm_kernels(dev)
    records["motion_support"]["shapes"].update(
        sfm_records.pop("motion_support_shapes"))
    records.update(sfm_records)
    sfm_launches = run_sfm(sfm_frames, sfm_config(),
                           f"ORB-{SFM_FEATURES} grid 8", SFM_KERNELS, dev,
                           device_ms)
    n_shapes: dict = {}
    sfm_sh_launches = run_sharded_sfm(mesh, sfm_frames, device_ms,
                                      sharded_rec, n_shapes)
    check_sfm_agreement(dev)
    torch.cuda.empty_cache()
    run_sharded_verify(mesh, device_ms, sharded_rec)
    pgo_launches = run_sharded_pgo(mesh, device_ms, sharded_rec, n_shapes)
    records["segment_sum"] = check_segment_sum(n_shapes, dev)
    del n_shapes
    torch.cuda.empty_cache()

    records.update(check_sift_kernels(sift_frames, dev))
    check_sift_chunks(sift_frames, dev)
    sift_launches = run_sfm(sift_frames, sfm_config("sift"),
                            f"SIFT-{SIFT_FEATURES}", SIFT_KERNELS, dev,
                            device_ms)
    del sift_frames, sfm_frames
    check_sift_agreement(dev)
    torch.cuda.empty_cache()

    c2_launches, records["hamming_d1"], ring_launches = run_config2(
        c2_frames, check_d1_kernel(dev), dev, device_ms, mesh, sharded_rec)
    del c2_frames
    torch.cuda.empty_cache()
    mv_launches, mv_sh_launches = run_multivideo(
        np.stack(videos), dev, device_ms, mesh, sharded_rec)
    run_native_decoder(cli_frames)
    run_cli(cli_frames, dev)
    ml_launches = run_multi_loop(dev)
    run_sharded_dryrun(mesh, sharded_rec)
    torch.distributed.destroy_process_group()
    records["segment_sum"]["by_path"] = kernel_n_by_path({
        f"SfMPipeline.run ORB-{SFM_FEATURES} grid 8": sfm_launches,
        f"SfMPipeline.run SIFT-{SIFT_FEATURES}": sift_launches,
        "sharded sfm_reconstruct_sharded": sfm_sh_launches,
        "sharded pgo_sharded": pgo_launches}, device_ms)

    paths = (video_launches, stream_launches, sfm_launches, sift_launches,
             c2_launches, mv_launches, ml_launches, fe_launches,
             sfm_sh_launches, pgo_launches, ring_launches, mv_sh_launches)
    kernels = [dict(name=k, route="cuda",
                    source=f"slam_loop_closing_tpu_torch/csrc/{SOURCES[k]}",
                    replaces=REPLACES[k],
                    launches=sum(path[k] for path in paths),
                    **records[k])
               for k in ck.LAUNCHES]
    print(json.dumps({"sharded_paths": sharded_rec}))
    print(json.dumps({"device_ms_by_path": device_ms}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
