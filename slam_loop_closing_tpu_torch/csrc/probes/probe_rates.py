"""Probe of the rates behind the bounds of kernels A and G on the card:
builds ``rates.cu`` and times, in registers only and at 16 and 32 warps an
SM, chains of ``fminf``/``fmaxf`` (FMNMX), of ``fmaf`` (FFMA) and of
``mma.sync.m16n8k8`` tf32; then builds a copy of
``../fast_score_nms_blur.cu`` without its compass pre-test (written into the
build directory, the pre-test's call replaced by ``true``) and times both
forms of kernel A, each checked bitwise against the plain version, at each
pyramid level of 8 frames and of one frame at 1080p: orbit frames (the
smoke's headline frames) and uniform random 8-bit frames (the card tests'
texture, where most pixels pass the pre-test: its worst case), beside the
share of pixels that pass the pre-test and the share of 32-pixel row runs
(about a warp's pixels) that all fail it.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_rates.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exit
1 if a form of kernel A differs from the plain version.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.ops import image as image_ops  # noqa: E402
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402
from slam_loop_closing_tpu_torch.utils.synth_video import \
    render_cylinder_trajectory  # noqa: E402

KINDS = {0: ("fminf/fmaxf", 2 * 8), 1: ("fmaf", 2 * 8),
         2: ("mma.sync.m16n8k8.f32.tf32", 8)}
MMA_FLOPS = 2 * 16 * 8 * 8
THREADS = 256
FRAMES, H, W, POINTS = 8, 1080, 1920, 300   # chip_smoke.py's headline frames
THR = 20.0 / 255.0


def nvcc(src: Path, out: Path) -> ctypes.CDLL:
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
           str(cuda_build.CSRC), "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout + proc.stderr, file=sys.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}")
    return ctypes.CDLL(str(out))


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rates = nvcc(HERE / "rates.cu", cuda_build.BUILD_DIR / "probe_rates.so")
    rates.probe_rate.argtypes = (i, i, i, p, p)
    src, hits = re.subn(
        r"compass_pass\(p\[[^;]*\)", "true",
        (cuda_build.CSRC / "fast_score_nms_blur.cu").read_text())
    if hits != 1:
        raise RuntimeError(f"kernel A's pre-test call found {hits} times")
    no_pretest_src = cuda_build.BUILD_DIR / "probe_fast_no_pretest.cu"
    no_pretest_src.parent.mkdir(parents=True, exist_ok=True)
    no_pretest_src.write_text(src)
    plain_a = nvcc(no_pretest_src,
                   cuda_build.BUILD_DIR / "probe_fast_no_pretest.so")
    plain_a.slam_fast_score_nms_blur.argtypes = (
        p, p, p, ctypes.POINTER(f), i, i, i, f, p)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card}))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, (name, per_iter) in KINDS.items():
        for per_sm in (1, 2, 4):
            blocks, iters = sms * per_sm, 1 << 14
            sink = torch.empty(blocks * THREADS, device="cuda")
            ms = time_ms(lambda: cuda_build.check(rates.probe_rate(
                kind, blocks, iters, sink.data_ptr(), stream), "rate"), 5)
            count = blocks * THREADS * iters * per_iter   # thread operations
            rec = {"rate": name, "warps_per_sm": THREADS // 32 * per_sm,
                   "ms": ms}
            if kind == 2:
                mma = count / 32                           # warp-wide mma
                rec["T_flops_per_s"] = mma * MMA_FLOPS / ms / 1e9
                rec["mma_per_clk_per_sm_at_1980MHz"] = (
                    mma / sms / (ms * 1e-3 * 1.98e9))
            else:
                rec["T_ops_per_s"] = count / ms / 1e9
                rec["ops_per_clk_per_sm_at_1980MHz"] = (
                    count / sms / (ms * 1e-3 * 1.98e9))
            print(json.dumps(rec))

    # kernel A with and without the compass pre-test
    thetas = 2 * np.pi * np.arange(FRAMES) / 96
    orbit = (np.clip(render_cylinder_trajectory(thetas, np.zeros(FRAMES), H,
                                                W, POINTS, seed=0), 0.0, 1.0)
             * 255.0).astype(np.uint8)
    noise = np.random.default_rng(0).integers(0, 256, (FRAMES, H, W),
                                              dtype=np.uint8)
    taps = image_ops.gaussian_kernel1d(2.0, 3).tolist()
    taps_c = (f * len(taps))(*taps)

    def launcher(lib):
        def run(x):
            score, blur = torch.empty_like(x), torch.empty_like(x)
            cuda_build.check(lib.slam_fast_score_nms_blur(
                x.data_ptr(), score.data_ptr(), blur.data_ptr(), taps_c,
                *x.shape, THR, stream), "kernel A")
            return score, blur
        return run

    # both forms through the same direct call (no wrapper on the clock)
    with_pretest = launcher(cuda_build.load())
    no_pretest = launcher(plain_a)

    ok = True
    for texture, u8 in (("orbit", orbit), ("random", noise)):
        levels = image_ops.pyramid(image_ops.ship_frames(
            torch.from_numpy(u8).cuda(), "cuda"), 4, 1.2)
        for batch in (FRAMES, 1):
            tot = {"with pre-test": 0.0, "without": 0.0}
            for lv in levels:
                x = lv[:batch].contiguous()
                ref = ck.fast_score_nms_blur_plain(x, THR)
                for name, fn in (("with pre-test", lambda: with_pretest(x)),
                                 ("without", lambda: no_pretest(x))):
                    same = all(torch.equal(g, r) for g, r in zip(fn(), ref))
                    ok &= same
                    ms = time_ms(fn, 20)
                    tot[name] += ms
                    print(json.dumps({"kernel A": name, "texture": texture,
                                      "frames": batch,
                                      "level": list(x.shape[1:]), "ms": ms,
                                      "bitwise": same}))
                if batch == FRAMES:
                    need = ck.fast_compass_pass(x, THR)
                    runs = need[..., :x.shape[-1] // 32 * 32].reshape(
                        batch, x.shape[1], -1, 32).any(-1)
                    print(json.dumps({
                        "texture": texture, "level": list(x.shape[1:]),
                        "pixels_passing_pretest": float(need.float().mean()),
                        "runs_of_32_all_failing":
                            float(1.0 - runs.float().mean())}))
            print(json.dumps({"kernel A, 4 levels summed": texture,
                              "frames": batch, **tot}))
        del levels
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
