"""Probe of kernel H's forms on the card (one SIFT octave: the Gaussian
chain and the gated DoG response), each checked bitwise against the plain
version in both modes and timed with CUDA events (``ms``) and under the
profiler (``device_ms``, split into the blur levels and the gates), at the
four octaves of a chunk of 8 x 1080p frames (blob texture, as the card
tests make it):

* the library's kernel (blur tiles of 128 x 16, gate tiles of 32 x 16)
  and variants of its source built beside it (the blur tiles' rows, the
  blocks an SM asked of the blur, the gates' tile), each called through
  the library's wrapper;
* the frame-group order: the octave's levels and gates run for a group of
  1, 2 or 4 frames before the next group starts (one call of the library
  per group), so that level l+1 may read level l from the 50 MB L2.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_gauss_forms.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if a form is not bitwise.
"""

from __future__ import annotations

import collections
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import chip_smoke  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.ops import image as image_ops  # noqa: E402
from slam_loop_closing_tpu_torch.ops import sift  # noqa: E402
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402

FRAMES, H, W, OCTAVES = 8, 1080, 1920, 4
GROUPS = (1, 2, 4)
REPS = 20
BLUR_BOUNDS = "__launch_bounds__(kBlurThreads)"
GATE_BOUNDS = "__launch_bounds__(kGateThreads)"
# source edits of csrc/gauss_stack_resp.cu, by form
VARIANTS = {
    "blur rows 8": (("kBlurRows = 16;", "kBlurRows = 8;"),),
    "blur rows 32": (("kBlurRows = 16;", "kBlurRows = 32;"),),
    "blur rows 64": (("kBlurRows = 16;", "kBlurRows = 64;"),),
    "blur 8 blocks an SM": ((BLUR_BOUNDS, BLUR_BOUNDS[:-1] + ", 8)"),),
    "gates 64x16": (("kGateW = 32;", "kGateW = 64;"),),
    "gates 64x8": (("kGateW = 32;", "kGateW = 64;"),
                   ("kGateH = 16;", "kGateH = 8;")),
    "gates 32x8": (("kGateH = 16;", "kGateH = 8;"),),
    "gates 32x32": (("kGateH = 16;", "kGateH = 32;"),),
    "gates 6 blocks an SM": ((GATE_BOUNDS, GATE_BOUNDS[:-1] + ", 6)"),),
}


def blob_frames(b: int, h: int, w: int, dev) -> torch.Tensor:
    """[b, h, w] float32 blob texture: coarse uniform noise (seeded)
    upsampled bilinearly."""
    rng = np.random.default_rng(h)
    coarse = torch.from_numpy(
        rng.random((b, h // 8 + 1, w // 8 + 1)).astype(np.float32)).to(dev)
    return image_ops.resize_bilinear(coarse, h, w).contiguous()


def build_variants() -> dict:
    """Each variant's kernel-H entry point, its source edited and built
    with the library's flags into the build directory, all at once."""
    src = (cuda_build.CSRC / "gauss_stack_resp.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        slug = name.replace(" ", "_")
        cu = cuda_build.BUILD_DIR / f"probe_gauss_{slug}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
               "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    lib_fn = cuda_build.load().slam_gauss_stack_resp
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(so)).slam_gauss_stack_resp
        fn.argtypes, fn.restype = lib_fn.argtypes, lib_fn.restype
        out[name] = fn
    return out


def split_device_ms(fn, reps: int) -> dict:
    """Device ms a call of ``fn`` under the profiler, by kernel H's
    kernels: the blur levels and the gates."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):      # the first session can miss kernels
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        key = ("blur" if "blur" in e.key else "gates" if "gates" in e.key
               else "other")
        out[key] += getattr(e, "self_device_time_total", 0.0) / 1e3 / reps
    return dict(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    cfg = sift.SiftConfig()
    s = cfg.scales_per_octave
    sig = sift._chain_sigmas(s, cfg.sigma0)
    args = (s, sift._contrast_threshold(cfg), cfg.edge_threshold)
    load = cuda_build.load
    entries = {"library": load().slam_gauss_stack_resp, **build_variants()}
    ok = True
    octaves = chip_smoke.sift_octaves(blob_frames(FRAMES, H, W, dev), OCTAVES)
    for o, x in enumerate(octaves):
        b, h, w = x.shape
        for emit in (True, False):
            ref = ck.gauss_stack_resp_plain(x, sig, *args, emit_resp=emit)

            def record(form: dict, fn) -> None:
                nonlocal ok
                got = fn()
                if isinstance(got, list):
                    got = (torch.cat([p[0] for p in got]),
                           torch.cat([p[1] for p in got]) if emit else None)
                same = bool(torch.equal(got[0], ref[0]) and (
                    not emit or torch.equal(got[1], ref[1])))
                ok &= same
                print(json.dumps(dict(
                    octave=o, shape=[b, h, w], emit_resp=emit, **form,
                    bitwise=same, ms=chip_smoke.cuda_ms(fn, REPS),
                    device_ms=split_device_ms(fn, REPS))), flush=True)

            for name, entry in entries.items():
                cuda_build.load = lambda entry=entry: types.SimpleNamespace(
                    slam_gauss_stack_resp=entry)
                record(dict(form=name), lambda: ck.gauss_stack_resp(
                    x, sig, *args, emit_resp=emit))
            cuda_build.load = load
            for g in GROUPS:
                record(dict(form="frame groups", group=g), lambda: [
                    ck.gauss_stack_resp(x[i:i + g], sig, *args,
                                        emit_resp=emit)
                    for i in range(0, b, g)])
            del ref
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
