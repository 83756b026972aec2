"""Probe of kernel J's forms on the card (one banded resize a launch), each
checked bitwise against the plain version and timed with CUDA events
(``ms``, the mean of a call) and under the profiler (``device_ms``), on 8
frames of block texture at 1080p (the card tests' frames):

* the ORB pyramid's three levels at scale 1.2 (1080p -> 900x1600 ->
  750x1333 -> 625x1111, the first from the float32 frames), summed: the
  library's kernel (32 x 64 output tiles, the input footprint staged in
  shared memory, the tap counts compiled in), variants of its source
  built beside it (other tiles, other staging depths, the tap counts left
  to the generic instance), and the form it replaced
  (``pyramid_level_direct.cu``: 16 x 64 tiles, the first pass read
  straight from device memory);
* the SIFT octave halvings of the float32 mode (1080p -> 540x960 ->
  270x480 -> 135x240), each: the library's kernel (16 x 64 tiles) and
  its tile variants.

Each variant is the library's source with constants edited, built into
``build/torch_kernels/probe_pyramid_*.so`` and called through the
library's wrapper (``cuda_build.load`` swapped, the wrapper's tile constant
set to the variant's). Also prints the byte bound of each form's work.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_pyramid_forms.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if a form is not bitwise.
"""

from __future__ import annotations

import contextlib
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
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402

FRAMES, H, W = 8, 1080, 1920
REPS = 20
LEVEL_TILE = "kLevelTileH = 32, kLevelTileW = 64;"
HALF_TILE = "kHalfTileH = 16, kHalfTileW = 64;"


def level_tile(th: int, tw: int) -> tuple:
    return (((LEVEL_TILE, f"kLevelTileH = {th}, kLevelTileW = {tw};"),),
            (th, tw), None)


def half_tile(th: int, tw: int) -> tuple:
    return (((HALF_TILE, f"kHalfTileH = {th}, kHalfTileW = {tw};"),),
            None, (th, tw))


# source edits of csrc/pyramid_level.cu by form, with the wrapper's tiles
# (bfloat16 mode, float32 mode) that go with them
VARIANTS = {
    "level 32x128": level_tile(32, 128),
    "level 16x64": level_tile(16, 64),
    "level 64x64": level_tile(64, 64),
    "level 32x32": level_tile(32, 32),
    "level 16x128": level_tile(16, 128),
    "staging 1 row": ((("kRowsInFlight = 2;", "kRowsInFlight = 1;"),),
                      None, None),
    "generic taps": ((("return tr == fixed && tc == fixed ? fixed : 0;",
                       "return 0;"),), None, None),
    "half 16x128": half_tile(16, 128),
    "half 8x64": half_tile(8, 64),
    "half 32x64": half_tile(32, 64),
    "half 16x32": half_tile(16, 32),
}


def _nvcc(src: Path, so: Path) -> subprocess.Popen:
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
           str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_variants() -> tuple[dict, ctypes.CDLL]:
    """Each variant's library (its source edited and built with the
    library's flags into the build directory) and the direct form's, all
    compiled at once."""
    src = (cuda_build.CSRC / "pyramid_level.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (edits, _, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = cuda_build.BUILD_DIR / f"probe_pyramid_{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        jobs[name] = (cu.with_suffix(".so"), _nvcc(cu, cu.with_suffix(".so")))
    direct = cuda_build.BUILD_DIR / "probe_pyramid_direct.so"
    jobs["direct"] = (direct, _nvcc(HERE / "pyramid_level_direct.cu", direct))
    lib = cuda_build.load()
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        cdll = ctypes.CDLL(str(so))
        if name == "direct":
            fn = cdll.slam_pyramid_level_direct
            # the library's arguments with one span in place of two
            fn.argtypes = tuple(lib.slam_pyramid_level.argtypes[:-2]) + (
                ctypes.c_void_p,)
            fn.restype = ctypes.c_int
            out[name] = fn
            continue
        ns = types.SimpleNamespace()
        for entry in ("slam_pyramid_level", "slam_resize_f32"):
            fn, ref = getattr(cdll, entry), getattr(lib, entry)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
            setattr(ns, entry, fn)
        out[name] = ns
    return out, lib


@contextlib.contextmanager
def using(ns, level_tile=None, half_tile=None):
    """The wrapper runs ``ns``'s entry points with the given tiles."""
    load, lt, ht = cuda_build.load, ck._PYR_LEVEL_TILE, ck._PYR_HALF_TILE
    cuda_build.load = lambda: ns
    ck._PYR_LEVEL_TILE = level_tile or lt
    ck._PYR_HALF_TILE = half_tile or ht
    try:
        yield
    finally:
        cuda_build.load, ck._PYR_LEVEL_TILE, ck._PYR_HALF_TILE = load, lt, ht


def direct_level(fn, x: torch.Tensor, nh: int, nw: int):
    """One level through the direct form (its own span rule: 16 x 64
    tiles, the first pass's axis only)."""
    b, h, w = x.shape
    rs, rw = image_ops.device_taps(h, nh, x.device)
    cs, cw = image_ops.device_taps(w, nw, x.device)
    rows_first = not h > w
    span = (ck._pyramid_span(w, nw, 64, torch.bfloat16) if rows_first
            else ck._pyramid_span(h, nh, 16, torch.bfloat16))
    out_b = torch.empty((b, nh, nw), dtype=torch.bfloat16, device=x.device)
    out_f = torch.empty((b, nh, nw), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out_b.data_ptr(),
             out_f.data_ptr(), rs.data_ptr(), rw.data_ptr(), rw.shape[1],
             cs.data_ptr(), cw.data_ptr(), cw.shape[1], b, h, w, nh, nw,
             int(rows_first), span,
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "pyramid_level_direct")
    return out_b, out_f


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
    variants, lib = build_variants()
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (FRAMES, H // 16 + 1, W // 16 + 1))
    u8 = np.clip(np.repeat(np.repeat(base, 16, 1), 16, 2)[:, :H, :W]
                 + rng.integers(-8, 9, (FRAMES, H, W)), 0, 255)
    frames = image_ops.ship_frames(u8.astype(np.uint8), dev)
    ok = True

    # the ORB levels: inputs and references of the three launches
    levels, x = [], frames
    for lvl in range(1, 4):
        nh, nw = round(H / 1.2 ** lvl), round(W / 1.2 ** lvl)
        ref = ck.pyramid_level_plain(x, nh, nw)
        levels.append((x, nh, nw, ref))
        x = ref[0]
    nbytes = sum(x.numel() * x.element_size() + r[0].numel() * 6
                 for x, _, _, r in levels)
    print(json.dumps(dict(work="ORB levels", shape=[FRAMES, H, W],
                          bound_ms=nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)),
          flush=True)

    def level_record(form: str, call) -> None:
        nonlocal ok
        same = all(all(torch.equal(g, r) for g, r in zip(call(x, nh, nw), ref))
                   for x, nh, nw, ref in levels)
        ok &= same

        def run():
            for x, nh, nw, _ in levels:
                call(x, nh, nw)

        print(json.dumps(dict(work="ORB levels", form=form, bitwise=same,
                              ms=chip_smoke.cuda_ms(run, REPS),
                              device_ms=chip_smoke.device_ms(run, REPS))),
              flush=True)

    level_record("library", ck.pyramid_level)
    for lvl, (x, nh, nw, ref) in enumerate(levels, 1):
        print(json.dumps(dict(
            work="ORB level", level=lvl, shape=list(x.shape), form="library",
            ms=chip_smoke.cuda_ms(lambda: ck.pyramid_level(x, nh, nw), REPS),
            bound_ms=(x.numel() * x.element_size() + ref[0].numel() * 6)
            / chip_smoke.HBM_BYTES_PER_S * 1e3)), flush=True)
    level_record("direct", lambda x, nh, nw: direct_level(
        variants["direct"], x, nh, nw))
    for name, (_, lt, ht) in VARIANTS.items():
        if ht is None:
            with using(variants[name], lt, ht):
                level_record(name, ck.pyramid_level)

    # the SIFT halvings of the float32 mode, each on its own
    x = frames
    for octave in range(3):
        nh, nw = x.shape[1] // 2, x.shape[2] // 2
        ref = ck.resize_f32_plain(x, nh, nw)
        bound = (x.numel() + ref.numel()) * 4 / chip_smoke.HBM_BYTES_PER_S
        forms = [("library", None)] + [(n, v) for n, v in VARIANTS.items()
                                       if v[1] is None]
        for name, spec in forms:
            ctx = (contextlib.nullcontext() if spec is None
                   else using(variants[name], spec[1], spec[2]))
            with ctx:
                same = bool(torch.equal(ck.resize_f32(x, nh, nw), ref))
                ok &= same
                print(json.dumps(dict(
                    work="SIFT halving", octave=octave,
                    shape=list(x.shape), form=name, bitwise=same,
                    ms=chip_smoke.cuda_ms(lambda: ck.resize_f32(x, nh, nw),
                                          REPS),
                    device_ms=chip_smoke.device_ms(
                        lambda: ck.resize_f32(x, nh, nw), REPS),
                    bound_ms=bound * 1e3)), flush=True)
        x = ref
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
