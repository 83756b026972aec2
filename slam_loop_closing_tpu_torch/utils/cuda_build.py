"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
compiler process per source, all started together, and links the objects
into ONE shared library with a plain C interface, at first use; :mod:`ctypes`
loads it. The library lands in ``build/torch_kernels/`` at the repository
root, named by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused; the compiler's output (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside it as a
``.log``. Nothing here runs at import time.

Every C entry point takes its pointers and the CUDA stream as ``void *``
and returns ``cudaGetLastError()`` after its launches; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH; raises if there is none."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                 / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Every source compiles in its own ``nvcc`` process, in parallel; the
    link writes to a temporary name and renames, so concurrent builders
    never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                   str(Path(tmpdir) / f"{src.stem}.o"), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text[-4000:]}")
        tmp = Path(tmpdir) / "lib.so"
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                   *(c[c.index("-o") + 1] for c, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
        out.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, loaded once per
    process, with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    signatures = {
        # img, score_out, blur_out, host taps[7], b, h, w, threshold, stream
        "slam_fast_score_nms_blur": (p, p, p, fp, i, i, i, f, p),
        # img, xy, out, b, k, h, w, patch, center, stream
        "slam_extract_patches": (p, p, p, i, i, i, i, i, i, p),
        # packed, valid, qidx, tidx, out, p_cnt, n, block, scale, stream
        "slam_band_count_tiles": (p, p, p, p, p, i, i, i, f, p),
        # packed, valid, qidx, tidx, out, p_cnt, n, scale, stream
        "slam_pair_counts": (p, p, p, p, p, i, i, f, p),
        # q, t, valid_q, valid_t, d1, idx, partial, tickets, m, n, splits,
        # stream
        "slam_hamming_nn": (p, p, p, p, p, p, p, p, i, i, i, p),
        # q, t, valid_q, valid_t, qidx, tidx, d1, idx, d2, partial, tickets,
        # p_cnt, n_q, n_t, splits, stream
        "slam_hamming_knn2": (p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p),
        # q, t, valid_t, qidx, tidx, d1, partial, p_cnt, n_q, n_t, splits,
        # stream
        "slam_hamming_d1": (p, p, p, p, p, p, p, i, i, i, i, p),
        # q [>= 64, 8], t [>= 64, 8], out [64, 64], stream
        "slam_hamming_tile_product": (p, p, p, p),
        # xy_q [batch, n, 2], xy_t, mask, out, batch, n, splits, radius^2,
        # tau^2, stream
        "slam_motion_support": (p, p, p, p, i, i, i, f, f, p),
        # q, t, valid_q, valid_t, qidx, tidx, d1, idx, d2, partial, tickets,
        # p_cnt, n_q, n_t, splits, stream
        "slam_l2_knn2": (p, p, p, p, p, p, p, p, p, p, i, i, i, i, p),
        # x, x is bf16, out bf16, out f32, row starts, row weights, row taps,
        # column starts, column weights, column taps, b, h, w, oh, ow,
        # rows first, row span, column span, stream
        "slam_pyramid_level": (p, i, p, p, p, p, i, p, p, i, i, i, i, i, i, i,
                               i, i, p),
        # x, out, then as slam_pyramid_level from the row starts
        "slam_resize_f32": (p, p, p, p, i, p, p, i, i, i, i, i, i, i, i, i,
                            p),
        # patches [k, 32, 32], valid [k], weights [1024, 2], angle [k], k,
        # stream
        "slam_orient_moments": (p, p, p, p, i, p),
        # the launch's arguments packed as int64 (see csrc/segment_sum.cu),
        # stream
        "slam_segment_sum": (ctypes.c_char_p, p),
        # img, gauss, resp, host taps [levels, 19], host radii [levels],
        # levels, b, h, w, s (0: gauss only), thr, edge_r, (edge_r + 1)^2,
        # border, stream
        "slam_gauss_stack_resp": (p, p, p, fp, ip, i, i, i, i, i, f, f, f, i,
                                  p),
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")
