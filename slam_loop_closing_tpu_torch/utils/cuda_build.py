"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into ONE
shared library with a plain C interface, at first use, and :mod:`ctypes`
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    Writes to a temporary name and renames, so concurrent builders never
    load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, loaded once per
    process, with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fp = ctypes.POINTER(ctypes.c_float)
    signatures = {
        # img, score_tmp, score_out, blur_out, host taps[7], b, h, w,
        # threshold, stream
        "slam_fast_score_nms_blur": (p, p, p, p, fp, i, i, i, f, p),
        # img, xy, out, b, k, h, w, patch, center, stream
        "slam_extract_patches": (p, p, p, i, i, i, i, i, i, p),
        # packed, valid, qidx, tidx, out, p_cnt, n, block, scale, stream
        "slam_band_count_tiles": (p, p, p, p, p, i, i, i, f, p),
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
