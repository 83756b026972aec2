"""ctypes binding of the native frame reader (``native/frame_io.cpp``):
libpng decode of a whole frame list into one contiguous [N, H, W] float32
batch by a pool of threads, BT.601 grayscale and an optional bilinear resize
fused into the decode — the native counterpart of the reference's OpenCV
imgcodecs layer (main.cpp:1141 ``cv::imread``; extract_images_from_mov.cpp
``cv::imwrite``).

Port of :mod:`slam_loop_closing_tpu.utils.native`, with its own build: ``g++``
(``$CXX`` if set) compiles the unchanged source at first use into
``build/native/libframe_io_<hash>.so`` at the repository root, named by a
hash of the source, the flags, the compiler's version and the machine type,
writing to a temporary name and renaming (concurrent builds never load a
half-written file). A load that fails is tried again at the next call (no
failure latch). A compile that fails is remembered for its library path
only: the same source, flags, compiler and machine fail the same way, so it
is not run again in this process, while a changed toolchain gets a fresh
try. :data:`last_error` keeps the message.

Where no compiler or libpng is present every entry point reads and writes
with PIL instead: a host decoder, the JAX package's documented behaviour
without the native library. :func:`..utils.io.load_frames_gray` takes the
native path whenever :func:`available`, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "frame_io.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")

_lib: ctypes.CDLL | None = None
last_error: str | None = None   # why the last build or load failed
_failed_compiles: dict[Path, str] = {}   # library path -> compiler's error


def _compiler() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on the PATH")
    return cxx


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True,
                          text=True).stdout.split("\n")[0]


def library_path(cxx: str | None = None) -> Path:
    """The library's path for this source, these flags, the compiler
    ``cxx`` (found on the PATH if None) and this machine type."""
    cxx = cxx or _compiler()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(f"{_compiler_version(cxx)} {platform.machine()}".encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libframe_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/frame_io.cpp`` unless its library exists; raises
    if there is no compiler or the compile fails (now or earlier in this
    process, for this library path)."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    if out in _failed_compiles:
        raise RuntimeError(_failed_compiles[out])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / "lib.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                               *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            _failed_compiles[out] = (f"{cxx} failed ({proc.returncode}):\n"
                                     f"{proc.stderr[-4000:]}")
            raise RuntimeError(_failed_compiles[out])
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    """The native library, built if needed; None if it cannot be built or
    loaded now (the next call tries the load again)."""
    global _lib, last_error
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        last_error = str(e)
        return None
    cp, ip = ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)
    fp, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.frameio_png_shape.argtypes = [cp, ip, ip]
    lib.frameio_load_gray.argtypes = [cp, fp, i, i]
    lib.frameio_load_batch_gray.argtypes = [ctypes.POINTER(cp), i, fp, i, i,
                                            i]
    lib.frameio_write_gray.argtypes = [cp, fp, i, i]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def png_shape(path: str | Path) -> tuple[int, int]:
    """(height, width) of a PNG."""
    lib = _load()
    if lib is None:
        from PIL import Image

        with Image.open(str(path)) as img:
            w, h = img.size
        return h, w
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.frameio_png_shape(str(path).encode(), ctypes.byref(h),
                               ctypes.byref(w))
    if rc != 0:
        raise IOError(f"failed to read PNG {path} (rc={rc})")
    return h.value, w.value


def load_frames_gray_native(paths, h: int | None = None, w: int | None = None,
                            num_threads: int | None = None) -> np.ndarray:
    """Decode PNG frames in parallel into one [N, h, w] float32 array in
    [0, 1] (BT.601 grayscale; a bilinear resize fused in when h, w differ
    from the source's; the first frame's size if not given). With no
    native library each frame is read with PIL."""
    paths = [str(p) for p in paths]
    if not paths:
        return np.zeros((0, 0, 0), np.float32)
    if h is None or w is None:
        h, w = png_shape(paths[0])
    lib = _load()
    if lib is None:
        from slam_loop_closing_tpu_torch.utils import io as io_utils

        return np.stack([io_utils.load_frame_gray(p, (h, w)) for p in paths])
    out = np.empty((len(paths), h, w), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    if num_threads is None:
        num_threads = min(len(paths), os.cpu_count() or 1)
    failures = lib.frameio_load_batch_gray(
        arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, num_threads)
    if failures:
        raise IOError(f"{failures} frames failed to decode")
    return out


def write_png_gray_native(path: str | Path, img: np.ndarray) -> None:
    """Write a [H, W] float image in [0, 1] as an 8-bit grayscale PNG."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    if lib is None:
        from PIL import Image

        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            str(path))
        return
    rc = lib.frameio_write_gray(
        str(path).encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[0], img.shape[1])
    if rc != 0:
        raise IOError(f"failed to write PNG {path} (rc={rc})")
