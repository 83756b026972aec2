"""The port's binding of the native frame reader
(``slam_loop_closing_tpu_torch.utils.native``, ``native/frame_io.cpp``):
``tests/test_native.py``'s checks (PNG round trip against PIL, parallel
batch decode, BT.601 RGB, fused resize), the JAX package's decoder on the
same files, the PIL path when there is no library, a failed load that is
tried again at the next call, and a failed compile that is remembered for
its library path only.

The native checks skip on a machine without ``g++`` (or ``$CXX``) or
without ``png.h``, which are fixed for a machine; where both are present a
failed build fails the tests instead of skipping them.
"""

import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from slam_loop_closing_tpu_torch.utils import io as tio
from slam_loop_closing_tpu_torch.utils import native

HAVE_TOOLCHAIN = bool(
    shutil.which(os.environ.get("CXX", "g++"))
    and any(Path(d, "png.h").exists()
            for d in ("/usr/include", "/usr/local/include")))
needs_native = pytest.mark.skipif(not HAVE_TOOLCHAIN,
                                  reason="no g++ or no png.h on this machine")


@pytest.fixture
def lib():
    assert native.available(), "g++ and png.h are here, the build must work"
    return native


@pytest.fixture
def no_library(monkeypatch):
    """The library cannot be built (as on a machine without a compiler)."""
    def fail():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    assert not native.available()


@needs_native
def test_roundtrip_matches_pil(lib, tmp_path, rng):
    img = rng.random((37, 53)).astype(np.float32)
    p = tmp_path / "a.png"
    lib.write_png_gray_native(p, img)
    via_pil = np.asarray(Image.open(p).convert("L"), np.float32) / 255.0
    assert np.abs(via_pil - img).max() < 1 / 255.0 + 1e-6
    assert lib.png_shape(p) == (37, 53)


@needs_native
def test_batch_parallel_decode(lib, tmp_path, rng):
    imgs = [rng.random((24, 32)).astype(np.float32) for _ in range(8)]
    paths = []
    for i, im in enumerate(imgs):
        p = tmp_path / f"f{i}.png"
        lib.write_png_gray_native(p, im)
        paths.append(p)
    batch = lib.load_frames_gray_native(paths, num_threads=4)
    assert batch.shape == (8, 24, 32) and batch.dtype == np.float32
    for i in range(8):
        assert np.abs(batch[i] - imgs[i]).max() < 1 / 255.0 + 1e-6
    np.testing.assert_array_equal(batch,
                                  lib.load_frames_gray_native(paths))


@needs_native
def test_rgb_decode_bt601(lib, tmp_path, rng):
    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    p = tmp_path / "rgb.png"
    Image.fromarray(rgb).save(p)
    out = lib.load_frames_gray_native([p])
    expected = rgb @ np.array([0.299, 0.587, 0.114]) / 255.0
    assert np.abs(out[0] - expected).max() < 2 / 255.0


@needs_native
def test_fused_resize(lib, tmp_path):
    img = np.tile(np.linspace(0, 1, 64, dtype=np.float32), (64, 1))
    p = tmp_path / "g.png"
    lib.write_png_gray_native(p, img)
    out = lib.load_frames_gray_native([p], 32, 32)
    assert out.shape == (1, 32, 32)
    # horizontal gradient preserved
    assert out[0, 16, 0] < 0.1 and out[0, 16, -1] > 0.9


def jax_package_native(monkeypatch):
    """The JAX package's decoder, loaded. Its loader latches the first
    failure for the process, and that failure may be another test process
    still writing the shared library (ROADMAP F10): the latch is lifted for
    this test and the load tried again for up to a minute."""
    from slam_loop_closing_tpu.utils import native as jnative

    deadline = time.monotonic() + 60
    while True:
        monkeypatch.setattr(jnative, "_build_failed", False)
        if jnative.available() or time.monotonic() > deadline:
            return jnative
        time.sleep(0.5)


@needs_native
def test_equals_jax_package_decoder(lib, tmp_path, rng, monkeypatch):
    """The same source, built by each package: the same frames, bitwise,
    gray and RGB, as stored and resized."""
    jnative = jax_package_native(monkeypatch)

    paths = []
    for i in range(3):
        p = tmp_path / f"g{i}.png"
        Image.fromarray((rng.random((30, 40)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    p = tmp_path / "rgb.png"
    Image.fromarray((rng.random((30, 40, 3)) * 255).astype(np.uint8)).save(p)
    paths.append(p)
    assert jnative.available()
    np.testing.assert_array_equal(lib.load_frames_gray_native(paths),
                                  jnative.load_frames_gray_native(paths))
    assert lib.library_path() != Path(jnative._SO)


@needs_native
@pytest.mark.parametrize("resize_hw", [None, (15, 20)])
def test_io_reads_pngs_with_native(lib, tmp_path, rng, resize_hw):
    """``utils.io.load_frames_gray`` takes the native path for PNGs (the
    JAX package's choice) and equals PIL within 1/255 without a resize."""
    paths = []
    for i in range(4):
        p = tmp_path / f"frame_{i:04d}.png"
        Image.fromarray((rng.random((30, 40)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    got = tio.load_frames_gray(paths, frame_skip=2, resize_hw=resize_hw)
    h, w = resize_hw or (None, None)
    np.testing.assert_array_equal(
        got, lib.load_frames_gray_native(paths[::2], h, w))
    if resize_hw is None:
        pil = np.stack([tio.load_frame_gray(p) for p in paths[::2]])
        assert np.abs(got - pil).max() <= 1 / 255.0


def test_pil_path_without_library(no_library, tmp_path, rng):
    """Without the library every entry point reads and writes with PIL."""
    img = rng.random((21, 34)).astype(np.float32)
    p = tmp_path / "frame_0000.png"
    native.write_png_gray_native(p, img)
    assert native.png_shape(p) == (21, 34)
    got = native.load_frames_gray_native([p, p])
    assert got.shape == (2, 21, 34)
    np.testing.assert_array_equal(got[0], tio.load_frame_gray(p))
    np.testing.assert_array_equal(tio.load_frames_gray([p]), got[:1])
    assert native.load_frames_gray_native([p], 10, 17).shape == (1, 10, 17)
    assert native.load_frames_gray_native([]).shape == (0, 0, 0)


def test_failed_load_is_tried_again(monkeypatch, tmp_path):
    """No latch: a library that does not load (a half-written file) is
    loaded again at every call, and a library that loads later is taken."""
    half = tmp_path / "half_written.so"
    half.write_bytes(b"\x7fELF")
    calls = []
    real_build = native.build

    def build():
        calls.append(1)
        return half if len(calls) < 3 else real_build()

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", build)
    assert not native.available()
    assert not native.available()
    assert len(calls) == 2 and "half_written" in native.last_error
    assert native.available() is HAVE_TOOLCHAIN
    assert len(calls) == 3


def test_failed_compile_is_remembered_per_library(monkeypatch, tmp_path):
    """A compile that fails is not run again for the same library path (the
    same source, flags, compiler and machine), and is run for another."""
    compiles = []

    def failing_run(cmd, **kw):
        compiles.append(cmd)

        class Failed:
            returncode = 1
            stderr = "fatal error: png.h: No such file or directory"
        return Failed()

    target = [tmp_path / "native" / "lib_a.so"]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_compiler", lambda: "/bin/c++")
    monkeypatch.setattr(native, "library_path", lambda cxx=None: target[0])
    monkeypatch.setattr(native, "_failed_compiles", {})
    monkeypatch.setattr(native.subprocess, "run", failing_run)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="png.h"):
            native.build()
    assert len(compiles) == 1
    target[0] = tmp_path / "native" / "lib_b.so"    # a changed toolchain
    with pytest.raises(RuntimeError, match="png.h"):
        native.build()
    assert len(compiles) == 2


def test_build_goes_through_a_temporary_name(monkeypatch, tmp_path):
    """The compiler writes a temporary file that is renamed into place."""
    seen = {}

    def fake_run(cmd, **kw):
        out = Path(cmd[cmd.index("-o") + 1])
        seen["out"] = out
        out.write_bytes(b"so")

        class Done:
            returncode = 0
            stderr = ""
        return Done()

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_compiler", lambda: "/bin/c++")
    monkeypatch.setattr(native, "library_path",
                        lambda cxx=None: tmp_path / "native" / "lib_x.so")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    path = native.build()
    assert path.parent == tmp_path / "native" and path.read_bytes() == b"so"
    assert seen["out"] != path and not seen["out"].exists()
    assert native.build() == path           # built once, then reused
