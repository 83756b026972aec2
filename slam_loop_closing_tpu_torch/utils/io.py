"""Host-side IO: video frame extraction, frame loading, OBJ / loop-closure /
visualization writers — numpy copies of the functions of
:mod:`slam_loop_closing_tpu.utils.io` (the tests hold the outputs equal):

* :func:`extract_images` with the reference's skip-if-exists cache
  (main.cpp:90-116) and ``frame_%04d.png`` naming; :func:`enumerate_frames`
  probes frame_0000.png, ... (main.cpp:1059-1067);
* :func:`load_frame_gray`, :func:`load_frames_gray`: frames as float32 in
  [0, 1], read with PIL (the JAX package's optional native parallel PNG
  decoder is not part of the port);
* :func:`write_obj`, :func:`reconstruction_obj_path`: ``saveAsOBJ``
  (main.cpp:959-1036);
* :func:`format_loop_closures`, :func:`write_loop_closures_txt`,
  :func:`save_match_visualization`: ``loop_closures.txt`` and the match
  PNGs (README.md:140-166).

Video decode is pluggable: imageio if it can open the container, else OpenCV
(as a host decoder only). imageio, OpenCV and PIL are imported inside the
functions that need them. Everything outputs plain numpy; the pipeline
entry points move it to the device.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# video -> frames
# ---------------------------------------------------------------------------

def _iter_video_frames(video_path: str):
    """Yield RGB uint8 frames from a video file using the first available
    host decoder (imageio, then OpenCV)."""
    try:
        import imageio.v3 as iio
        for frame in iio.imiter(video_path):
            yield np.asarray(frame)
        return
    except Exception:
        pass
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            f"No host video decoder available for {video_path}; "
            "pre-extract frames as frame_%04d.png instead.") from e
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"Could not open video: {video_path}")
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame[..., ::-1]  # BGR -> RGB
    cap.release()


def _video_metadata(video_path: str) -> tuple[float, int]:
    """(fps, total_frames) of a video, best effort — the reference prints
    both before extracting (extract_images_from_mov.cpp:31-34). Returns
    (0.0, 0) when no decoder can report them."""
    try:
        import imageio.v3 as iio
        meta = iio.immeta(video_path)
        fps = float(meta.get("fps", 0.0))
        dur = float(meta.get("duration", 0.0) or 0.0)
        n = int(meta.get("nframes", 0) or 0)
        if n <= 0 and fps > 0 and dur > 0:
            n = int(round(fps * dur))
        if fps > 0 or n > 0:
            return fps, n
    except Exception:
        pass
    try:
        import cv2
        cap = cv2.VideoCapture(video_path)
        if cap.isOpened():
            fps = float(cap.get(cv2.CAP_PROP_FPS))
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            return fps, n
    except Exception:
        pass
    return 0.0, 0


def _write_png(path: Path, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(str(path))


def extract_images(video_path: str, data_dir: str = "data",
                   log=print) -> Path:
    """Extract every frame of ``video_path`` to
    ``<data_dir>/extracted_frames/<video_stem>/frame_%04d.png``.

    Skips extraction entirely if the output directory already exists — the
    reference's cache semantics (main.cpp:97-100, "Skipping"). Progress is
    logged every 100 frames (extract_images_from_mov.cpp:52-54).
    """
    video = Path(video_path)
    out_dir = Path(data_dir) / "extracted_frames" / video.stem
    if out_dir.exists():
        log(f"Output directory {out_dir} already exists. "
            "Skipping image extraction.")
        return out_dir
    out_dir.mkdir(parents=True)
    # the reference prints the open confirmation and FPS / frame count
    # before the extraction loop (extract_images_from_mov.cpp:31-34)
    fps, total = _video_metadata(str(video))
    log(f"Video opened successfully: {video}")
    log(f"FPS: {fps:g}, Total Frames: {total}")
    count = 0
    for frame in _iter_video_frames(str(video)):
        _write_png(out_dir / f"frame_{count:04d}.png", frame)
        if count % 100 == 0:
            # progress print BEFORE the increment, so frame 0 logs too
            # (extract_images_from_mov.cpp:52-54)
            log(f"Extracted frame {count} / {total}")
        count += 1
    log(f"Finished extraction. Total frames saved: {count} to {out_dir}")
    return out_dir


def enumerate_frames(frames_dir: str) -> list[Path]:
    """Probe frame_0000.png, frame_0001.png, ... until the first missing file
    (the reference's enumeration, main.cpp:1059-1067)."""
    frames = []
    i = 0
    d = Path(frames_dir)
    while True:
        p = d / f"frame_{i:04d}.png"
        if not p.exists():
            break
        frames.append(p)
        i += 1
    return frames


def load_frame_gray(path: str | Path, resize_hw: tuple[int, int] | None = None
                    ) -> np.ndarray:
    """Load one frame as grayscale float32 [H, W] in [0, 1] (BT.601 weights,
    like cv::imread(IMREAD_GRAYSCALE))."""
    from PIL import Image

    img = Image.open(str(path)).convert("L")
    if resize_hw is not None:
        img = img.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def load_frames_gray(paths: Sequence[str | Path], frame_skip: int = 1,
                     resize_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Stack every ``frame_skip``-th frame into [B, H, W] float32 (the
    README's frame_skip=3 stride, README.md:110), each read with PIL."""
    sel = list(paths)[::frame_skip]
    return np.stack([load_frame_gray(p, resize_hw) for p in sel])


# ---------------------------------------------------------------------------
# OBJ export
# ---------------------------------------------------------------------------

def write_obj(path: str | Path, points: np.ndarray,
              cam_rotations: np.ndarray, cam_translations: np.ndarray,
              point_valid: np.ndarray | None = None,
              cam_valid: np.ndarray | None = None,
              axis_length: float = 0.1, log=print) -> Path:
    """Wavefront OBJ export (reference ``saveAsOBJ`` main.cpp:959-1036):
    point-cloud vertices, then camera centers ``C = -R^T t``, then 3 axis
    endpoint vertices per camera (length 0.1); header comments carry the
    counts. Invalid (masked-out) entries are dropped, as the reference's
    compaction does."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, np.float64)
    if point_valid is not None:
        points = points[np.asarray(point_valid, bool)]
    R = np.asarray(cam_rotations, np.float64)
    t = np.asarray(cam_translations, np.float64)
    if cam_valid is not None:
        keep = np.asarray(cam_valid, bool)
        R, t = R[keep], t[keep]
    # empty-pose guard (main.cpp:1010-1013 warns and skips)
    ok = np.linalg.norm(R, axis=(1, 2)) > 1e-9
    if not np.all(ok):
        log(f"Warning: skipping {int((~ok).sum())} empty poses in OBJ export")
    R, t = R[ok], t[ok]
    centers = -np.einsum("nji,nj->ni", R, t)  # -R^T t
    with open(p, "w") as f:
        f.write("# Reconstruction point cloud\n")
        f.write(f"# {len(points)} map points\n")
        f.write(f"# {len(centers)} cameras "
                "(center + 3 axis endpoints each)\n")
        for X in points:
            f.write(f"v {X[0]:.6f} {X[1]:.6f} {X[2]:.6f}\n")
        for Rn, Cn in zip(R, centers):
            f.write(f"v {Cn[0]:.6f} {Cn[1]:.6f} {Cn[2]:.6f}\n")
            for axis in range(3):
                # camera axis k in world coordinates = row k of R
                e = Cn + axis_length * Rn[axis, :]
                f.write(f"v {e[0]:.6f} {e[1]:.6f} {e[2]:.6f}\n")
    log(f"Saved OBJ: {p} ({len(points)} points, {len(centers)} cameras)")
    return p


def reconstruction_obj_path(data_dir: str = "data") -> Path:
    """Timestamped output path of the reference
    (``data/reconstruction/reconstructionBundle_<ns>.obj``,
    main.cpp:1674-1676)."""
    ts = time.time_ns()
    return Path(data_dir) / "reconstruction" / f"reconstructionBundle_{ts}.obj"


# ---------------------------------------------------------------------------
# loop-closure outputs (Version A)
# ---------------------------------------------------------------------------

def format_loop_closures(loops: Iterable[dict],
                         total_frames: int | None = None) -> str:
    """Render the loop-closure report byte-identical to the reference's
    example output (README.md:150-166): the ``=== Processing Complete ===``
    header with totals, then a ``Loop Closures Detected:`` section with one
    ``Frame X <-> Frame Y`` block per loop. Similarity uses C++ default
    ostream formatting (6 significant digits, trailing zeros trimmed), i.e.
    Python ``%g``.

    Each loop dict: {current, matched, num_matches, similarity}."""
    loops = list(loops)
    out = ["=== Processing Complete ==="]
    if total_frames is not None:
        out.append(f"Total frames processed: {total_frames}")
    out.append(f"Loop closures detected: {len(loops)}")
    out.append("")
    out.append("Loop Closures Detected:")
    out.append("======================")
    out.append("")
    for lp in loops:
        out.append(f"Frame {lp['current']} <-> Frame {lp['matched']}")
        out.append(f"  Matches: {lp['num_matches']}")
        out.append(f"  Similarity: {lp['similarity']:g}")
        out.append("")
    return "\n".join(out)


def write_loop_closures_txt(path: str | Path, loops: Iterable[dict],
                            total_frames: int | None = None) -> Path:
    """``loop_closures.txt`` in the README's exact format — see
    :func:`format_loop_closures`."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(format_loop_closures(loops, total_frames))
    return p


def save_match_visualization(path: str | Path, img1: np.ndarray,
                             img2: np.ndarray, xy1: np.ndarray,
                             xy2: np.ndarray, match_mask: np.ndarray,
                             match_idx: np.ndarray,
                             max_lines: int = 200) -> Path:
    """Side-by-side match drawing (``visualizeMatches``, loop_closing.hpp:56;
    README.md:144-146 ``matches_X_Y.png`` / ``loop_X_Y.png``). Host-side PIL."""
    from PIL import Image, ImageDraw

    def to_u8(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        return im

    a, b = to_u8(img1), to_u8(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1]), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    img = Image.fromarray(canvas).convert("RGB")
    draw = ImageDraw.Draw(img)
    ox = a.shape[1]
    rows = np.flatnonzero(np.asarray(match_mask, bool))[:max_lines]
    for q in rows:
        t = int(match_idx[q])
        x1, y1 = float(xy1[q, 0]), float(xy1[q, 1])
        x2, y2 = float(xy2[t, 0]) + ox, float(xy2[t, 1])
        draw.line([(x1, y1), (x2, y2)], fill=(0, 255, 0), width=1)
        draw.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=(255, 0, 0))
        draw.ellipse([x2 - 2, y2 - 2, x2 + 2, y2 + 2], outline=(255, 0, 0))
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    img.save(str(p))
    return p
