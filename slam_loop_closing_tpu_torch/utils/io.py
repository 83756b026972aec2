"""Report writers — numpy copies of
:func:`slam_loop_closing_tpu.utils.io.format_loop_closures`,
:func:`~slam_loop_closing_tpu.utils.io.write_loop_closures_txt`,
:func:`~slam_loop_closing_tpu.utils.io.write_obj` and
:func:`~slam_loop_closing_tpu.utils.io.reconstruction_obj_path` (the tests
hold the outputs equal)."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable

import numpy as np


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
