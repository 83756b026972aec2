"""KITTI odometry dataset adapter (sequence 00 loop detection) — a numpy
copy of :mod:`slam_loop_closing_tpu.utils.kitti` (the tests hold the two
equal). The dataset is not bundled; everything here gates on the directory
existing and raises a clear error otherwise.

Expected layout (standard KITTI odometry):
  <root>/sequences/<seq>/image_0/%06d.png   grayscale left camera
  <root>/sequences/<seq>/calib.txt          P0 projection matrix
  <root>/poses/<seq>.txt                    ground-truth poses (optional)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def available(root: str | Path, seq: str = "00") -> bool:
    return (Path(root) / "sequences" / seq / "image_0").is_dir()


def frame_paths(root: str | Path, seq: str = "00") -> list[Path]:
    d = Path(root) / "sequences" / seq / "image_0"
    if not d.is_dir():
        raise FileNotFoundError(
            f"KITTI sequence not found at {d}; download the odometry "
            "grayscale set and point --kitti-root at it")
    return sorted(d.glob("*.png"))


def load_intrinsics(root: str | Path, seq: str = "00") -> np.ndarray:
    """K from the P0 line of calib.txt."""
    calib = Path(root) / "sequences" / seq / "calib.txt"
    for line in calib.read_text().splitlines():
        if line.startswith("P0:"):
            vals = np.fromstring(line[3:], sep=" ").reshape(3, 4)
            return vals[:, :3]
    raise ValueError(f"P0 not found in {calib}")


def load_gt_poses(root: str | Path, seq: str = "00") -> np.ndarray | None:
    """[N, 3, 4] cam-to-world ground-truth poses, or None if absent."""
    p = Path(root) / "poses" / f"{seq}.txt"
    if not p.exists():
        return None
    rows = np.loadtxt(str(p))
    return rows.reshape(-1, 3, 4)


_CODE_SHIFT = 1 << 21  # > any frame index; packs (i, j) into one int64


def _pair_codes(pairs) -> np.ndarray:
    arr = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
    return arr[:, 0] * _CODE_SHIFT + arr[:, 1]


def _dilated_codes(pairs, tol: int) -> np.ndarray:
    """Sorted unique codes of every (i+di, j+dj) within the tol window —
    the tolerance dilation done ONCE on the (small) set instead of once per
    query (the per-query form is O(|gt| x |pred|): hours at the 9.8M-pair
    KITTI band)."""
    arr = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
    offs = np.arange(-tol, tol + 1, dtype=np.int64)
    di, dj = np.meshgrid(offs, offs, indexing="ij")
    cand = (arr[:, None, None, :]
            + np.stack([di, dj], axis=-1)[None]).reshape(-1, 2)
    return np.unique(cand[:, 0] * _CODE_SHIFT + cand[:, 1])


def loop_recall(pred_pairs, gt_pairs, tol: int = 5) -> float:
    """Fraction of ground-truth loop pairs (i, j) for which some predicted
    pair (i', j') lies within ``tol`` frames on both indices. Place
    recognition credits a detection that fires a few frames early/late at
    the same revisit — the standard tolerance-windowed recall. Returns 0.0
    when there are no ground-truth pairs."""
    gt = np.asarray(list(gt_pairs), dtype=np.int64).reshape(-1, 2)
    if gt.size == 0:
        return 0.0
    pred = np.asarray(list(pred_pairs), dtype=np.int64).reshape(-1, 2)
    if pred.size == 0:
        return 0.0
    # a gt pair hits iff any cell of ITS tol-window is a predicted pair:
    # [|gt|, (2tol+1)^2] window codes against the sorted pred codes —
    # O((|gt| * tol^2 + |pred|) log |pred|) instead of O(|gt| * |pred|)
    offs = np.arange(-tol, tol + 1, dtype=np.int64)
    di, dj = np.meshgrid(offs, offs, indexing="ij")
    win = (gt[:, None, None, 0] + di[None]) * _CODE_SHIFT \
        + (gt[:, None, None, 1] + dj[None])
    hit = np.isin(win.reshape(len(gt), -1), _pair_codes(pred)).any(axis=1)
    return float(hit.sum()) / len(gt)


def loop_precision(pred_pairs, gt_pairs, tol: int = 5) -> float:
    """Fraction of predicted loop pairs lying within ``tol`` frames (both
    indices) of some ground-truth pair — the complement of
    :func:`loop_recall`. Returns 0.0 when there are no predictions."""
    pred = np.asarray(list(pred_pairs), dtype=np.int64).reshape(-1, 2)
    if pred.size == 0:
        return 0.0
    gt = np.asarray(list(gt_pairs), dtype=np.int64).reshape(-1, 2)
    if gt.size == 0:
        return 0.0
    hit = np.isin(_pair_codes(pred), _dilated_codes(gt, tol))
    return float(hit.sum()) / len(pred)


def gt_loop_pairs(poses: np.ndarray, dist_thresh: float = 10.0,
                  min_gap: int = 100) -> list[tuple[int, int]]:
    """Ground-truth loop closures: frame pairs whose camera centers are
    within ``dist_thresh`` meters with index gap >= ``min_gap`` (the standard
    place-recognition ground truth for seq 00)."""
    C = poses[:, :, 3]
    out = []
    for i in range(len(C)):
        d = np.linalg.norm(C[: max(i - min_gap + 1, 0)] - C[i], axis=1)
        for j in np.flatnonzero(d < dist_thresh):
            out.append((i, int(j)))
    return out
