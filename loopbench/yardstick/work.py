"""Operations and bytes that a traced call's layers need, from its shapes.

Counted from the inputs, never from a kernel's own work: what any
implementation of the same front-end or the same counts has to read, write
and compute.
"""

from __future__ import annotations

import numpy as np

from loopbench.yardstick import peaks

DESC_WORD_BYTES = 32     # a packed 256-bit descriptor
# bytes a keypoint slot of the front-end writes: packed words 32, signed
# +-1 row 256, (x, y) 8, response 4, angle 4, octave 4, validity 1
SLOT_BYTES = 32 + 256 + 8 + 4 + 4 + 4 + 1
# FAST-9 with its exact compass pre-test, the 3x3 NMS and the 7-tap blur,
# per pixel of every pyramid level (``chip_smoke.py``'s count of kernel A):
# 17 on the min/max pipe (8 compares, 9 maxima), 42 float32 (16 margins,
# 2 x 13 for the separable blur); the arc extrema of the pixels that pass
# the pre-test are left out (fewer operations: the bound stays a bound)
FAST_MINMAX_PER_PX, FAST_F32_PER_PX = 17, 42
GRID_MINMAX_PER_PX = 1   # the grid top-K's per-cell maximum
RESIZE_F32_PER_PX = 10   # a level pixel: 3 taps a pass, two passes
MOMENT_F32_PER_KP = 2 * 1024 + 2 * 1023   # (m10, m01): products and sums
BRIEF_F32_PER_KP = 256   # one compare a bit
BIT_PAIR_OPS = 2 * 256   # and + popcount-accumulate of 256 bit pairs


def level_sizes(h: int, w: int, levels: int, scale: float) -> list:
    """(h, w) of every pyramid level, as the port's pyramid sizes them."""
    out = [(h, w)]
    for lvl in range(1, levels):
        s = scale ** lvl
        out.append((max(8, int(round(h / s))), max(8, int(round(w / s)))))
    return out


def frontend_least_s(frames: int, h: int, w: int, orb: dict) -> float:
    """Least time of the ORB front-end on ``frames`` float32 frames."""
    sizes = level_sizes(h, w, orb["num_levels"], orb["scale_factor"])
    px = sum(a * b for a, b in sizes)
    resized = px - h * w
    k = orb["num_features"]
    nbytes = frames * (4 * h * w + k * SLOT_BYTES)
    ops = {"fmnmx": frames * px * (FAST_MINMAX_PER_PX + GRID_MINMAX_PER_PX),
           "ffma": frames * (px * FAST_F32_PER_PX
                             + resized * RESIZE_F32_PER_PX
                             + k * (MOMENT_F32_PER_KP + BRIEF_F32_PER_KP))}
    return peaks.least_seconds(nbytes, ops)


def pair_rows(nfeat: np.ndarray, gap: int) -> tuple:
    """(frame pairs, valid row pairs) of every pair ``j <= i - gap``."""
    nv = np.asarray(nfeat, dtype=np.float64)
    before = np.concatenate([[0.0], np.cumsum(nv)])   # before[i] = sum nv[:i]
    i = np.arange(len(nv))
    upto = np.clip(i - gap + 1, 0, None)               # j in [0, i - gap]
    return int(upto.sum()), float(np.sum(nv * before[upto]))


def counts_least_s(nfeat: np.ndarray, gap: int, slots: int) -> float:
    """Least time of the good-match counts of every pair ``j <= i - gap``:
    the b1 products of the valid row pairs, or the packed store and its
    validity read once and the counts written once."""
    pairs, rows = pair_rows(nfeat, gap)
    f = len(nfeat)
    nbytes = f * slots * (DESC_WORD_BYTES + 1) + 4 * pairs
    return peaks.least_seconds(nbytes, {"b1": BIT_PAIR_OPS * rows})
