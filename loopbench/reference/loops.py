"""Plain good-match counts, similarity and loop rule: the reference for the
matching layer and the loop set.

The rule of the reference implementation (README.md:116-126 of
F-Fer/SLAM-Loop-Closing): each valid query descriptor's nearest valid
target at Hamming distance ``d1``; a match is good when
``d1 < max(2 * min d1, 30)``; a frame pair ``(i, j)``, ``j <= i - gap``, is
a loop when ``count / min(n_i, n_j) > threshold`` and ``count >=
min_matches``.

Distances come from products of +-1 vectors, ``d = (256 - q . t) / 2``,
one query frame against a block of target frames at a time. Every partial
sum of such a product is an integer of at most 256 in magnitude, which
float32 and bfloat16 both hold exactly, so the products run in bfloat16 by
default (the tensor cores' rate) with no rounding anywhere; the nearest
target is the largest product.
"""

from __future__ import annotations

import numpy as np
import torch

from loopbench.reference.orb import BITS, unpack_signed

MASKED = -2 * BITS   # the product of an invalid target row: never nearest


def band_counts(packed: torch.Tensor, valid: torch.Tensor, gap: int,
                scale: float = 2.0, targets_per_pass: int = 64,
                dtype=torch.bfloat16) -> np.ndarray:
    """[F, F] int32 good-match counts of every pair ``j <= i - gap`` of the
    store ``packed`` [F, N, 8] int32 with validity ``valid`` [F, N] (other
    entries 0); the +-1 products in ``dtype``."""
    f, n = valid.shape
    signed = unpack_signed(packed).to(dtype)
    out = np.zeros((f, f), np.int32)
    for i in range(gap, f):
        q = signed[i]
        last = i - gap + 1
        for s in range(0, last, targets_per_pass):
            e = min(last, s + targets_per_pass)
            dots = q @ signed[s:e].reshape(-1, BITS).T          # [N, T*N]
            vt = valid[s:e].reshape(-1)
            if not bool(vt.all()):
                dots = dots.masked_fill(~vt[None, :], MASKED)
            best = torch.amax(dots.reshape(n, e - s, n), dim=2)
            d1 = (BITS - best.to(torch.float32)) * 0.5            # [N, T]
            row_ok = valid[i][:, None] & (d1 < BITS + 1)
            dmin = torch.amin(torch.where(row_ok, d1, 512.0), dim=0)
            thr = torch.clamp_min(dmin * scale, 30.0)
            out[i, s:e] = torch.sum(row_ok & (d1 < thr[None, :]),
                                    dim=0).cpu().numpy()
    return out


def similarity(counts: np.ndarray, nfeat: np.ndarray) -> np.ndarray:
    """[F, F] float32 ``count / min(n_i, n_j)`` (README.md:121), as the
    port computes it."""
    nf = np.asarray(nfeat, np.float32)
    denom = np.maximum(np.minimum(nf[:, None], nf[None, :]), np.float32(1))
    return counts.astype(np.float32) / denom


def loop_mask(counts: np.ndarray, sims: np.ndarray, loop: dict) -> np.ndarray:
    """[F, F] bool: the pairs ``j <= i - gap`` that pass the loop rule."""
    f = counts.shape[0]
    band = np.tril(np.ones((f, f), bool), -loop["min_loop_gap"])
    return band & (sims > np.float32(loop["loop_threshold"])) & (
        counts >= loop["min_matches"])
