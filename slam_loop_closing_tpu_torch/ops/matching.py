"""Descriptor matching: Hamming nearest neighbours with the 2 x min-distance
rule, the banded all-pairs good-match counts behind the loop-similarity
matrix, the Lowe-ratio matching of the Version-B pipeline, and the
motion-coherence quality that PROSAC ranks matches by.

Port of :mod:`slam_loop_closing_tpu.ops.matching` (the SIFT path's
``ratio_matches_l2`` waits for the SIFT front-end).
The per-pair rule (README.md:116-117 of the reference): each query
descriptor's nearest valid target at Hamming distance ``d1``; a match is good
when ``d1 < max(scale * min d1, 30)``. :func:`nn_matches_2xmin` keeps the
matches themselves (nearest-neighbour kernel D); :func:`banded_pair_counts`
counts them for every frame pair ``t <= q - min_gap`` (band-count kernel C)
and :func:`block_pair_counts` for every pair of two frame blocks (kernel C's
frame-pair entry point on the card). :func:`motion_support` (kernel E) is
the support count behind :func:`prosac_quality`. :func:`ratio_matches_hamming`
keeps a query's nearest target when ``d1 < ratio * d2`` (the top-2 kernel F
on the card, over a list of frame pairs).

Signed descriptors are ``[..., 256]`` int8 +-1 with invalid rows zero;
packed ones ``[..., 8]`` int32 words (:mod:`.descriptors`). Validity masks
are always explicit. Products of +-1 values are exact in float32
(|dot| <= 256), so the plain path uses float32 matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops.descriptors import BITS

BIG = 2 ** 30   # distance of a masked (query, target) pair
BIG_F = 1e30    # float distance bound of the ratio test


def hamming_matrix(signed_q: torch.Tensor, signed_t: torch.Tensor) -> torch.Tensor:
    """[..., M, 256] x [..., N, 256] int8 +-1 -> [..., M, N] int32 Hamming
    distances, ``(BITS - q @ t^T) / 2``."""
    dots = signed_q.to(torch.float32) @ signed_t.to(torch.float32).transpose(
        -1, -2)
    return (BITS - dots.to(torch.int32)) >> 1


def block_pair_counts_plain(signed_q: torch.Tensor, valid_q: torch.Tensor,
                            signed_t: torch.Tensor, valid_t: torch.Tensor,
                            scale: float = 2.0) -> torch.Tensor:
    """Good-match counts of every query frame against every target frame:
    [Fq, N, 256] x [Ft, N, 256] -> [Fq, Ft] int32, the plain math of
    :func:`block_pair_counts` and of the count kernels. Per query frame one
    [N, 256] @ [256, Ft*N] product and a segmented row-min; the threshold
    logic in float32, as the JAX package's reference path."""
    fq, n, d = signed_q.shape
    ft = signed_t.shape[0]
    tflat = signed_t.reshape(ft * n, d).to(torch.float32).T
    vflat = valid_t.reshape(ft * n)
    out = []
    for i in range(fq):
        dots = signed_q[i].to(torch.float32) @ tflat           # [N, Ft*N]
        dist = torch.where(vflat[None, :], (BITS - dots) * 0.5, 512.0)
        d1 = torch.amin(dist.reshape(n, ft, n), dim=2)          # [N, Ft]
        row_ok = valid_q[i][:, None] & (d1 < BITS + 1)
        dmin = torch.amin(torch.where(row_ok, d1, 512.0), dim=0)  # [Ft]
        thr = torch.clamp_min(dmin * scale, 30.0)
        out.append(torch.sum(row_ok & (d1 < thr[None, :]), dim=0,
                             dtype=torch.int32))
    return torch.stack(out)


def block_pair_counts(signed_q: torch.Tensor, valid_q: torch.Tensor,
                      signed_t: torch.Tensor, valid_t: torch.Tensor,
                      scale: float = 2.0) -> torch.Tensor:
    """[Fq, N, 256] x [Ft, N, 256] -> [Fq, Ft] int32 good-match counts:
    every (query, target) frame pair through the frame-pair count kernel
    (:func:`.cuda_kernels.pair_counts`, its plain version on the CPU) on the
    packed words."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    fq, ft = signed_q.shape[0], signed_t.shape[0]
    packed = desc_ops.signed_to_packed(torch.cat([signed_q, signed_t]))
    valid = torch.cat([valid_q, valid_t])
    dev = signed_q.device
    qidx = torch.arange(fq, dtype=torch.int32, device=dev).repeat_interleave(ft)
    tidx = torch.arange(fq, fq + ft, dtype=torch.int32, device=dev).repeat(fq)
    return cuda_kernels.pair_counts(packed, valid, qidx, tidx,
                                    scale).reshape(fq, ft)


def band_tiles(num_blocks: int, block: int,
               min_gap: int) -> list[tuple[int, int]]:
    """(query block, target block) tiles that intersect the band
    ``t <= q - min_gap``, query-major."""
    return [(qb, tb) for qb in range(num_blocks) for tb in range(num_blocks)
            if tb * block <= qb * block + block - 1 - min_gap]


def _pad_frames(signed: torch.Tensor, valid: torch.Tensor, block: int):
    """Frames padded to a multiple of ``block`` with invalid all-zero rows,
    as packed words: ([Fp, N, 8] int32, [Fp, N] bool)."""
    f, n, d = signed.shape
    pad = (-f) % block
    if pad:
        signed = torch.cat([signed, signed.new_zeros((pad, n, d))])
        valid = torch.cat([valid, valid.new_zeros((pad, n))])
    return desc_ops.signed_to_packed(signed), valid


def _band_mask(f: int, min_gap: int, device) -> torch.Tensor:
    q = torch.arange(f, device=device)[:, None]
    t = torch.arange(f, device=device)[None, :]
    return t <= q - min_gap


def banded_pair_counts(signed: torch.Tensor, valid: torch.Tensor, min_gap: int,
                       scale: float = 2.0, block: int = 16) -> torch.Tensor:
    """[F, F] int32 good-match counts restricted to the loop band
    ``target <= query - min_gap`` (everything else 0), computed over the
    ``block x block`` frame tiles that intersect the band by one launch of
    the band-count kernel."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    f = signed.shape[0]
    packed, vp = _pad_frames(signed, valid, block)
    nb = packed.shape[0] // block
    pairs = band_tiles(nb, block, min_gap)
    if not pairs:
        return torch.zeros((f, f), dtype=torch.int32, device=signed.device)
    qidx, tidx = torch.tensor(pairs, dtype=torch.int32,
                              device=signed.device).T
    tiles = cuda_kernels.band_count_tiles(packed, vp, qidx, tidx, block,
                                          scale)
    full = torch.zeros((nb, nb, block, block), dtype=torch.int32,
                       device=signed.device)
    full[qidx.long(), tidx.long()] = tiles
    counts = full.permute(0, 2, 1, 3).reshape(nb * block, nb * block)[:f, :f]
    return torch.where(_band_mask(f, min_gap, signed.device), counts, 0)


def banded_pair_counts_chunked(signed: torch.Tensor, valid: torch.Tensor,
                               min_gap: int, scale: float = 2.0,
                               block: int = 8) -> np.ndarray:
    """Sequence-scale :func:`banded_pair_counts` (KITTI, config 2, the
    1000-frame shape): the [F, F] count matrix as host numpy. The JAX
    package splits the band into many device programs to stay under the
    TPU's watchdog; one kernel launch holds any band's tile list on the
    card (the 4541-frame KITTI band is ~161k 8-frame tiles)."""
    return banded_pair_counts(signed, valid, min_gap, scale,
                              block).cpu().numpy()


def similarity(counts: torch.Tensor, nq: torch.Tensor,
               nt: torch.Tensor) -> torch.Tensor:
    """Version-A similarity score ``matches / min(n1, n2)`` (README.md:121)."""
    denom = torch.minimum(nq, nt).to(torch.float32)
    return counts.to(torch.float32) / torch.clamp_min(denom, 1.0)


# --------------------------------------------------------------------------
# nearest-neighbour matches and the PROSAC quality
# --------------------------------------------------------------------------

class Matches(NamedTuple):
    """Fixed-shape match set: one (optional) target index per query row,
    with any leading pair axes."""

    idx: torch.Tensor    # [..., M] int32 target index (meaningful where mask)
    dist: torch.Tensor   # [..., M] int32 match distance
    mask: torch.Tensor   # [..., M] bool
    count: torch.Tensor  # [...] int32 number of matches


def _mask_dist(dist: torch.Tensor, valid_q: torch.Tensor,
               valid_t: torch.Tensor) -> torch.Tensor:
    """``dist`` [..., M, N] with every pair of an invalid query or target
    row set to :data:`BIG`."""
    dist = torch.where(valid_t[..., None, :], dist, BIG)
    return torch.where(valid_q[..., :, None], dist, BIG)


class Knn2(NamedTuple):
    idx1: torch.Tensor  # [..., M] int32 nearest-neighbour index
    d1: torch.Tensor    # [..., M] nearest distance
    d2: torch.Tensor    # [..., M] second-nearest distance


def knn2(dist: torch.Tensor, valid_q: torch.Tensor,
         valid_t: torch.Tensor) -> Knn2:
    """Per-query top-2 nearest neighbours (the k=2 of cv::knnMatch) of a
    [..., M, N] distance matrix, as two masked row-min reductions: idx1 the
    first index of the minimum, d2 the minimum with idx1's column masked."""
    d = _mask_dist(dist, valid_q, valid_t)
    idx1 = torch.argmin(d, dim=-1)
    d1 = torch.gather(d, -1, idx1[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    d_wo = torch.where(cols == idx1[..., None], BIG, d)
    return Knn2(idx1=idx1.to(torch.int32), d1=d1,
                d2=torch.amin(d_wo, dim=-1))


def _ratio_from_knn2(d1: torch.Tensor, idx1: torch.Tensor, d2: torch.Tensor,
                     valid_q: torch.Tensor, ratio_eff: float) -> "Matches":
    """Ratio-test :class:`Matches` from top-2 results: keep the nearest
    neighbour when ``d1 < ratio_eff * d2`` (float32)."""
    d1f = d1.to(torch.float32)
    mask = valid_q & (d1f < ratio_eff * d2.to(torch.float32)) & (
        d1f < BIG_F / 2)
    return Matches(idx=idx1.to(torch.int32), dist=d1.to(torch.int32),
                   mask=mask, count=torch.sum(mask, dim=-1, dtype=torch.int32))


def ratio_matches(dist: torch.Tensor, valid_q: torch.Tensor,
                  valid_t: torch.Tensor, ratio: float) -> "Matches":
    """Lowe-ratio-test matching (reference main.cpp:509-534) of a [..., M,
    N] distance matrix: :func:`knn2`, then ``d1 < ratio * d2``."""
    k = knn2(dist, valid_q, valid_t)
    return _ratio_from_knn2(k.d1, k.idx1, k.d2, valid_q, ratio)


def ratio_matches_hamming_pairs(packed_q: torch.Tensor, valid_q: torch.Tensor,
                                packed_t: torch.Tensor, valid_t: torch.Tensor,
                                qidx: torch.Tensor, tidx: torch.Tensor,
                                ratio: float) -> "Matches":
    """ORB-path ratio matching of a list of frame pairs: the query frames
    ``qidx`` [P] of the store ``packed_q`` [Fq, N, 8] against the target
    frames ``tidx`` of ``packed_t`` [Ft, M, 8], by one call of the top-2
    kernel (:func:`.cuda_kernels.hamming_knn2`, its plain version on the
    CPU). :class:`Matches` with a leading [P] axis."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    d1, idx1, d2 = cuda_kernels.hamming_knn2(packed_q, valid_q, packed_t,
                                             valid_t, qidx, tidx)
    vq = valid_q.index_select(0, qidx.long())
    return _ratio_from_knn2(d1, idx1, d2, vq, ratio)


def ratio_matches_hamming(packed_q: torch.Tensor, valid_q: torch.Tensor,
                          packed_t: torch.Tensor, valid_t: torch.Tensor,
                          ratio: float) -> "Matches":
    """ORB-path ratio matching of one frame pair: packed ``[M, 8]`` /
    ``[N, 8]`` int32 words (the JAX package takes the signed layout; the
    distances are the same), through :func:`ratio_matches_hamming_pairs`."""
    zero = torch.zeros(1, dtype=torch.int32, device=packed_q.device)
    m = ratio_matches_hamming_pairs(packed_q[None], valid_q[None],
                                    packed_t[None], valid_t[None], zero,
                                    zero, ratio)
    return Matches(*(a[0] for a in m))


def pack_valid_first(desc: torch.Tensor, xy: torch.Tensor,
                     valid: torch.Tensor):
    """Permute each frame's keypoint rows so every valid row comes first,
    stable within each group, for [B, N, D] / [B, N, 2] / [B, N] inputs
    (the JAX package's stable argsort of ``~valid``, here on a uint8 key).
    Invalid rows keep their contents (zero descriptors)."""
    perm = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    return (torch.take_along_dim(desc, perm[..., None], dim=-2),
            torch.take_along_dim(xy, perm[..., None], dim=-2),
            torch.take_along_dim(valid, perm, dim=-1))


def nn_matches_2xmin(packed_q: torch.Tensor, valid_q: torch.Tensor,
                     packed_t: torch.Tensor, valid_t: torch.Tensor,
                     scale: float = 2.0) -> Matches:
    """Version-A ORB matching rule (README.md:116-117): the nearest valid
    target of each valid query descriptor (lowest index on ties, by
    :func:`.cuda_kernels.hamming_nn`), kept when ``dist < max(scale *
    min_dist, 30)`` with min_dist over this pair's rows. Takes packed
    ``[M, 8]`` / ``[N, 8]`` int32 words (the JAX package takes the signed
    layout; the distances are the same)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    d1, idx1 = cuda_kernels.hamming_nn(packed_q, valid_q, packed_t, valid_t)
    row_ok = valid_q & (d1 < BIG // 2)
    dmin = torch.amin(torch.where(row_ok, d1, BIG))
    # max(2*min, 30): a single perfect duplicate (min dist 0) must not
    # collapse the threshold (the OpenCV-matcher convention for ORB)
    thr = torch.clamp_min((dmin * scale).to(torch.int32), 30)
    mask = row_ok & (d1 < thr)
    return Matches(idx=idx1, dist=d1, mask=mask,
                   count=torch.sum(mask, dtype=torch.int32))


def gather_matched_points(xy_q: torch.Tensor, xy_t: torch.Tensor,
                          m: Matches) -> tuple[torch.Tensor, torch.Tensor]:
    """``extractMatchedPoints`` (reference main.cpp:539-556): the (query,
    matched target) point pairs at fixed shape; rows where ``m.mask`` is
    False are padding."""
    return xy_q, xy_t.index_select(0, m.idx.long())


def motion_support(xy_q: torch.Tensor, xy_t_matched: torch.Tensor,
                   mask: torch.Tensor, radius: float,
                   tau: float) -> torch.Tensor:
    """Local motion-coherence support per match (GMS-style, Bian et al.
    CVPR'17): the matches j whose query point lies within ``radius`` of
    i's and whose displacement agrees within ``tau``, minus i itself; 0 on
    invalid rows. Units of ``radius``/``tau`` follow the coordinates. On
    the card, kernel E (:func:`.cuda_kernels.motion_support`)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    return cuda_kernels.motion_support(xy_q, xy_t_matched, mask, radius, tau)


def prosac_quality(xy_q: torch.Tensor, xy_t_matched: torch.Tensor,
                   m: Matches, radius: float, tau: float) -> torch.Tensor:
    """THE PROSAC sampling-quality term for RANSAC: motion-coherence support
    with a ``-dist`` tiebreak normalized into (0, 1), so distance can never
    outvote one unit of support (descriptor distance is anti-correlated
    with correctness on repetitive texture)."""
    support = motion_support(xy_q, xy_t_matched, m.mask, radius, tau)
    dmax = torch.amax(torch.where(m.mask, m.dist, 0), dim=-1,
                      keepdim=True).to(torch.float32)
    return support.to(torch.float32) - m.dist.to(torch.float32) / (1.0 + dmax)
