"""Descriptor matching: Hamming nearest neighbours with the 2 x min-distance
rule, the banded all-pairs good-match counts behind the loop-similarity
matrix, the Lowe-ratio matching of the Version-B pipeline, and the
motion-coherence quality that PROSAC ranks matches by.

Port of :mod:`slam_loop_closing_tpu.ops.matching`.
The per-pair rule (README.md:116-117 of the reference): each query
descriptor's nearest valid target at Hamming distance ``d1``; a match is good
when ``d1 < max(scale * min d1, 30)``. :func:`nn_matches_2xmin` keeps the
matches themselves (nearest-neighbour kernel D); :func:`banded_pair_counts`
counts them for every frame pair ``t <= q - min_gap`` (band-count kernel C)
and :func:`block_pair_counts` for every pair of two frame blocks (kernel C's
frame-pair entry point on the card). :func:`good_count_pair`,
:func:`all_pairs_good_counts` and :func:`dense_pair_counts_chunked` count
them for explicit pair lists through the d1-only nearest-neighbour kernel I,
with the count rule in torch. :func:`motion_support` (kernel E) is
the support count behind :func:`prosac_quality`. :func:`ratio_matches_hamming`
keeps a query's nearest target when ``d1 < ratio * d2`` (the top-2 kernel F
on the card, over a list of frame pairs); :func:`ratio_matches_l2` is the
SIFT path's counterpart on squared L2 distances with ``ratio**2`` (the
top-2 kernel G).

Signed descriptors are ``[..., 256]`` int8 +-1 with invalid rows zero;
packed ones ``[..., 8]`` int32 words (:mod:`.descriptors`); SIFT descriptors
``[..., 128]`` float32. Validity masks are always explicit. Products of +-1
values are exact in float32 (|dot| <= 256), so the plain path uses float32
matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops
from slam_loop_closing_tpu_torch.ops.descriptors import BITS
from slam_loop_closing_tpu_torch.utils import profiling

BIG = 2 ** 30   # integer distance of a masked (query, target) pair
BIG_F = 1e30    # float distance of a masked pair, and the ratio test's bound


def _big(dtype: torch.dtype):
    """The masked-pair distance of a distance dtype: :data:`BIG` for
    integers, :data:`BIG_F` for floats (the JAX package's rule)."""
    return BIG_F if dtype.is_floating_point else BIG


def hamming_matrix(signed_q: torch.Tensor, signed_t: torch.Tensor) -> torch.Tensor:
    """[..., M, 256] x [..., N, 256] int8 +-1 -> [..., M, N] int32 Hamming
    distances, ``(BITS - q @ t^T) / 2``."""
    dots = signed_q.to(torch.float32) @ signed_t.to(torch.float32).transpose(
        -1, -2)
    return (BITS - dots.to(torch.int32)) >> 1


def l2sq_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., M, D] x [..., N, D] float -> [..., M, N] float32 squared L2
    distances by the GEMM expansion ``max(|a|^2 - 2 a.b + |b|^2, 0)``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    dots = a @ b.transpose(-1, -2)
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    return torch.clamp_min(na[..., :, None] - 2.0 * dots + nb[..., None, :],
                           0.0)


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
    """Frames ``[..., F, N, 256]`` padded along the frame axis to a multiple
    of ``block`` with invalid all-zero rows, as packed words:
    ([..., Fp, N, 8] int32, [..., Fp, N] bool)."""
    pad = (-signed.shape[-3]) % block
    if pad:
        lead, (n, d) = signed.shape[:-3], signed.shape[-2:]
        signed = torch.cat([signed, signed.new_zeros((*lead, pad, n, d))], -3)
        valid = torch.cat([valid, valid.new_zeros((*lead, pad, n))], -2)
    return desc_ops.signed_to_packed(signed), valid


def _counts_span(videos: int, frames: int, min_gap: int):
    """The span ``slam.matching.counts`` of a pair-count call over the
    band ``t <= q - min_gap`` of ``videos`` sequences of ``frames`` frames,
    with its ``pairs``. The functions that count call each other; the
    outermost call's span holds the others' (:func:`.profiling.annotate`
    folds a span into an open one of its name)."""
    n = max(frames - min_gap, 0)
    return profiling.annotate("slam.matching.counts",
                              pairs=videos * n * (n + 1) // 2)


def _band_mask(f: int, min_gap: int, device) -> torch.Tensor:
    q = torch.arange(f, device=device)[:, None]
    t = torch.arange(f, device=device)[None, :]
    return t <= q - min_gap


def video_band_tiles(signed: torch.Tensor, valid: torch.Tensor, min_gap: int,
                     block: int = 16):
    """The band-count kernel's arguments for ``V`` sequences (``signed``
    [V, F, N, 256], ``valid`` [V, F, N]): every sequence padded to ``nb``
    whole blocks of ``block`` frames, so no ``block x block`` frame tile
    straddles two sequences, as ONE flat store, and the tiles that intersect
    the band ``target <= query - min_gap`` of every sequence, sequence-major.
    Returns (packed [V*nb*block, N, 8] int32, valid [V*nb*block, N], qidx
    [V*T], tidx [V*T], qb [T], tb [T]): ``qidx``/``tidx`` index blocks of
    the flat store, ``qb``/``tb`` the same T tiles inside one sequence."""
    v = signed.shape[0]
    dev = signed.device
    packed, vp = _pad_frames(signed, valid, block)
    nb = packed.shape[1] // block
    qb, tb = torch.tensor(band_tiles(nb, block, min_gap), dtype=torch.int32,
                          device=dev).reshape(-1, 2).T
    # sequence s's blocks are s * nb .. s * nb + nb - 1 of the flat store
    first = (torch.arange(v, dtype=torch.int32, device=dev) * nb)[:, None]
    return (packed.reshape(v * nb * block, *packed.shape[2:]),
            vp.reshape(v * nb * block, -1), (first + qb).reshape(-1),
            (first + tb).reshape(-1), qb, tb)


def banded_pair_counts_videos(signed: torch.Tensor, valid: torch.Tensor,
                              min_gap: int, scale: float = 2.0,
                              block: int = 16) -> torch.Tensor:
    """[V, F, F] int32 good-match counts of ``V`` sequences
    (``signed`` [V, F, N, 256], ``valid`` [V, F, N]), each restricted to its
    loop band ``target <= query - min_gap`` (everything else 0): the tiles
    of :func:`video_band_tiles` through ONE launch of the band-count
    kernel."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    v, f = signed.shape[:2]
    dev = signed.device
    with _counts_span(v, f, min_gap):
        packed, vp, qidx, tidx, qb, tb = video_band_tiles(signed, valid,
                                                          min_gap, block)
        if qidx.numel() == 0:
            return torch.zeros((v, f, f), dtype=torch.int32, device=dev)
        tiles = cuda_kernels.band_count_tiles(packed, vp, qidx, tidx, block,
                                              scale)
        nb = packed.shape[0] // (v * block)
        full = torch.zeros((v, nb, nb, block, block), dtype=torch.int32,
                           device=dev)
        full[:, qb.long(), tb.long()] = tiles.reshape(v, qb.shape[0], block,
                                                      block)
        counts = full.permute(0, 1, 3, 2, 4).reshape(
            v, nb * block, nb * block)[:, :f, :f]
        return torch.where(_band_mask(f, min_gap, dev), counts, 0)


def banded_pair_counts(signed: torch.Tensor, valid: torch.Tensor, min_gap: int,
                       scale: float = 2.0, block: int = 16) -> torch.Tensor:
    """[F, F] int32 good-match counts restricted to the loop band
    ``target <= query - min_gap`` (everything else 0), computed over the
    ``block x block`` frame tiles that intersect the band by one launch of
    the band-count kernel: :func:`banded_pair_counts_videos` of one
    sequence."""
    return banded_pair_counts_videos(signed[None], valid[None], min_gap,
                                     scale, block)[0]


def banded_pair_counts_chunked(signed: torch.Tensor, valid: torch.Tensor,
                               min_gap: int, scale: float = 2.0,
                               block: int = 8) -> np.ndarray:
    """Sequence-scale :func:`banded_pair_counts` (KITTI, config 2, the
    1000-frame shape): the [F, F] count matrix as host numpy. The JAX
    package splits the band into many device programs to stay under the
    TPU's watchdog; one kernel launch holds any band's tile list on the
    card (the 4541-frame KITTI band is ~161k 8-frame tiles)."""
    with _counts_span(1, signed.shape[0], min_gap):
        return banded_pair_counts(signed, valid, min_gap, scale,
                                  block).cpu().numpy()


def _counts_from_d1(d1: torch.Tensor, valid_q: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The Version-A count rule on nearest distances ``d1`` [..., N] int32 of
    query rows with validity ``valid_q``: ``row_ok = valid_q & d1 < 2^29``,
    ``thr = max(int(min d1 * scale), 30)`` (the product truncated to int32,
    as the JAX package's per-pair path), count of ``row_ok & d1 < thr``."""
    row_ok = valid_q & (d1 < BIG // 2)
    # a frame pair with no usable row counts 0 whatever its threshold: its
    # dmin is bounded so the product stays inside int32
    dmin = torch.amin(torch.where(row_ok, d1, BITS), dim=-1, keepdim=True)
    thr = torch.clamp_min((dmin * scale).to(torch.int32), 30)
    return torch.sum(row_ok & (d1 < thr), dim=-1, dtype=torch.int32)


def all_pairs_good_counts(packed: torch.Tensor, valid: torch.Tensor,
                          pair_q: torch.Tensor, pair_t: torch.Tensor,
                          scale: float = 2.0) -> torch.Tensor:
    """[P] int32 good-match counts of an explicit list of frame pairs
    (``pair_q[p]``, ``pair_t[p]``) of the store ``packed`` [F, N, 8] int32
    with validity ``valid`` [F, N] (pad the lists with 0: callers mask). One
    launch of the d1-only nearest-neighbour kernel
    (:func:`.cuda_kernels.hamming_d1_pairs`, its plain version on the CPU)
    over the whole list, on the store in place, then the count rule batched
    over pairs. The JAX package takes the signed layout and maps over chunks
    of pairs to bound its transient memory; the distances are the same."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    d1 = cuda_kernels.hamming_d1_pairs(packed, packed, valid, pair_q, pair_t)
    return _counts_from_d1(d1, valid.index_select(0, pair_q.long()), scale)


def good_count_pair(packed_q: torch.Tensor, valid_q: torch.Tensor,
                    packed_t: torch.Tensor, valid_t: torch.Tensor,
                    scale: float = 2.0) -> torch.Tensor:
    """Good-match count of one frame pair, packed ``[M, 8]`` / ``[N, 8]``
    int32 words: the d1-only kernel (:func:`.cuda_kernels.hamming_nn_d1`)
    and the count rule. Equal to ``nn_matches_2xmin(...).count``."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    d1 = cuda_kernels.hamming_nn_d1(packed_q, packed_t, valid_t)
    return _counts_from_d1(d1, valid_q, scale)


def dense_pair_counts_chunked(signed: torch.Tensor, valid: torch.Tensor,
                              scale: float = 2.0, min_gap: int = 1,
                              pairs_per_call: int = 8192) -> np.ndarray:
    """Sequence-scale DENSE all-pairs good-match counts (a 500-frame
    ORB-4000 dense similarity matrix): every ordered pair
    ``t <= q - min_gap`` through :func:`all_pairs_good_counts`,
    ``pairs_per_call`` pairs per kernel launch (which bounds the [P, N]
    distance table). The pair lists are built and the counts scattered on
    the device; the [F, F] int32 matrix (other entries 0) comes back as host
    numpy in one copy at the end. The same band through the tile kernel is
    :func:`banded_pair_counts_chunked`; the two agree wherever the float and
    the truncated threshold do (any integer ``scale``)."""
    f = signed.shape[0]
    dev = signed.device
    with _counts_span(1, f, min_gap):
        packed = desc_ops.signed_to_packed(signed)
        pq, pt = torch.tril_indices(f, f, offset=-min_gap, device=dev)
        out = torch.zeros((f, f), dtype=torch.int32, device=dev)
        for s in range(0, pq.shape[0], pairs_per_call):
            q, t = pq[s:s + pairs_per_call], pt[s:s + pairs_per_call]
            out[q, t] = all_pairs_good_counts(packed, valid, q, t, scale)
        return out.cpu().numpy()


def dense_pair_counts(signed: torch.Tensor, valid: torch.Tensor,
                      scale: float = 2.0, t_block: int = 16) -> torch.Tensor:
    """Full [F, F] int32 good-match-count matrix of ``signed`` [F, N, 256],
    ``valid`` [F, N]: every ordered frame pair, the diagonal and the upper
    triangle included, by the float32 threshold rule of
    :func:`block_pair_counts`; band-mask afterwards. The frame-pair count
    kernel runs ``t_block`` target frames of every query frame a launch
    (which bounds the pair list, as it bounds the JAX package's transient
    distance block)."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    f = signed.shape[0]
    dev = signed.device
    packed = desc_ops.signed_to_packed(signed)
    frames = torch.arange(f, dtype=torch.int32, device=dev)
    cols = []
    for t0 in range(0, f, t_block):
        tb = frames[t0:t0 + t_block]
        cols.append(cuda_kernels.pair_counts(
            packed, valid, frames.repeat_interleave(tb.shape[0]),
            tb.repeat(f), scale).reshape(f, tb.shape[0]))
    return torch.cat(cols, dim=1)


def similarity(counts: torch.Tensor, nq: torch.Tensor,
               nt: torch.Tensor) -> torch.Tensor:
    """Version-A similarity score ``matches / min(n1, n2)`` (README.md:121)."""
    with profiling.annotate("slam.matching.similarity"):
        denom = torch.minimum(nq, nt).to(torch.float32)
        return counts.to(torch.float32) / torch.clamp_min(denom, 1.0)


# --------------------------------------------------------------------------
# nearest-neighbour matches and the PROSAC quality
# --------------------------------------------------------------------------

class Matches(NamedTuple):
    """Fixed-shape match set: one (optional) target index per query row,
    with any leading pair axes."""

    idx: torch.Tensor    # [..., M] int32 target index (meaningful where mask)
    dist: torch.Tensor   # [..., M] int32 Hamming / float32 squared-L2 distance
    mask: torch.Tensor   # [..., M] bool
    count: torch.Tensor  # [...] int32 number of matches


def _mask_dist(dist: torch.Tensor, valid_q: torch.Tensor,
               valid_t: torch.Tensor) -> torch.Tensor:
    """``dist`` [..., M, N] with every pair of an invalid query or target
    row set to :data:`BIG` (integer distances) or :data:`BIG_F` (float)."""
    big = _big(dist.dtype)
    dist = torch.where(valid_t[..., None, :], dist, big)
    return torch.where(valid_q[..., :, None], dist, big)


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
    d_wo = torch.where(cols == idx1[..., None], _big(d.dtype), d)
    return Knn2(idx1=idx1.to(torch.int32), d1=d1,
                d2=torch.amin(d_wo, dim=-1))


def _ratio_from_knn2(d1: torch.Tensor, idx1: torch.Tensor, d2: torch.Tensor,
                     valid_q: torch.Tensor, ratio_eff: float) -> "Matches":
    """Ratio-test :class:`Matches` from top-2 results: keep the nearest
    neighbour when ``d1 < ratio_eff * d2`` (compared in float32). The
    distance keeps its kind: int32 for Hamming, float32 for squared L2."""
    d1f = d1.to(torch.float32)
    mask = valid_q & (d1f < ratio_eff * d2.to(torch.float32)) & (
        d1f < BIG_F / 2)
    dist = d1f if d1.dtype.is_floating_point else d1.to(torch.int32)
    return Matches(idx=idx1.to(torch.int32), dist=dist, mask=mask,
                   count=torch.sum(mask, dim=-1, dtype=torch.int32))


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


def ratio_matches_l2_pairs(desc_q: torch.Tensor, valid_q: torch.Tensor,
                           desc_t: torch.Tensor, valid_t: torch.Tensor,
                           qidx: torch.Tensor, tidx: torch.Tensor,
                           ratio: float) -> "Matches":
    """SIFT-path ratio matching of a list of frame pairs: the query frames
    ``qidx`` [P] of the store ``desc_q`` [Fq, N, 128] float32 against the
    target frames ``tidx`` of ``desc_t`` [Ft, M, 128], on squared L2
    distances with ``ratio**2`` (``d1 < r d2  <=>  d1^2 < r^2 d2^2``, as
    cv::BFMatcher NORM_L2 + the Lowe test), by one call of the top-2 kernel
    (:func:`.cuda_kernels.l2_knn2`, its plain version on the CPU).
    :class:`Matches` with a leading [P] axis and float32 distances."""
    from slam_loop_closing_tpu_torch.ops import cuda_kernels

    d1, idx1, d2 = cuda_kernels.l2_knn2(desc_q, valid_q, desc_t, valid_t,
                                        qidx, tidx)
    vq = valid_q.index_select(0, qidx.long())
    return _ratio_from_knn2(d1, idx1, d2, vq, ratio * ratio)


def ratio_matches_l2(desc_q: torch.Tensor, valid_q: torch.Tensor,
                     desc_t: torch.Tensor, valid_t: torch.Tensor,
                     ratio: float) -> "Matches":
    """SIFT-path ratio matching of one frame pair, ``[M, 128]`` /
    ``[N, 128]`` float32 descriptors, through
    :func:`ratio_matches_l2_pairs`."""
    zero = torch.zeros(1, dtype=torch.int32, device=desc_q.device)
    m = ratio_matches_l2_pairs(desc_q[None], valid_q[None], desc_t[None],
                               valid_t[None], zero, zero, ratio)
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
