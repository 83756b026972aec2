// Tensor-core block of kernel F (Hamming top-2 with index): for a slab of
// query rows of one frame and a range of target rows of another, both read
// from the packed descriptor stores in place ([rows, 8] 32-bit words, 256
// bits a row), each query row's two smallest keys
//   key(i, j) = (hamming(q_i, t_j) << 20) + j        over valid targets j
// so the smallest key holds d1 and the lowest row j that reaches it, and the
// second smallest holds d2, the second smallest distance of the multiset
// (d1 again when two targets tie). Keys are distinct, so the top-2 of a
// union is the top-2 of the parts' top-2s, in any order: the lanes of a
// quad, the warps and the splits of the target rows merge with
//   (a1, a2) + (b1, b2) -> (min(a1, b1), min(max(a1, b1), a2, b2))
// and no rule for ties is needed beyond the key itself.
//
// The distance comes from the b1 mma of hamming_mma.cuh on the words as
// they are: acc = popc(q & t) for 16 x 8 row pairs, and
//   hamming(q, t) = popc(q) + popc(t) - 2 acc,
// so key = col_t - 2^21 acc with col_t = (popc(t) << 20) + j, computed
// once per staged target row, and popc(q) << 20 added once per query row
// at the end: one integer multiply-add a distance, and 3 integer min/max
// for the running top-2 (m2 = min(m2, max(m1, k)); m1 = min(m1, k)).
// An invalid target row has col_t = 2^30 + 2^29, so its keys stay at or
// above 2^30 (kNoKey) and can neither win d1 nor turn up as d2; a query
// row whose best key is at or above kNoKey has no valid target.
//
// Rows are staged in their own order (no parity compaction, which the
// d1-only kernels need for their bare maximum): the index is in the key.
// Layout as in hamming_mma.cuh: lane (g, t) holds words 2t and 2t + 1 of a
// row as its two k-slices, for queries and targets alike, so a warp's
// fragment load of 8 staged target rows is 256 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hamming_mma.cuh"

namespace hamming_knn2 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 512;                 // target rows staged at a time
constexpr int kIdxBits = 20;                // target row index bits of a key
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kNoKey = 1 << 30;             // keys at or above: no target
constexpr int kInvalidCol = kNoKey + (1 << 29);
constexpr int kBig = 1 << 30;               // distance of a masked pair
constexpr int kSmemBytes = kStage * 32 + kStage * 4;

template <int kTiles>
constexpr int kSlabRows = kWarps * kTiles * 16;  // query rows a block

// push key k into the running top-2 (m1 <= m2)
__device__ __forceinline__ void push2(int& m1, int& m2, int k) {
  m2 = min(m2, max(m1, k));
  m1 = min(m1, k);
}

// merge another top-2 (o1 <= o2) into (m1 <= m2)
__device__ __forceinline__ void merge2(int& m1, int& m2, int o1, int o2) {
  m2 = min(max(m1, o1), min(m2, o2));
  m1 = min(m1, o1);
}

// (d1, idx, d2) of a query row from its two smallest keys (popc(q) added):
// (2^30, 0, 2^30) for an invalid query row or one with no valid target,
// d2 = 2^30 where a single target is valid
__device__ __forceinline__ void store(int* __restrict__ d1,
                                      int* __restrict__ idx,
                                      int* __restrict__ d2, size_t o,
                                      bool valid, int k1, int k2) {
  const bool hit = valid && k1 < kNoKey;
  d1[o] = hit ? k1 >> kIdxBits : kBig;
  idx[o] = hit ? k1 & kIdxMask : 0;
  d2[o] = hit && k2 < kNoKey ? k2 >> kIdxBits : kBig;
}

// emit(row, k1, k2) once for every query row in [row0, min(row0 +
// kSlabRows<kTiles>, n_q)), with k1 <= k2 the row's two smallest keys
// (popc(q) included) over target rows [t_begin, t_end). q: [n_q, 8] words of
// the query frame; t: [.., 8] words and tv: validity bytes of the target
// frame. All kThreads threads of the block call it together; smem holds
// kSmemBytes, 16-byte aligned.
//
template <int kTiles, class Emit>
__device__ __forceinline__ void top2_keys(
    const uint32_t* __restrict__ q, int n_q, int row0,
    const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
    int t_begin, int t_end, unsigned char* smem, Emit emit) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  uint4* swords = reinterpret_cast<uint4*>(smem);             // [kStage][2]
  int* scol = reinterpret_cast<int*>(smem + kStage * 32);     // [kStage]

  const int wrow0 = row0 + warp * kTiles * 16;
  const bool idle = wrow0 >= n_q;  // no query row: the warp only stages

  uint32_t a[kTiles][4];
  int m1[kTiles][2], m2[kTiles][2];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
    const uint2 w0 =
        r0 < n_q ? hamming_mma::row_slices(q, r0, tq) : make_uint2(0, 0);
    const uint2 w1 =
        r1 < n_q ? hamming_mma::row_slices(q, r1, tq) : make_uint2(0, 0);
    a[m][0] = w0.x;
    a[m][1] = w1.x;
    a[m][2] = w0.y;
    a[m][3] = w1.y;
    m1[m][0] = m2[m][0] = m1[m][1] = m2[m][1] = kNoKey;
  }

  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  for (int t0 = t_begin; t0 < t_end; t0 += kStage) {
    __syncthreads();  // the previous stage is no longer being read
    // kStage rows x 2 halves of 16 bytes; item i is half (i & 1) of row
    // t0 + (i >> 1), so the two halves of a row are neighbouring lanes
#pragma unroll
    for (int k = 0; k < kStage * 2 / kThreads; ++k) {
      const int i = tid + k * kThreads, row = t0 + (i >> 1);
      const bool in = row < t_end;
      const uint4 w = in ? t4[static_cast<size_t>(row) * 2 + (i & 1)]
                         : make_uint4(0, 0, 0, 0);
      int pc = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      pc += __shfl_xor_sync(0xffffffffu, pc, 1);
      swords[i] = w;
      if ((i & 1) == 0)
        scol[i >> 1] = in && tv[row] ? (pc << kIdxBits) + row : kInvalidCol;
    }
    __syncthreads();
    if (idle) continue;
    const int tiles = (min(kStage, t_end - t0) + 7) / 8;
    const uint2* sw2 = reinterpret_cast<const uint2*>(swords);
    const int2* sc2 = reinterpret_cast<const int2*>(scol);
#pragma unroll 2
    for (int nt = 0; nt < tiles; ++nt) {
      const uint2 b = sw2[nt * 32 + lane];  // row nt * 8 + g, slices tq
      const int2 c = sc2[nt * 4 + tq];      // columns nt * 8 + 2 tq, + 1
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
        int acc[4];
        hamming_mma::mma_b1(acc, a[m][0], a[m][1], a[m][2], a[m][3], b.x,
                            b.y, 0, 0, 0, 0);
        push2(m1[m][0], m2[m][0], c.x - acc[0] * (2 << kIdxBits));
        push2(m1[m][0], m2[m][0], c.y - acc[1] * (2 << kIdxBits));
        push2(m1[m][1], m2[m][1], c.x - acc[2] * (2 << kIdxBits));
        push2(m1[m][1], m2[m][1], c.y - acc[3] * (2 << kIdxBits));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k1 = m1[m][h], k2 = m2[m][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        merge2(k1, k2, __shfl_xor_sync(0xffffffffu, k1, o),
               __shfl_xor_sync(0xffffffffu, k2, o));
      int pq = __popc(a[m][h]) + __popc(a[m][2 + h]);
      pq += __shfl_xor_sync(0xffffffffu, pq, 1);
      pq += __shfl_xor_sync(0xffffffffu, pq, 2);
      const int row = wrow0 + m * 16 + h * 8 + g;
      if (tq == 0 && row < n_q)
        emit(row, k1 + (pq << kIdxBits), k2 + (pq << kIdxBits));
    }
  }
}

}  // namespace hamming_knn2
