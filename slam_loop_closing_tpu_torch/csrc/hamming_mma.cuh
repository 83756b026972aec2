// Tensor-core inner loop of the Hamming good-match kernels (band counts,
// frame-pair counts, d1-only nearest neighbour): for a slab of query rows of
// one frame, the Hamming distance to the nearest valid row of another frame,
// both read from the packed descriptor stores in place ([rows, 8] 32-bit
// words, 256 bits a row).
//
// Replaces the inner loops of slam_loop_closing_tpu/ops/pallas_kernels.py's
// _band_d1_kernel, _band_counts_kernel, _pair_d1_kernel and
// _hamming_d1_kernel, which took the row minimum of the distance as the row
// maximum of a +-1 int8 product on the TPU's matrix unit.
//
// Here the product is mma.sync.m16n8k256.b1.b1.s32.and.popc on the packed
// words as they are: one instruction gives popc(q & t) of 16 x 8 row pairs
// with int32 accumulation, and
//   d = popc(q) + popc(t) - 2 popc(q & t)
// so every distance is an exact integer, and the row minimum of d is
// popc(q) - max_t (2 popc(q & t) - col_t) with col_t = popc(t), popc(q)
// added once per row at the end. Validity costs nothing in the loop: an
// invalid target row has col_t = popc(t) + 512, so its distances read
// d + 512 and never win a minimum that can pass d < 257.
//
// Epilogue. What limits this loop is not the mma but the integer work on its
// 4 results a thread (csrc/probes/probe_hamming_forms.py: the mma alone
// runs three times as fast as the mma with two 3-input maxima behind it),
// so the epilogue is a running maximum and nothing else. That needs the
// factor 2 and col_t out of the loop: 2 popc(q & t) - col_t has the parity
// of col_t, so the rows of a staged chunk are compacted by that parity (even
// rows from slot 0 up, odd rows from the last slot down; ranks from warp
// ballots and one scan of the 32 per-warp counts), every 8-row tile holds
// one parity, its accumulators start at -ceil(col_t / 2), and
//   max_t (2 popc(q & t) - col_t) = max(2 max_even, 2 max_odd + 1).
// A slot with no row starts at -4096 and cannot win.
//
// Layout. The order of the 256 bits within a row does not change the count
// as long as both operands use the same order, so lane (g, t) of a warp takes
// words 2t and 2t+1 of row g (one 8-byte load) as its k-slices [32t, 32t+32)
// and [128+32t, 128+32t+32) of the fragment, for queries and targets alike.
// A warp keeps 128 query rows (8 tiles of 16) as fragments in registers for
// its whole target loop, a block of 8 warps 1,024. The block stages 512
// target rows (16 KB, packed as in global memory) at a time; a warp's
// fragment load of 8 target rows is 256 contiguous bytes (no bank conflict)
// and serves its 8 query tiles. The next chunk's global loads are in flight
// while the current one is multiplied.
//
// Bound on the H100: the card's b1 mma rate (NVIDIA publishes none; the probe
// measures the instruction alone). The forms that lost the probe live in
// csrc/probes/hamming_forms.cu: the +-1 int8 form
// (mma.sync.m16n8k32.s8, operands unpacked into shared memory), b1 with the
// rows left in place and a multiply-add against col_t in the epilogue, and
// b1 with two mma (q & t, ~q & ~t).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hamming_mma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;                // blocks an SM: 128 registers
constexpr int kTiles = 8;                    // 16-row query tiles a warp
constexpr int kSlab = kWarps * kTiles * 16;  // query rows a block: 1,024
constexpr int kChunk = 512;                  // target rows staged at a time
constexpr int kCap = kChunk + 8;             // staged slots
constexpr int kSmemBytes = kCap * 32 + kCap * 4 + 32 * 4;
constexpr int kFill = -4096;       // accumulator start of a slot with no row
constexpr int kPenalty = 512;      // added to distances to invalid targets
constexpr int kNone = -(1 << 20);  // running maximum before any target row

// d = c + popc(a & b) over k = 256 bits: a [16, 256] row-major (a0: row g,
// k-slice t; a1: row g + 8, k-slice t; a2, a3: the same rows, k-slice 4 + t),
// b [256, 8] column-major (b0: column g, k-slice t; b1: k-slice 4 + t),
// c and d [16, 8] (0, 1: row g, columns 2t, 2t + 1; 2, 3: row g + 8)
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3));
}

// words 2t and 2t + 1 of a row: the lane's two k-slices of that row
__device__ __forceinline__ uint2 row_slices(const uint32_t* rows, int row,
                                            int tq) {
  return *reinterpret_cast<const uint2*>(rows + static_cast<size_t>(row) * 8 +
                                         2 * tq);
}

// store(row, d) once for every query row in [row0, min(row0 + kSlab, n_q)):
//   d = min over target rows j in [t_begin, t_end) of
//       hamming(q[row], t[j]) + (tv[j] ? 0 : kPenalty),
// at least 2^19 for an empty range. q: [n_q, 8] words of the query frame,
// t: [.., 8] words and tv: validity bytes of the target frame. All kThreads
// threads of the block call it together; smem holds kSmemBytes, 16-byte
// aligned, and may be handed to the next call without a barrier between.
template <class Store>
__device__ __forceinline__ void nearest_valid_distance(
    const uint32_t* __restrict__ q, int n_q, int row0,
    const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
    int t_begin, int t_end, unsigned char* smem, Store store) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  uint4* srows = reinterpret_cast<uint4*>(smem);            // [kCap][2]
  int* sinit = reinterpret_cast<int*>(smem + kCap * 32);    // [kCap]
  int* scount = sinit + kCap;  // [32]: even | odd << 16 rows of each group

  const int wrow0 = row0 + warp * kTiles * 16;
  const bool idle = wrow0 >= n_q;  // no query row: the warp only stages

  uint32_t a[kTiles][4];
  int run_e[kTiles][2], run_o[kTiles][2];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
    const uint2 w0 = r0 < n_q ? row_slices(q, r0, tq) : make_uint2(0, 0);
    const uint2 w1 = r1 < n_q ? row_slices(q, r1, tq) : make_uint2(0, 0);
    a[m][0] = w0.x;
    a[m][1] = w1.x;
    a[m][2] = w0.y;
    a[m][3] = w1.y;
    run_e[m][0] = run_e[m][1] = run_o[m][0] = run_o[m][1] = kNone;
  }

  // staging: kChunk rows x 2 halves of 16 bytes = 4 items a thread; item
  // i = tid + k * kThreads is half (i & 1) of row (i >> 1), so a warp holds
  // 16 whole rows of group k * kWarps + warp
  uint4 pre[4];
  bool pvalid[4];
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  auto fetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + k * kThreads, row = t0 + (i >> 1);
      const bool in = row < t_end;
      pre[k] = in ? t4[static_cast<size_t>(row) * 2 + (i & 1)]
                  : make_uint4(0, 0, 0, 0);
      pvalid[k] = in && tv[row];
    }
  };
  fetch(t_begin);
  const uint32_t below = (1u << (lane & ~1)) - 1u;  // lanes of earlier rows
  for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
    int col[4];
    uint32_t evens[4], odds[4];
    __syncthreads();  // the previous chunk is no longer being read
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + k * kThreads;
      int p = __popc(pre[k].x) + __popc(pre[k].y) + __popc(pre[k].z) +
              __popc(pre[k].w);
      p += __shfl_xor_sync(0xffffffffu, p, 1);  // the row's other half
      const bool in = t0 + (i >> 1) < t_end, first = (lane & 1) == 0;
      col[k] = p + (pvalid[k] ? 0 : kPenalty);
      evens[k] = __ballot_sync(0xffffffffu, in && first && !(p & 1));
      odds[k] = __ballot_sync(0xffffffffu, in && first && (p & 1));
      if (lane == 0)
        scount[k * kWarps + warp] =
            __popc(evens[k]) | (__popc(odds[k]) << 16);
    }
    __syncthreads();
    // exclusive scan of the 32 group counts (both halves at once)
    const int mine = scount[lane];
    int scan = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, scan, o);
      if (lane >= o) scan += up;
    }
    const int total = __shfl_sync(0xffffffffu, scan, 31);
    const int n_even = total & 0xffff, n_odd = total >> 16;
    scan -= mine;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int before = __shfl_sync(0xffffffffu, scan, k * kWarps + warp);
      const int i = tid + k * kThreads;
      if (t0 + (i >> 1) < t_end) {
        const bool odd = col[k] & 1;
        const int slot =
            odd ? kCap - 1 - ((before >> 16) + __popc(odds[k] & below))
                : (before & 0xffff) + __popc(evens[k] & below);
        srows[slot * 2 + (lane & 1)] = pre[k];
        if ((lane & 1) == 0) sinit[slot] = -((col[k] + 1) >> 1);
      }
    }
    __syncthreads();
    if (t0 + kChunk < t_end) fetch(t0 + kChunk);
    if (idle) continue;
    const uint2* swords = reinterpret_cast<const uint2*>(smem);
    const int2* sinit2 = reinterpret_cast<const int2*>(sinit);
    // tile `tile` (8 slots), of which columns [lo, hi) hold rows
    auto sweep = [&](int tile, int lo, int hi, int (&run)[kTiles][2]) {
      const uint2 b = swords[tile * 32 + lane];  // slot tile * 8 + g
      const int2 ci = sinit2[tile * 4 + tq];
      const int c0 = (2 * tq >= lo && 2 * tq < hi) ? ci.x : kFill;
      const int c1 = (2 * tq + 1 >= lo && 2 * tq + 1 < hi) ? ci.y : kFill;
#pragma unroll
      for (int m = 0; m < kTiles; ++m) {
        int acc[4];
        mma_b1(acc, a[m][0], a[m][1], a[m][2], a[m][3], b.x, b.y, c0, c1, c0,
               c1);
        run[m][0] = max(run[m][0], max(acc[0], acc[1]));
        run[m][1] = max(run[m][1], max(acc[2], acc[3]));
      }
    };
#pragma unroll 2
    for (int nt = 0; nt * 8 < n_even; ++nt)
      sweep(nt, 0, n_even - nt * 8, run_e);
#pragma unroll 2
    for (int nt = 0; nt * 8 < n_odd; ++nt)
      sweep(kCap / 8 - 1 - nt, 8 * (nt + 1) - n_odd, 8, run_o);
  }
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = max(2 * run_e[m][h], 2 * run_o[m][h] + 1);
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      int pq = __popc(a[m][h]) + __popc(a[m][2 + h]);
      pq += __shfl_xor_sync(0xffffffffu, pq, 1);
      pq += __shfl_xor_sync(0xffffffffu, pq, 2);
      const int row = wrow0 + m * 16 + h * 8 + g;
      if (tq == 0 && row < n_q) store(row, pq - v);
    }
  }
}

// Layout check: out[i, j] = popc(q_i & t_j) of rows [0, 64) of q and t, by one
// warp with the fragment loads and the mma of nearest_valid_distance.
__device__ __forceinline__ void tile_product_64(const uint32_t* __restrict__ q,
                                                const uint32_t* __restrict__ t,
                                                int* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  for (int m = 0; m < 4; ++m) {
    const uint2 w0 = row_slices(q, m * 16 + g, tq);
    const uint2 w1 = row_slices(q, m * 16 + g + 8, tq);
    for (int nt = 0; nt < 8; ++nt) {
      const uint2 b = row_slices(t, nt * 8 + g, tq);
      int acc[4];
      mma_b1(acc, w0.x, w1.x, w0.y, w1.y, b.x, b.y, 0, 0, 0, 0);
      int* o = out + (m * 16 + g) * 64 + nt * 8 + 2 * tq;
      o[0] = acc[0];
      o[1] = acc[1];
      o[8 * 64] = acc[2];
      o[8 * 64 + 1] = acc[3];
    }
  }
}

}  // namespace hamming_mma
