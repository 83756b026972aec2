// Probe of the tensor-core forms of the Hamming nearest-neighbour inner loop:
// the d1-only kernel over a pair list, once per form; the raw [64, 64] tile
// product of each mma for a layout check; the rate of each mma alone.
// Form 3 is the one the library uses (csrc/hamming_mma.cuh); forms 0, 1 and 2
// lost the probe and live only here. Built and timed by
// probe_hamming_forms.py; not part of the library.
//
// Also the forms of kernel F's top-2 with index (csrc/hamming_knn2.cuh),
// one launch over a pair list without a target split: the keyed epilogue
// at 1, 2 (the library's), 4 and 8 query tiles a warp, and the branchy
// (d1, idx, d2) epilogue of the pre-tensor-core kernel at 2. Timed by
// probe_support_knn2.py.

#include "hamming_knn2.cuh"
#include "hamming_mma.cuh"

namespace {

using namespace hamming_mma;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four +-1 bytes from bits j, 8 + j, 16 + j, 24 + j of w: 0 -> +1, 1 -> -1
// (the same map on both operands, so dot = 256 - 2 d)
__device__ __forceinline__ uint32_t pm1(uint32_t w, int j) {
  return ((w >> j) & 0x01010101u) * 0xFEu + 0x01010101u;
}

__device__ __forceinline__ int max3(int a, int b, int c) {
  return max(a, max(b, c));
}

// Form 3: the library's
struct FormLib {
  static constexpr int kMinBlocks = hamming_mma::kMinBlocks;
  static constexpr int kSlab = hamming_mma::kSlab;
  static constexpr int kSmemBytes = hamming_mma::kSmemBytes;
  template <class Store>
  static __device__ __forceinline__ void nearest(
      const uint32_t* __restrict__ q, int n_q, int row0,
      const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
      int t_begin, int t_end, unsigned char* smem, Store store) {
    nearest_valid_distance(q, n_q, row0, t, tv, t_begin, t_end, smem, store);
  }
};

// Form 1 (b1, one mma, rows in place): the accumulator starts at 0 and the
// epilogue takes 2 acc - col against the column's popc(t) (+ 512 for an
// invalid row) before the running maximum.
struct FormB1 {
  static constexpr int kMinBlocks = 1;
  static constexpr int kSlab = hamming_mma::kSlab;
  static constexpr int kSmemBytes = hamming_mma::kSmemBytes;
  template <class Store>
  static __device__ __forceinline__ void nearest(
      const uint32_t* __restrict__ q, int n_q, int row0,
      const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
      int t_begin, int t_end, unsigned char* smem, Store store) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    uint4* srows = reinterpret_cast<uint4*>(smem);         // [kChunk][2]
    int* scol = reinterpret_cast<int*>(smem + kChunk * 32);  // popc(t) + penalty

    const int wrow0 = row0 + warp * kTiles * 16;
    // tiles of this warp that hold a query row; none: the warp only stages
    const int tiles = min(kTiles, (n_q - wrow0 + 15) / 16);

    uint32_t a[kTiles][4];
    int run[kTiles][2];
  #pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
      const uint2 w0 = r0 < n_q ? row_slices(q, r0, tq) : make_uint2(0, 0);
      const uint2 w1 = r1 < n_q ? row_slices(q, r1, tq) : make_uint2(0, 0);
      a[m][0] = w0.x;
      a[m][1] = w1.x;
      a[m][2] = w0.y;
      a[m][3] = w1.y;
      run[m][0] = kNone;
      run[m][1] = kNone;
    }

    // staging: kChunk rows x 2 halves of 16 bytes = 4 items a thread
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
    for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer being read
  #pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tid + k * kThreads;
        srows[i] = pre[k];
        int p = __popc(pre[k].x) + __popc(pre[k].y) + __popc(pre[k].z) +
                __popc(pre[k].w);
        p += __shfl_xor_sync(0xffffffffu, p, 1);  // the row's other half
        if ((i & 1) == 0) scol[i >> 1] = p + (pvalid[k] ? 0 : kPenalty);
      }
      __syncthreads();
      if (t0 + kChunk < t_end) fetch(t0 + kChunk);
      if (tiles <= 0) continue;
      const int ntiles = (min(kChunk, t_end - t0) + 7) >> 3;
      const uint2* swords = reinterpret_cast<const uint2*>(smem);
      for (int nt = 0; nt < ntiles; ++nt) {
        const uint2 b = swords[nt * 32 + lane];  // row nt * 8 + g, slices of tq
        const int2 col = *reinterpret_cast<const int2*>(scol + nt * 8 + 2 * tq);
  #pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          if (m < tiles) {
            int acc[4];
            mma_b1(acc, a[m][0], a[m][1], a[m][2], a[m][3], b.x, b.y, 0, 0, 0,
                   0);
            run[m][0] = max(run[m][0],
                            max(2 * acc[0] - col.x, 2 * acc[1] - col.y));
            run[m][1] = max(run[m][1],
                            max(2 * acc[2] - col.x, 2 * acc[3] - col.y));
          }
        }
      }
    }
  #pragma unroll
    for (int m = 0; m < kTiles; ++m) {
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = run[m][h];
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
};

// Form 0 (s8): the bits become +-1 int8 and the product runs as
// mma.sync.m16n8k32.s8.s8.s32. A warp keeps 64 query rows as fragments in
// registers (128 registers a thread); the block unpacks 128 target rows at a
// time into shared memory. Lane (g, t) owns a 64-byte segment of every
// unpacked row (the 8 shifts of source words 2t and 2t + 1), stored as four
// 16-byte chunks XOR-swizzled by the row's parity, so a quarter-warp's
// 128-bit loads hit eight different bank groups; each load serves the warp's
// four query tiles. An invalid column starts at -1024: (256 - dot) / 2 reads
// d + 512.
struct FormA {
  static constexpr int kMinBlocks = 1;
  static constexpr int kTiles = 4;
  static constexpr int kSlab = kWarps * kTiles * 16;
  static constexpr int kChunk = 128;
  static constexpr int kSmemBytes = kChunk * 256 + kChunk * 4;

  template <class Store>
  static __device__ __forceinline__ void nearest(
      const uint32_t* __restrict__ q, int n_q, int row0,
      const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
      int t_begin, int t_end, unsigned char* smem, Store store) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    uint4* srows = reinterpret_cast<uint4*>(smem);  // [kChunk][16] chunks
    int* sbias = reinterpret_cast<int*>(smem + kChunk * 256);

    const int wrow0 = row0 + warp * kTiles * 16;
    const int tiles = min(kTiles, (n_q - wrow0 + 15) / 16);

    uint32_t a[kTiles][8][4];
    int run[kTiles][2];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
      const uint2 w0 = r0 < n_q ? row_slices(q, r0, tq) : make_uint2(0, 0);
      const uint2 w1 = r1 < n_q ? row_slices(q, r1, tq) : make_uint2(0, 0);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint32_t s0 = ks < 4 ? w0.x : w0.y, s1 = ks < 4 ? w1.x : w1.y;
        const int j = (2 * ks) & 7;
        a[m][ks][0] = pm1(s0, j);
        a[m][ks][1] = pm1(s1, j);
        a[m][ks][2] = pm1(s0, j + 1);
        a[m][ks][3] = pm1(s1, j + 1);
      }
      run[m][0] = kNone;
      run[m][1] = kNone;
    }

    // staging: kChunk rows x 8 source words = 4 items a thread
    uint32_t pre[4];
    int pbias = 0;
    auto fetch = [&](int t0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tid + k * kThreads, row = t0 + (i >> 3);
        pre[k] = row < t_end ? t[static_cast<size_t>(row) * 8 + (i & 7)] : 0u;
      }
      if (tid < kChunk)
        pbias = (t0 + tid < t_end && tv[t0 + tid]) ? 0 : -2 * kPenalty;
    };
    fetch(t_begin);
    for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tid + k * kThreads, row = i >> 3, w = i & 7;
        const uint32_t s = pre[k];
        const int c0 = 2 * (w & 1), seg = w >> 1, swz = (row & 1) << 2;
        srows[row * 16 + ((c0 * 4 + seg) ^ swz)] =
            make_uint4(pm1(s, 0), pm1(s, 1), pm1(s, 2), pm1(s, 3));
        srows[row * 16 + (((c0 + 1) * 4 + seg) ^ swz)] =
            make_uint4(pm1(s, 4), pm1(s, 5), pm1(s, 6), pm1(s, 7));
      }
      if (tid < kChunk) sbias[tid] = pbias;
      __syncthreads();
      if (t0 + kChunk < t_end) fetch(t0 + kChunk);
      if (tiles <= 0) continue;
      const int ntiles = (min(kChunk, t_end - t0) + 7) >> 3;
      for (int nt = 0; nt < ntiles; ++nt) {
        const int row = nt * 8 + g;
        const uint4* rp = srows + row * 16;
        const int swz = (row & 1) << 2;
        const int2 bias =
            *reinterpret_cast<const int2*>(sbias + nt * 8 + 2 * tq);
        int acc[kTiles][4];
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          acc[m][0] = bias.x;
          acc[m][1] = bias.y;
          acc[m][2] = bias.x;
          acc[m][3] = bias.y;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 v = rp[(c * 4 + tq) ^ swz];
#pragma unroll
          for (int m = 0; m < kTiles; ++m)
            if (m < tiles) mma_s8(acc[m], a[m][2 * c], v.x, v.y);
#pragma unroll
          for (int m = 0; m < kTiles; ++m)
            if (m < tiles) mma_s8(acc[m], a[m][2 * c + 1], v.z, v.w);
        }
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          run[m][0] = max3(run[m][0], acc[m][0], acc[m][1]);
          run[m][1] = max3(run[m][1], acc[m][2], acc[m][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = run[m][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int row = wrow0 + m * 16 + h * 8 + g;
        if (tq == 0 && row < n_q) store(row, (256 - v) >> 1);
      }
    }
  }
};

// Form 2 (b1, two mma): 256 - d = popc(q & t) + popc(~q & ~t); an invalid
// column starts at -512 and the epilogue is a maximum only.
struct FormB2 {
  static constexpr int kMinBlocks = 1;
  static constexpr int kTiles = hamming_mma::kTiles;
  static constexpr int kSlab = hamming_mma::kSlab;
  static constexpr int kChunk = hamming_mma::kChunk;
  static constexpr int kSmemBytes = hamming_mma::kSmemBytes;

  template <class Store>
  static __device__ __forceinline__ void nearest(
      const uint32_t* __restrict__ q, int n_q, int row0,
      const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
      int t_begin, int t_end, unsigned char* smem, Store store) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    uint4* srows = reinterpret_cast<uint4*>(smem);
    int* sbias = reinterpret_cast<int*>(smem + kChunk * 32);

    const int wrow0 = row0 + warp * kTiles * 16;
    const int tiles = min(kTiles, (n_q - wrow0 + 15) / 16);

    uint32_t a[kTiles][4];
    int run[kTiles][2];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
      const uint2 w0 = r0 < n_q ? row_slices(q, r0, tq) : make_uint2(0, 0);
      const uint2 w1 = r1 < n_q ? row_slices(q, r1, tq) : make_uint2(0, 0);
      a[m][0] = w0.x;
      a[m][1] = w1.x;
      a[m][2] = w0.y;
      a[m][3] = w1.y;
      run[m][0] = kNone;
      run[m][1] = kNone;
    }

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
    for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tid + k * kThreads;
        srows[i] = pre[k];
        if ((i & 1) == 0) sbias[i >> 1] = pvalid[k] ? 0 : -kPenalty;
      }
      __syncthreads();
      if (t0 + kChunk < t_end) fetch(t0 + kChunk);
      if (tiles <= 0) continue;
      const int ntiles = (min(kChunk, t_end - t0) + 7) >> 3;
      const uint2* swords = reinterpret_cast<const uint2*>(smem);
      for (int nt = 0; nt < ntiles; ++nt) {
        const uint2 b = swords[nt * 32 + lane];
        const int2 c = *reinterpret_cast<const int2*>(sbias + nt * 8 + 2 * tq);
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          if (m < tiles) {
            int acc[4];
            mma_b1(acc, a[m][0], a[m][1], a[m][2], a[m][3], b.x, b.y, c.x,
                   c.y, c.x, c.y);
            mma_b1(acc, ~a[m][0], ~a[m][1], ~a[m][2], ~a[m][3], ~b.x, ~b.y,
                   acc[0], acc[1], acc[2], acc[3]);
            run[m][0] = max3(run[m][0], acc[0], acc[1]);
            run[m][1] = max3(run[m][1], acc[2], acc[3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = run[m][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int row = wrow0 + m * 16 + h * 8 + g;
        if (tq == 0 && row < n_q) store(row, 256 - v);
      }
    }
  }
};

template <class Form>
__global__ void __launch_bounds__(kThreads, Form::kMinBlocks)
d1_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
          const uint8_t* __restrict__ vt, const int* __restrict__ qidx,
          const int* __restrict__ tidx, int* __restrict__ out, int p_cnt,
          int n_q, int n_t, int slabs, int splits, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x % splits;
  const int slab = (blockIdx.x / splits) % slabs;
  const int pair = blockIdx.x / (splits * slabs);
  const uint32_t* qf = q + static_cast<size_t>(qidx[pair]) * n_q * 8;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  int* o = out + (static_cast<size_t>(split) * p_cnt + pair) * n_q;
  const int t_begin = split * split_len;
  Form::nearest(qf, n_q, slab * Form::kSlab, t + t_base * 8, vt + t_base,
                t_begin, min(n_t, t_begin + split_len), smem,
                [o](int row, int d) { o[row] = d; });
}

template <class Form>
int launch(const void* q, const void* t, const void* vt, const void* qidx,
           const void* tidx, void* out, int p, int n_q, int n_t, int splits,
           void* stream) {
  const int slabs = (n_q + Form::kSlab - 1) / Form::kSlab;
  const int split_len = (n_t + splits - 1) / splits;
  cudaFuncSetAttribute(d1_kernel<Form>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Form::kSmemBytes);
  d1_kernel<Form><<<p * slabs * splits, kThreads, Form::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
      static_cast<const uint8_t*>(vt), static_cast<const int*>(qidx),
      static_cast<const int*>(tidx), static_cast<int*>(out), p, n_q, n_t,
      slabs, splits, split_len);
  return static_cast<int>(cudaGetLastError());
}

// the +-1 dot (256 - 2 d) of q rows [0, 64) with t rows [0, 64), one warp
__global__ void tile_s8_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ t,
                               int* __restrict__ out) {
  const int lane = threadIdx.x, g = lane >> 2, tq = lane & 3;
  for (int m = 0; m < 4; ++m) {
    const uint2 w0 = row_slices(q, m * 16 + g, tq);
    const uint2 w1 = row_slices(q, m * 16 + g + 8, tq);
    for (int nt = 0; nt < 8; ++nt) {
      const uint2 b = row_slices(t, nt * 8 + g, tq);
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint32_t s0 = ks < 4 ? w0.x : w0.y, s1 = ks < 4 ? w1.x : w1.y;
        const uint32_t sb = ks < 4 ? b.x : b.y;
        const int j = (2 * ks) & 7;
        const uint32_t a[4] = {pm1(s0, j), pm1(s1, j), pm1(s0, j + 1),
                               pm1(s1, j + 1)};
        mma_s8(acc, a, pm1(sb, j), pm1(sb, j + 1));
      }
      int* o = out + (m * 16 + g) * 64 + nt * 8 + 2 * tq;
      o[0] = acc[0];
      o[1] = acc[1];
      o[8 * 64] = acc[2];
      o[8 * 64 + 1] = acc[3];
    }
  }
}

__global__ void tile_b1_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ t,
                               int* __restrict__ out) {
  tile_product_64(q, t, out);
}

// instruction rate of one mma form with nothing else in the loop: every warp
// runs iters x 8 independent accumulator chains on register operands
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int form, int iters, int* __restrict__ out) {
  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t a[4] = {x, x * 3u, x * 5u, x * 7u};
  if (form == 2) {
    // the b1 mma with a fresh accumulator and the running-maximum epilogue
    // of the library's inner loop, still on register operands only
    int run[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) run[j][0] = run[j][1] = kNone;
    for (int i = 0; i < iters; ++i) {
      const int c0 = -i, c1 = i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int d[4];
        mma_b1(d, a[0] + j, a[1], a[2], a[3], x + i, x ^ j, c0, c1, c0, c1);
        run[j][0] = max3(run[j][0], d[0], d[1]);
        run[j][1] = max3(run[j][1], d[2], d[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = run[j][0] + run[j][1];
  } else if (form == 1) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_b1(acc[j], a[0], a[1], a[2], a[3], x + j, x ^ j, acc[j][0],
               acc[j][1], acc[j][2], acc[j][3]);
  } else {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc[j], a, x + j, x ^ j);
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

// kernel F's top-2 with the branchy epilogue of the pre-tensor-core
// kernel: hamming_knn2::top2_keys with its running (d1, idx, d2) as distance
// offsets popc(t) - 2 acc (a strict '<' over each lane's columns in
// increasing order), turned into keys at the end; 2 query tiles a warp
__device__ __forceinline__ void knn2_top2_branchy(
    const uint32_t* __restrict__ q, int n_q, int row0,
    const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv,
    int t_begin, int t_end, unsigned char* smem, int* __restrict__ d1,
    int* __restrict__ idx, int* __restrict__ d2, size_t o,
    const uint8_t* __restrict__ vq) {
  namespace hk = hamming_knn2;
  constexpr int kT = 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  uint4* swords = reinterpret_cast<uint4*>(smem);
  int* scol = reinterpret_cast<int*>(smem + hk::kStage * 32);
  const int wrow0 = row0 + warp * kT * 16;
  const bool idle = wrow0 >= n_q;
  uint32_t a[kT][4];
  int m1[kT][2], m2[kT][2], j1[kT][2];
#pragma unroll
  for (int m = 0; m < kT; ++m) {
    const int r0 = wrow0 + m * 16 + g, r1 = r0 + 8;
    const uint2 w0 =
        r0 < n_q ? hamming_mma::row_slices(q, r0, tq) : make_uint2(0, 0);
    const uint2 w1 =
        r1 < n_q ? hamming_mma::row_slices(q, r1, tq) : make_uint2(0, 0);
    a[m][0] = w0.x;
    a[m][1] = w1.x;
    a[m][2] = w0.y;
    a[m][3] = w1.y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // 1024 is above every valid offset and lands at kNoKey as a key
      m1[m][h] = m2[m][h] = 1024;
      j1[m][h] = 0;
    }
  }
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  for (int t0 = t_begin; t0 < t_end; t0 += hk::kStage) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < hk::kStage * 2 / hk::kThreads; ++k) {
      const int i = tid + k * hk::kThreads, row = t0 + (i >> 1);
      const bool in = row < t_end;
      const uint4 w = in ? t4[static_cast<size_t>(row) * 2 + (i & 1)]
                         : make_uint4(0, 0, 0, 0);
      int pc = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
      pc += __shfl_xor_sync(0xffffffffu, pc, 1);
      swords[i] = w;
      if ((i & 1) == 0)
        scol[i >> 1] =
            in && tv[row] ? (pc << hk::kIdxBits) + row : hk::kInvalidCol;
    }
    __syncthreads();
    if (idle) continue;
    const int tiles = (min(hk::kStage, t_end - t0) + 7) / 8;
    const uint2* sw2 = reinterpret_cast<const uint2*>(swords);
    const int2* sc2 = reinterpret_cast<const int2*>(scol);
#pragma unroll 2
    for (int nt = 0; nt < tiles; ++nt) {
      const uint2 b = sw2[nt * 32 + lane];
      const int2 c = sc2[nt * 4 + tq];
      const int p0 = c.x >> hk::kIdxBits, p1 = c.y >> hk::kIdxBits;
      const int col = t0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int m = 0; m < kT; ++m) {
        int acc[4];
        hamming_mma::mma_b1(acc, a[m][0], a[m][1], a[m][2], a[m][3], b.x,
                            b.y, 0, 0, 0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int v = ((e & 1) ? p1 : p0) - 2 * acc[e];
          if (v < m1[m][h]) {
            m2[m][h] = m1[m][h];
            m1[m][h] = v;
            j1[m][h] = col + (e & 1);
          } else if (v < m2[m][h]) {
            m2[m][h] = v;
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the lane's lowest index; d2's is moot
      int k1 = (m1[m][h] << hk::kIdxBits) + j1[m][h];
      int k2 = (m2[m][h] << hk::kIdxBits) + hk::kIdxMask;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        hk::merge2(k1, k2, __shfl_xor_sync(0xffffffffu, k1, off),
                   __shfl_xor_sync(0xffffffffu, k2, off));
      int pq = __popc(a[m][h]) + __popc(a[m][2 + h]);
      pq += __shfl_xor_sync(0xffffffffu, pq, 1);
      pq += __shfl_xor_sync(0xffffffffu, pq, 2);
      const int row = wrow0 + m * 16 + h * 8 + g;
      if (tq == 0 && row < n_q)
        hk::store(d1, idx, d2, o + row, vq[row] != 0,
                  k1 + (pq << hk::kIdxBits), k2 + (pq << hk::kIdxBits));
    }
  }
}

template <int kTiles, bool kBranchy>
__global__ void __launch_bounds__(kThreads)
knn2_form_kernel(const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ t,
                 const uint8_t* __restrict__ vq,
                 const uint8_t* __restrict__ vt,
                 const int* __restrict__ qidx, const int* __restrict__ tidx,
                 int* __restrict__ d1, int* __restrict__ idx,
                 int* __restrict__ d2, int n_q, int n_t, int slabs) {
  __shared__ __align__(16) unsigned char smem[hamming_knn2::kSmemBytes];
  const int slab = blockIdx.x % slabs, pair = blockIdx.x / slabs;
  const size_t q_base = static_cast<size_t>(qidx[pair]) * n_q;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  const size_t o = static_cast<size_t>(pair) * n_q;
  if constexpr (kBranchy)
    knn2_top2_branchy(q + q_base * 8, n_q, slab * hamming_knn2::kSlabRows<2>,
                      t + t_base * 8, vt + t_base, 0, n_t, smem, d1, idx, d2,
                      o, vq + q_base);
  else
    hamming_knn2::top2_keys<kTiles>(
        q + q_base * 8, n_q, slab * hamming_knn2::kSlabRows<kTiles>,
        t + t_base * 8, vt + t_base, 0, n_t, smem,
        [&](int row, int k1, int k2) {
          hamming_knn2::store(d1, idx, d2, o + row, vq[q_base + row] != 0,
                              k1, k2);
        });
}

template <int kTiles, bool kBranchy = false>
int launch_knn2(const void* q, const void* t, const void* vq, const void* vt,
                const void* qidx, const void* tidx, void* d1, void* idx,
                void* d2, int p, int n_q, int n_t, void* stream) {
  const int slabs = (n_q + hamming_knn2::kSlabRows<kTiles> - 1) /
                    hamming_knn2::kSlabRows<kTiles>;
  knn2_form_kernel<kTiles, kBranchy>
      <<<p * slabs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
          static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
          static_cast<const int*>(qidx), static_cast<const int*>(tidx),
          static_cast<int*>(d1), static_cast<int*>(idx),
          static_cast<int*>(d2), n_q, n_t, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kernel F's forms, no target split: 0, 1, 2, 3: keyed epilogue at 1, 2
// (the library's), 4, 8 query tiles a warp; 4: branchy epilogue at 2.
// d1, idx, d2: [p, n_q] int32.
extern "C" int probe_knn2(int form, const void* q, const void* t,
                          const void* vq, const void* vt, const void* qidx,
                          const void* tidx, void* d1, void* idx, void* d2,
                          int p, int n_q, int n_t, void* stream) {
  switch (form) {
    case 0:
      return launch_knn2<1>(q, t, vq, vt, qidx, tidx, d1, idx, d2, p, n_q,
                            n_t, stream);
    case 1:
      return launch_knn2<2>(q, t, vq, vt, qidx, tidx, d1, idx, d2, p, n_q,
                            n_t, stream);
    case 2:
      return launch_knn2<4>(q, t, vq, vt, qidx, tidx, d1, idx, d2, p, n_q,
                            n_t, stream);
    case 3:
      return launch_knn2<8>(q, t, vq, vt, qidx, tidx, d1, idx, d2, p, n_q,
                            n_t, stream);
    default:
      return launch_knn2<2, true>(q, t, vq, vt, qidx, tidx, d1, idx, d2, p,
                                  n_q, n_t, stream);
  }
}

// form 0: s8; 1: b1 with one mma, rows in place; 2: b1 with two mma; 3: the
// library's (b1, one mma, rows compacted by parity). out: [splits, p, n_q].
extern "C" int probe_hamming_d1(int form, const void* q, const void* t,
                                const void* vt, const void* qidx,
                                const void* tidx, void* out, int p, int n_q,
                                int n_t, int splits, void* stream) {
  if (form == 0)
    return launch<FormA>(q, t, vt, qidx, tidx, out, p, n_q, n_t, splits,
                         stream);
  if (form == 1)
    return launch<FormB1>(q, t, vt, qidx, tidx, out, p, n_q, n_t, splits,
                          stream);
  if (form == 2)
    return launch<FormB2>(q, t, vt, qidx, tidx, out, p, n_q, n_t, splits,
                          stream);
  return launch<FormLib>(q, t, vt, qidx, tidx, out, p, n_q, n_t, splits,
                         stream);
}

// form 0: the +-1 dot; 1: popc(q & t). out: [64, 64] int32.
extern "C" int probe_tile_product(int form, const void* q, const void* t,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint32_t* tt = static_cast<const uint32_t*>(t);
  if (form == 0)
    tile_s8_kernel<<<1, 32, 0, s>>>(qq, tt, static_cast<int*>(out));
  else
    tile_b1_kernel<<<1, 32, 0, s>>>(qq, tt, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: [blocks * 256] int32; every warp runs iters * 8 mma
extern "C" int probe_mma_rate(int form, int blocks, int iters, void* out,
                              void* stream) {
  mma_rate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      form, iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
