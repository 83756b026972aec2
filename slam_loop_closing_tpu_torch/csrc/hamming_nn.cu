// Two Hamming nearest-neighbour kernels over 256-bit descriptors packed as
// eight 32-bit words.
//
// Kernel D (hamming_nn_kernel). Hamming nearest neighbour: for every query
// row i of M 256-bit
// descriptors, the valid target row j of N that minimises hamming(q_i, t_j),
// the lowest such j on ties:
//   d1[i]  = min_j hamming(q_i, t_j)        over valid targets j
//   idx[i] = the lowest j that reaches d1[i]
// An invalid query row, or one with no valid target at all, gets
// d1 = 2^30 and idx 0 (the JAX package's reference path: distances of
// masked pairs are 2^30 and argmin takes the first minimum).
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _hamming_nn_kernel
// (via hamming_nn). The TPU kernel ran the +-1 int8 product on its matrix
// unit and left invalid query rows unmasked; here query validity is applied
// in the kernel.
//
// Design: one warp per query row, 8 rows per block of 256 threads, so the
// M = 2000 rows of a frame spread over 250 blocks (all 132 SMs) instead of
// one. The block stages 512 target rows (16 KB of packed words) at a time
// in shared memory for its 8 warps; lane l scans targets l, l+32, ... in
// increasing order with a strict '<', so its minimum carries its lowest
// index, and a shuffle reduction over (distance, index) pairs keeps the
// lowest index among equal distances. No atomics: the result is
// deterministic.
//
// Bound on the H100: at a frame pair of 2000 x 2000 rows the integer work
// (8 XOR + 8 POPC + adds per row pair, 4 M pairs) is small; the launch and
// the single pass over the staged targets dominate. Later work: several
// query rows per warp held in registers (kernel C's scheme) or the +-1 int8
// form on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // query rows per block
constexpr int kChunk = 512;            // target rows staged per pass
constexpr int kBig = 1 << 30;          // distance of a masked pair

__device__ __forceinline__ int ham(const uint4& qa, const uint4& qb,
                                   const uint4& ta, const uint4& tb) {
  return __popc(qa.x ^ ta.x) + __popc(qa.y ^ ta.y) + __popc(qa.z ^ ta.z) +
         __popc(qa.w ^ ta.w) + __popc(qb.x ^ tb.x) + __popc(qb.y ^ tb.y) +
         __popc(qb.z ^ tb.z) + __popc(qb.w ^ tb.w);
}

// q: [m, 2] uint4 (8 words per row); t: [n, 2] uint4; vq: [m], vt: [n] uint8
__global__ void __launch_bounds__(kThreads)
hamming_nn_kernel(const uint4* __restrict__ q, const uint4* __restrict__ t,
                  const uint8_t* __restrict__ vq,
                  const uint8_t* __restrict__ vt, int* __restrict__ d1,
                  int* __restrict__ idx, int m, int n) {
  __shared__ uint4 st[kChunk][2];
  __shared__ uint8_t sv[kChunk];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  // every thread stays for the block's barriers; inactive rows only skip
  // the scan
  const bool active = row < m && vq[row] != 0;
  uint4 qa = make_uint4(0, 0, 0, 0), qb = make_uint4(0, 0, 0, 0);
  if (active) {
    qa = q[2 * row];
    qb = q[2 * row + 1];
  }
  int best = kBig, best_j = 0;
  for (int t0 = 0; t0 < n; t0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < kChunk && t0 + j < n; j += kThreads) {
      st[j][0] = t[2 * (t0 + j)];
      st[j][1] = t[2 * (t0 + j) + 1];
      sv[j] = vt[t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kChunk, n - t0);
    for (int j = lane; j < cnt; j += 32) {
      if (!sv[j]) continue;
      const int d = ham(qa, qb, st[j][0], st[j][1]);
      if (d < best) {
        best = d;
        best_j = t0 + j;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
    if (ob < best || (ob == best && oj < best_j)) {
      best = ob;
      best_j = oj;
    }
  }
  if (lane == 0 && row < m) {
    d1[row] = best;
    idx[row] = best_j;
  }
}

// q: [fq, n_q, 2] uint4; t: [ft, n_t, 2] uint4; vq: [fq, n_q], vt: [ft, n_t]
// uint8; qidx, tidx: [p] int32; d1, idx, d2: [p, n_q] int32. Block b
// handles rows (b % row_blocks) * kWarps ... of pair b / row_blocks.
__global__ void __launch_bounds__(kThreads)
hamming_knn2_kernel(const uint4* __restrict__ q, const uint4* __restrict__ t,
                    const uint8_t* __restrict__ vq,
                    const uint8_t* __restrict__ vt,
                    const int* __restrict__ qidx, const int* __restrict__ tidx,
                    int* __restrict__ d1, int* __restrict__ idx,
                    int* __restrict__ d2, int n_q, int n_t, int row_blocks) {
  __shared__ uint4 st[kChunk][2];
  __shared__ uint8_t sv[kChunk];
  const int pair = blockIdx.x / row_blocks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = (blockIdx.x % row_blocks) * kWarps + warp;
  const size_t q_base = static_cast<size_t>(qidx[pair]) * n_q;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  // every thread stays for the block's barriers; inactive rows only skip
  // the scan
  const bool active = row < n_q && vq[q_base + row] != 0;
  uint4 qa = make_uint4(0, 0, 0, 0), qb = make_uint4(0, 0, 0, 0);
  if (active) {
    qa = q[2 * (q_base + row)];
    qb = q[2 * (q_base + row) + 1];
  }
  int b1 = kBig, j1 = 0, b2 = kBig;
  for (int t0 = 0; t0 < n_t; t0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < kChunk && t0 + j < n_t; j += kThreads) {
      st[j][0] = t[2 * (t_base + t0 + j)];
      st[j][1] = t[2 * (t_base + t0 + j) + 1];
      sv[j] = vt[t_base + t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kChunk, n_t - t0);
    for (int j = lane; j < cnt; j += 32) {
      if (!sv[j]) continue;
      const int d = ham(qa, qb, st[j][0], st[j][1]);
      if (d < b1) {
        b2 = b1;
        b1 = d;
        j1 = t0 + j;
      } else if (d < b2) {
        b2 = d;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int ob1 = __shfl_xor_sync(0xffffffffu, b1, o);
    const int oj1 = __shfl_xor_sync(0xffffffffu, j1, o);
    const int ob2 = __shfl_xor_sync(0xffffffffu, b2, o);
    if (ob1 < b1 || (ob1 == b1 && oj1 < j1)) {
      b2 = min(ob2, b1);
      b1 = ob1;
      j1 = oj1;
    } else {
      b2 = min(b2, ob1);
    }
  }
  if (lane == 0 && row < n_q) {
    const size_t o = static_cast<size_t>(pair) * n_q + row;
    d1[o] = b1;
    idx[o] = j1;
    d2[o] = b2;
  }
}

}  // namespace

extern "C" int slam_hamming_knn2(const void* q, const void* t, const void* vq,
                                 const void* vt, const void* qidx,
                                 const void* tidx, void* d1, void* idx,
                                 void* d2, int p, int n_q, int n_t,
                                 void* stream) {
  if (p > 0 && n_q > 0) {
    const int row_blocks = (n_q + kWarps - 1) / kWarps;
    const unsigned blocks = static_cast<unsigned>(p) *
                            static_cast<unsigned>(row_blocks);
    hamming_knn2_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(q), static_cast<const uint4*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx),
        static_cast<int*>(d1), static_cast<int*>(idx), static_cast<int*>(d2),
        n_q, n_t, row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slam_hamming_nn(const void* q, const void* t, const void* vq,
                               const void* vt, void* d1, void* idx, int m,
                               int n, void* stream) {
  if (m > 0) {
    const unsigned blocks = static_cast<unsigned>((m + kWarps - 1) / kWarps);
    hamming_nn_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(q), static_cast<const uint4*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<int*>(d1), static_cast<int*>(idx), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}
