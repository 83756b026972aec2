// Kernel I (hamming_d1_kernel). d1-only Hamming nearest neighbour over
// 256-bit descriptors packed as eight 32-bit words, for a list of frame
// pairs: for pair p and every query row i of frame qidx[p],
//   d1[p, i] = min_j hamming(q_i, t_j)   over the valid rows j of frame tidx[p]
// and 2^30 where the target frame has no valid row. No index, and no query
// validity: the caller's count rule applies it.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _hamming_d1_kernel
// (via hamming_nn_d1 and good_count_pair_pallas). The TPU kernel took the
// maximum of the raw +-1 int8 dot on its matrix unit, one frame pair per
// call; here the distances are XOR + __popc on the packed words and the pair
// list indexes the descriptor stores in place, so the dense all-pairs scan
// of a sequence is one launch per chunk of pairs with no gathered copy.
//
// Design: the band-count kernel's inner loop without its finalize. One block
// of 256 threads per (pair, slab of 2048 query rows, split of the target
// rows). Each thread holds 8 query rows in registers; the block stages 512
// target rows (16 KB) at a time in shared memory and every staged row (two
// 16-byte broadcast loads) serves the thread's 8 query rows. An invalid
// target row adds 512 to its distances, so it never wins a minimum below
// 257. With many pairs (the dense scan) there is one split and the block
// writes d1 itself. With few pairs (one 8192 x 8192 call is 4 slabs) the
// target rows are split over blocks to fill the card; each split writes its
// minima to a scratch buffer and a second small kernel takes the minimum
// over splits. No atomics: the result is deterministic and bitwise equal to
// the plain version.
//
// Bound on the H100: integer issue rate, as the band-count kernel (8 XOR, 8
// POPC at quarter rate, 8 adds and a min per row pair). Later work: the +-1
// int8 form on the tensor cores (wgmma s8, int32 accumulation, exact).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;       // query rows per thread
constexpr int kChunk = 512;    // target rows staged per pass
constexpr int kPenalty = 512;  // added to distances to invalid target rows
constexpr int kBig = 1 << 30;  // d1 of a row with no valid target

__device__ __forceinline__ int ham(const uint4& qa, const uint4& qb,
                                   const uint4& ta, const uint4& tb) {
  return __popc(qa.x ^ ta.x) + __popc(qa.y ^ ta.y) + __popc(qa.z ^ ta.z) +
         __popc(qa.w ^ ta.w) + __popc(qb.x ^ tb.x) + __popc(qb.y ^ tb.y) +
         __popc(qb.z ^ tb.z) + __popc(qb.w ^ tb.w);
}

// q: [fq, n_q, 2] uint4 (8 words per row); t: [ft, n_t, 2] uint4;
// vt: [ft, n_t] uint8; qidx, tidx: [p] int32; out: [splits, p, n_q] int32.
// blockIdx.x = (pair * slabs + slab) * splits + split; split s scans target
// rows [s * split_len, min(n_t, (s + 1) * split_len)).
__global__ void __launch_bounds__(kThreads)
hamming_d1_kernel(const uint4* __restrict__ q, const uint4* __restrict__ t,
                  const uint8_t* __restrict__ vt,
                  const int* __restrict__ qidx, const int* __restrict__ tidx,
                  int* __restrict__ out, int p_cnt, int n_q, int n_t,
                  int slabs, int splits, int split_len) {
  __shared__ uint4 st[kChunk][2];
  __shared__ int spen[kChunk];

  const int split = blockIdx.x % splits;
  const int slab = (blockIdx.x / splits) % slabs;
  const int pair = blockIdx.x / (splits * slabs);
  const uint4* qf = q + static_cast<size_t>(qidx[pair]) * n_q * 2;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  const uint4* tf = t + t_base * 2;
  const uint8_t* tv = vt + t_base;
  const int tid = threadIdx.x;
  const int base = slab * kThreads * kRows;
  const int t_begin = split * split_len;
  const int t_end = min(n_t, t_begin + split_len);

  uint4 qa[kRows], qb[kRows];
  int best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads + tid;
    const bool in = row < n_q;
    qa[r] = in ? qf[2 * row] : make_uint4(0, 0, 0, 0);
    qb[r] = in ? qf[2 * row + 1] : make_uint4(0, 0, 0, 0);
    best[r] = 1 << 20;
  }
  for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = tid; j < kChunk && t0 + j < t_end; j += kThreads) {
      st[j][0] = tf[2 * (t0 + j)];
      st[j][1] = tf[2 * (t0 + j) + 1];
      spen[j] = tv[t0 + j] ? 0 : kPenalty;
    }
    __syncthreads();
    const int cnt = min(kChunk, t_end - t0);
    for (int j = 0; j < cnt; ++j) {
      const uint4 ta = st[j][0], tb = st[j][1];
      const int pen = spen[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        best[r] = min(best[r], ham(qa[r], qb[r], ta, tb) + pen);
    }
  }
  int* o = out + (static_cast<size_t>(split) * p_cnt + pair) * n_q;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = base + r * kThreads + tid;
    if (row < n_q) o[row] = best[r] < 257 ? best[r] : kBig;
  }
}

// out[i] = min over s of partial[s, i], i < total
__global__ void __launch_bounds__(kThreads)
min_over_splits_kernel(const int* __restrict__ partial, int* __restrict__ out,
                       long long total, int splits) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  int v = partial[i];
  for (int s = 1; s < splits; ++s) v = min(v, partial[s * total + i]);
  out[i] = v;
}

}  // namespace

// d1 [p, n_q] of the frame pairs (qidx[p], tidx[p]). With splits == 1 the
// kernel writes d1 and `partial` is not read; with splits > 1 `partial` is a
// [splits, p, n_q] int32 scratch buffer the caller allocated.
extern "C" int slam_hamming_d1(const void* q, const void* t, const void* vt,
                               const void* qidx, const void* tidx, void* d1,
                               void* partial, int p, int n_q, int n_t,
                               int splits, void* stream) {
  if (p > 0 && n_q > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int slabs = (n_q + kThreads * kRows - 1) / (kThreads * kRows);
    if (splits < 1) splits = 1;
    const int split_len = (n_t + splits - 1) / splits;
    const long long blocks = static_cast<long long>(p) * slabs * splits;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    int* dst = static_cast<int*>(splits > 1 ? partial : d1);
    hamming_d1_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint4*>(q), static_cast<const uint4*>(t),
        static_cast<const uint8_t*>(vt), static_cast<const int*>(qidx),
        static_cast<const int*>(tidx), dst, p, n_q, n_t, slabs, splits,
        split_len);
    if (splits > 1) {
      const long long total = static_cast<long long>(p) * n_q;
      const long long rb = (total + kThreads - 1) / kThreads;
      min_over_splits_kernel<<<static_cast<unsigned>(rb), kThreads, 0, s>>>(
          static_cast<const int*>(partial), static_cast<int*>(d1), total,
          splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
