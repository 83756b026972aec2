// Good-match counts of band tiles: for an explicit list of (query block,
// target block) frame tiles, and for every query frame q and target frame t
// of a tile, the Version-A rule over the frames' 256-bit descriptors
//   d1[i]   = min over valid target rows j of hamming(q_i, t_j)
//   row_ok  = valid_q[i] & d1[i] < 257
//   dmin    = min(row_ok ? d1 : 512)
//   thr     = max(dmin * scale, 30)                  (float32)
//   count   = sum(row_ok & d1 < thr)
// written to out[p, q, t] (int32). The finalize runs in the kernel.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _band_d1_kernel
// (via banded_pair_counts_fused, with the finalize XLA ran after it) AND
// _band_counts_kernel (via band_count_tiles_fused, finalize in kernel). Both
// compute the same counts; the TPU needed two kernels for its VMEM budgets.
// Target validity is explicit (the TPU's zero-row convention is not needed).
//
// Design: one block of 256 threads per (tile, query frame, target frame).
// The distances come from the tensor cores' b1 and-popc product on the packed
// words (hamming_mma.cuh, nearest_valid_distance): the block walks the query
// frame in slabs of 1,024 rows, each against all target rows, and the per-row
// minima go to shared memory for the block's finalize. An invalid target row
// reads d + 512, so it never wins a row minimum that can pass d1 < 257.
//
// Bound on the H100: the tensor cores' b1 rate (see hamming_mma.cuh); the
// band of 96 frames x 2000 descriptors in 16-frame tiles is ~15 G row pairs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hamming_mma.cuh"

namespace {

using hamming_mma::kThreads;

template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  for (int i = 1; i < kThreads / 32; ++i) v = op(v, scratch[i]);
  return v;
}

struct MinOp {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// packed: [frames, n, 8] words; valid: [frames, n] uint8
__global__ void __launch_bounds__(kThreads, hamming_mma::kMinBlocks)
band_counts_kernel(const uint32_t* __restrict__ packed,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ qidx, const int* __restrict__ tidx,
                   int* __restrict__ out, int n, int block, float scale) {
  __shared__ __align__(16) unsigned char smem[hamming_mma::kSmemBytes];
  __shared__ int scratch[kThreads / 32];
  extern __shared__ int d1s[];  // [n] per-query-row nearest distance

  const int tf = blockIdx.x % block;
  const int qf = (blockIdx.x / block) % block;
  const int p = blockIdx.x / (block * block);
  const size_t qframe = static_cast<size_t>(qidx[p]) * block + qf;
  const size_t tframe = static_cast<size_t>(tidx[p]) * block + tf;
  const uint8_t* qv = valid + qframe * n;
  const int tid = threadIdx.x;

  int* d1 = d1s;
  for (int base = 0; base < n; base += hamming_mma::kSlab)
    hamming_mma::nearest_valid_distance(
        packed + qframe * n * 8, n, base, packed + tframe * n * 8,
        valid + tframe * n, 0, n, smem,
        [d1](int row, int d) { d1[row] = d; });
  __syncthreads();

  int mn = 512;
  for (int row = tid; row < n; row += kThreads)
    if (qv[row] && d1s[row] < 257) mn = min(mn, d1s[row]);
  const int dmin = block_reduce(mn, scratch, MinOp());
  const float thr = fmaxf(__fmul_rn(static_cast<float>(dmin), scale), 30.f);
  int cnt = 0;
  for (int row = tid; row < n; row += kThreads) {
    const int d = d1s[row];
    cnt += (qv[row] && d < 257 && static_cast<float>(d) < thr) ? 1 : 0;
  }
  cnt = block_reduce(cnt, scratch, AddOp());
  if (tid == 0) out[blockIdx.x] = cnt;
}

}  // namespace

extern "C" int slam_band_count_tiles(const void* packed, const void* valid,
                                     const void* qidx, const void* tidx,
                                     void* out, int p_cnt, int n, int block,
                                     float scale, void* stream);

// Counts of an explicit list of frame PAIRS (qidx[p], tidx[p]): the tiles
// above with block = 1, one CUDA block per pair, out[p] the pair's count.
// Replaces: pallas_kernels.py, _pair_d1_kernel (via block_pair_counts_fused,
// [Fq] x [Ft] frames with the finalize XLA ran after it) — the live loop
// scan of one frame against the frame database. Frames are addressed in
// place, so the scan reads the database without a copy.
extern "C" int slam_pair_counts(const void* packed, const void* valid,
                                const void* qidx, const void* tidx, void* out,
                                int p_cnt, int n, float scale, void* stream) {
  return slam_band_count_tiles(packed, valid, qidx, tidx, out, p_cnt, n, 1,
                               scale, stream);
}

extern "C" int slam_band_count_tiles(const void* packed, const void* valid,
                                     const void* qidx, const void* tidx,
                                     void* out, int p_cnt, int n, int block,
                                     float scale, void* stream) {
  const long long blocks = static_cast<long long>(p_cnt) * block * block;
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  if (blocks > 0) {
    // above 48 KB of dynamic shared memory (n > ~7.4k rows with the static
    // 18.5 KB of staging) the kernel must opt in; past the card's limit the
    // launch fails and the error is returned
    cudaFuncSetAttribute(band_counts_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    band_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const uint8_t*>(valid),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx),
        static_cast<int*>(out), n, block, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
