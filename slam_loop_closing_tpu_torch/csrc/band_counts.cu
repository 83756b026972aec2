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
// Descriptors are packed 8 x 32-bit words; each thread holds 8 query rows
// in registers, the block stages 512 target rows (16 KB) at a time in shared
// memory, and every staged row (two 16-byte broadcast loads) serves the 8
// query rows: XOR + __popc, exact integer distances. An invalid target row
// adds 512 to its distances, so it never wins a row minimum that can pass
// d1 < 257. Per-row minima go to shared memory for the block's finalize.
//
// Bound on the H100: integer issue rate. Every pair of rows costs 8 XOR, 8
// POPC (quarter-rate on Hopper), 8 adds and a min; the band of 96 frames x
// 2000 descriptors in 16-frame tiles is ~15 G row pairs. Later work: the
// +-1 int8 form on the tensor cores (mma.sync / wgmma s8 with int32
// accumulation, exact), which the TPU kernels used on its matrix unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;       // query rows per thread per pass
constexpr int kChunk = 512;    // target rows staged per pass
constexpr int kPenalty = 512;  // added to distances to invalid target rows

__device__ __forceinline__ int ham(const uint4& qa, const uint4& qb,
                                   const uint4& ta, const uint4& tb) {
  return __popc(qa.x ^ ta.x) + __popc(qa.y ^ ta.y) + __popc(qa.z ^ ta.z) +
         __popc(qa.w ^ ta.w) + __popc(qb.x ^ tb.x) + __popc(qb.y ^ tb.y) +
         __popc(qb.z ^ tb.z) + __popc(qb.w ^ tb.w);
}

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

// packed: [frames, n, 2] uint4 (8 words per row); valid: [frames, n] uint8
__global__ void __launch_bounds__(kThreads)
band_counts_kernel(const uint4* __restrict__ packed,
                   const uint8_t* __restrict__ valid,
                   const int* __restrict__ qidx, const int* __restrict__ tidx,
                   int* __restrict__ out, int n, int block, float scale) {
  __shared__ uint4 st[kChunk][2];
  __shared__ int spen[kChunk];
  __shared__ int scratch[kThreads / 32];
  extern __shared__ int d1s[];  // [n] per-query-row nearest distance

  const int tf = blockIdx.x % block;
  const int qf = (blockIdx.x / block) % block;
  const int p = blockIdx.x / (block * block);
  const size_t qframe = static_cast<size_t>(qidx[p]) * block + qf;
  const size_t tframe = static_cast<size_t>(tidx[p]) * block + tf;
  const uint4* q = packed + qframe * n * 2;
  const uint4* t = packed + tframe * n * 2;
  const uint8_t* qv = valid + qframe * n;
  const uint8_t* tv = valid + tframe * n;
  const int tid = threadIdx.x;

  for (int base = 0; base < n; base += kThreads * kRows) {
    uint4 qa[kRows], qb[kRows];
    int best[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * kThreads + tid;
      const bool in = row < n;
      qa[r] = in ? q[2 * row] : make_uint4(0, 0, 0, 0);
      qb[r] = in ? q[2 * row + 1] : make_uint4(0, 0, 0, 0);
      best[r] = 1 << 20;
    }
    for (int t0 = 0; t0 < n; t0 += kChunk) {
      __syncthreads();  // the previous chunk is no longer being read
      for (int j = tid; j < kChunk && t0 + j < n; j += kThreads) {
        st[j][0] = t[2 * (t0 + j)];
        st[j][1] = t[2 * (t0 + j) + 1];
        spen[j] = tv[t0 + j] ? 0 : kPenalty;
      }
      __syncthreads();
      const int cnt = min(kChunk, n - t0);
      for (int j = 0; j < cnt; ++j) {
        const uint4 ta = st[j][0], tb = st[j][1];
        const int pen = spen[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          best[r] = min(best[r], ham(qa[r], qb[r], ta, tb) + pen);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r * kThreads + tid;
      if (row < n) d1s[row] = best[r];
    }
  }
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
                                     float scale, void* stream) {
  const long long blocks = static_cast<long long>(p_cnt) * block * block;
  const size_t smem = static_cast<size_t>(n) * sizeof(int);
  if (blocks > 0) {
    // above 48 KB of dynamic shared memory (n > ~7.6k rows with the static
    // 18 KB) the kernel must opt in; past the card's limit the launch fails
    // and the error is returned
    cudaFuncSetAttribute(band_counts_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    band_counts_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(packed), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx),
        static_cast<int*>(out), n, block, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
