// Motion-coherence support of N matches: with q_i = (x, y, dx, dy) the
// query point of match i and its displacement to the matched target,
//   near(i, j)  = (x_i - x_j)^2 + (y_i - y_j)^2 < r2
//   agree(i, j) = (dx_i - dx_j)^2 + (dy_i - dy_j)^2 < t2
//   out[i] = mask_i ? #{j : mask_j & near & agree} - 1 : 0
// (the -1 removes i's support of itself). r2 and t2 are the radius and tau
// squared once in float32 by the caller.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _support_kernel
// (via motion_support_pallas). Same direct-difference formula (not the GEMM
// expansion of the JAX package's XLA path); every square and sum is rounded
// on its own (__fsub_rn / __fmul_rn / __fadd_rn), so nvcc cannot contract
// them into FMAs and the counts are bitwise those of the plain version.
//
// Design: one thread per query match; the block stages 1024 matches
// (16 KB of float4 plus their mask) at a time in shared memory and every
// thread tests them all. Bound on the H100: ~15 floating-point operations
// per pair, 4 M pairs at N = 2000; with N = 2000 the grid is only 8 blocks,
// so the kernel is latency-bound on 8 SMs. Later work: split the matches of
// the j loop across blocks (integer atomics keep the sum exact).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // matches staged per pass

__device__ __forceinline__ float sq_dist(float ax, float ay, float bx,
                                         float by) {
  const float ex = __fsub_rn(ax, bx);
  const float ey = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

// q: [n] float4 (x, y, dx, dy); mask: [n] uint8; out: [n] int32
__global__ void __launch_bounds__(kThreads)
motion_support_kernel(const float4* __restrict__ q,
                      const uint8_t* __restrict__ mask, int* __restrict__ out,
                      int n, float r2, float t2) {
  __shared__ float4 sq[kChunk];
  __shared__ uint8_t sm[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 me = i < n ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer being read
    for (int j = threadIdx.x; j < kChunk && t0 + j < n; j += kThreads) {
      sq[j] = q[t0 + j];
      sm[j] = mask[t0 + j];
    }
    __syncthreads();
    const int c = min(kChunk, n - t0);
    for (int j = 0; j < c; ++j) {
      const float4 o = sq[j];
      const bool ok = sm[j] && sq_dist(me.x, me.y, o.x, o.y) < r2 &&
                      sq_dist(me.z, me.w, o.z, o.w) < t2;
      cnt += ok ? 1 : 0;
    }
  }
  if (i < n) out[i] = mask[i] ? cnt - 1 : 0;
}

}  // namespace

extern "C" int slam_motion_support(const void* q, const void* mask, void* out,
                                   int n, float r2, float t2, void* stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    motion_support_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(q), static_cast<const uint8_t*>(mask),
        static_cast<int*>(out), n, r2, t2);
  }
  return static_cast<int>(cudaGetLastError());
}
