// Kernel E: motion-coherence support of N matches. With (x, y) the query
// point of match i and (dx, dy) = (x, y) - its matched target point (one
// float32 subtraction each, as the plain version's xy_q - xy_t),
//   near(i, j)  = (x_i - x_j)^2 + (y_i - y_j)^2 < r2
//   agree(i, j) = (dx_i - dx_j)^2 + (dy_i - dy_j)^2 < t2
//   out[i] = mask_i ? #{j : mask_j & near & agree} - 1 : 0
// (the -1 removes i's support of itself). r2 and t2 are the radius and tau
// squared once in float32 by the caller. A launch takes a batch of such
// match sets (the loop search's candidate pairs), one per blockIdx.y.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _support_kernel
// (via motion_support_pallas). Same direct-difference formula (not the GEMM
// expansion of the JAX package's XLA path); every square and sum is rounded
// on its own (__fsub_rn / __fmul_rn / __fadd_rn), so nvcc cannot contract
// them into FMAs and the counts are bitwise those of the plain version.
//
// Bound on the H100: per (query, target) pair of valid matches 10 float32
// instructions on the FMA pipe (4 subtracts, 4 multiplies, 2 adds; none is
// an FMA) and 2 compares, so 10 / 33.45 T/s a pair: 1.2 us for the live
// path's one set of 2,000 matches. At that size a launch is latency, not
// the pipe (csrc/probes/probe_support_knn2.py: about 6 us of device time
// at 31 splits, 77 us unsplit); the 32-set verification chunks run at about
// 3x the bound, the compares and integer adds issuing beside the FP32 ops.
//
// Design:
//  * the kernel reads the two point arrays as the caller holds them and
//    forms (x, y, dx, dy) itself, so the wrapper launches nothing else.
//  * a block of 128 threads takes a slab of 512 query matches, 4 a thread
//    in registers, so one shared-memory read of a target match serves four
//    queries; the count is branch-free, cnt += near & agree.
//  * an invalid target match is staged with x = NaN: both its squared
//    distances are then NaN and its compares false, so the mask costs
//    nothing in the loop.
//  * the target matches of a set are split over blocks (blockIdx.x = slab *
//    splits + split) so that one set of 2,000 matches spreads over the
//    card's 132 SMs instead of 4 of them; the wrapper picks the split from
//    the batch, N and the SM count (four blocks an SM, at least 32 target
//    matches a split), so a batch that fills the card alone is not split
//    and the 32-set verification chunks (64-96 blocks) split 6-9 ways.
//    With one split a block writes out[i] itself. With several, out is
//    zeroed first and each split adds its partial count with an integer
//    atomicAdd (exact, order-free); the -1 of a valid row is added exactly
//    once, by the one split whose target range holds row i itself, and an
//    invalid row adds nothing, so every row ends at the plain version's
//    value whatever order the splits land in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;                   // query matches a thread
constexpr int kSlab = kThreads * kRows;    // query matches a block: 512
constexpr int kStage = 512;                // target matches staged at a time

__device__ __forceinline__ float sq_dist(float ax, float ay, float bx,
                                         float by) {
  const float ex = __fsub_rn(ax, bx);
  const float ey = __fsub_rn(ay, by);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

// match i of a set as (x, y, dx, dy)
__device__ __forceinline__ float4 match(const float* __restrict__ xq,
                                        const float* __restrict__ xt, int i) {
  const float x = xq[2 * i], y = xq[2 * i + 1];
  return make_float4(x, y, __fsub_rn(x, xt[2 * i]),
                     __fsub_rn(y, xt[2 * i + 1]));
}

// xq, xt: [batch, n, 2] float32 query and matched target points; mask:
// [batch, n] uint8; out: [batch, n] int32, zeroed beforehand when
// splits > 1. Split s counts target matches [s * split_len, min(n, (s + 1)
// * split_len)).
__global__ void __launch_bounds__(kThreads)
motion_support_kernel(const float* __restrict__ xq,
                      const float* __restrict__ xt,
                      const uint8_t* __restrict__ mask, int* __restrict__ out,
                      int n, int splits, int split_len, float r2, float t2) {
  __shared__ float4 sq[kStage];
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  xq += 2 * base;
  xt += 2 * base;
  mask += base;
  out += base;
  const int slab = blockIdx.x / splits, split = blockIdx.x % splits;
  const int i0 = slab * kSlab + threadIdx.x;
  float4 me[kRows];
  int cnt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    me[r] = i < n ? match(xq, xt, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    cnt[r] = 0;
  }
  const int t_begin = split * split_len;
  const int t_end = min(n, t_begin + split_len);
  for (int t0 = t_begin; t0 < t_end; t0 += kStage) {
    const int c = min(kStage, t_end - t0);
    __syncthreads();  // the previous stage is no longer being read
    for (int j = threadIdx.x; j < c; j += kThreads) {
      float4 o = match(xq, xt, t0 + j);
      if (!mask[t0 + j]) o.x = __int_as_float(0x7fc00000);  // never counts
      sq[j] = o;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < c; ++j) {
      const float4 o = sq[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        cnt[r] += (sq_dist(me[r].x, me[r].y, o.x, o.y) < r2) &
                  (sq_dist(me[r].z, me[r].w, o.z, o.w) < t2);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= n) continue;
    const bool valid = mask[i] != 0;
    if (splits == 1) {
      out[i] = valid ? cnt[r] - 1 : 0;
    } else if (valid) {
      const int v = cnt[r] - (i >= t_begin && i < t_end ? 1 : 0);
      if (v != 0) atomicAdd(out + i, v);
    }
  }
}

}  // namespace

extern "C" int slam_motion_support(const void* xq, const void* xt,
                                   const void* mask, void* out, int batch,
                                   int n, int splits, float r2, float t2,
                                   void* stream) {
  if (batch > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (splits < 1) splits = 1;
    const int split_len = (n + splits - 1) / splits;
    splits = (n + split_len - 1) / split_len;  // no split without targets
    if (splits > 1) {
      const cudaError_t err = cudaMemsetAsync(
          out, 0, static_cast<size_t>(batch) * n * sizeof(int), s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int slabs = (n + kSlab - 1) / kSlab;
    const dim3 blocks(static_cast<unsigned>(slabs * splits),
                      static_cast<unsigned>(batch));
    motion_support_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(xq), static_cast<const float*>(xt),
        static_cast<const uint8_t*>(mask),
        static_cast<int*>(out), n, splits, split_len, r2, t2);
  }
  return static_cast<int>(cudaGetLastError());
}
