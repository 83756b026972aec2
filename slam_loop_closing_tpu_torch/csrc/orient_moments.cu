// Kernel M: the intensity-centroid orientation of ORB keypoints from their
// 32 x 32 patches, with the moments summed in a fixed order.
//
// For keypoint k with float32 patch p (1,024 values, row-major) and the
// circular-window weights w10, w01 (ops/orb.py _orientation_moment_weights:
// the x and y offsets from the patch's nominal center inside radius 15,
// else 0):
//   m10 = sum_i p_i w10_i,  m01 = sum_i p_i w01_i,
//   angle = valid ? atan2(m01, m10) : 0.
// The order is that of ops/orb.py's orientation_moments_plain: every
// product rounded to float32, then a pairwise tree over the 1,024 columns,
// p = p[:h] + p[h:] for h = 512, 256, ..., 1. The products are inexact, so
// no multiply-add may be contracted into an FMA: __fmul_rn and __fadd_rn
// throughout. The bits of an angle then depend only on its patch, not on
// how many keypoints a launch holds, unlike the [K, 1024] @ [1024, 2]
// cuBLAS product it replaces, whose algorithm depends on K.
//
// Replaces: no TPU kernel. The JAX package leaves the moments to XLA
// (slam_loop_closing_tpu/ops/orb.py, orientation_from_patches).
//
// Design: one warp a keypoint. Lane l loads elements l, l + 32, ..., l +
// 992 (a warp's load is 128 contiguous bytes), so element l + 32 j is the
// lane's value j and the tree's first five levels (h = 512 ... 32) pair
// values j and j + h / 32 of one lane in registers; __shfl_xor_sync at 16,
// 8, 4, 2, 1 finishes it across the lanes (a + b is the same float as
// b + a, so every lane ends with the same sum).
//
// Bound on the H100: bytes, the 4 KB of each patch read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // keypoints a block
constexpr int kCols = 1024;            // values a patch

// one level of the tree in a lane's registers: value j += value j + kH, for
// j < kH (a constant, so every index is one and the arrays stay in
// registers)
template <int kH>
__device__ __forceinline__ void fold(float (&a)[32], float (&b)[32]) {
#pragma unroll
  for (int j = 0; j < kH; ++j) {
    a[j] = __fadd_rn(a[j], a[j + kH]);
    b[j] = __fadd_rn(b[j], b[j + kH]);
  }
}

// patches: [k, 1024] float32; valid: [k] uint8; weights: [1024, 2] float32
// (w10, w01); angle: [k] float32
__global__ void __launch_bounds__(kThreads)
orient_moments_kernel(const float* __restrict__ patches,
                      const uint8_t* __restrict__ valid,
                      const float2* __restrict__ weights,
                      float* __restrict__ angle, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= k) return;  // a whole warp: no shuffle is left half-empty
  const float* p = patches + static_cast<size_t>(row) * kCols;
  float a[32], b[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float v = __ldg(p + lane + 32 * j);
    const float2 w = __ldg(weights + lane + 32 * j);
    a[j] = __fmul_rn(v, w.x);
    b[j] = __fmul_rn(v, w.y);
  }
  fold<16>(a, b);
  fold<8>(a, b);
  fold<4>(a, b);
  fold<2>(a, b);
  fold<1>(a, b);
  float m10 = a[0], m01 = b[0];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, o));
    m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, o));
  }
  if (lane == 0) angle[row] = valid[row] ? atan2f(m01, m10) : 0.0f;
}

}  // namespace

// angle [k] of the patches [k, 32, 32] with validity valid [k] and the
// moment weights [1024, 2]
extern "C" int slam_orient_moments(const void* patches, const void* valid,
                                   const void* weights, void* angle, int k,
                                   void* stream) {
  if (k > 0) {
    const unsigned blocks = static_cast<unsigned>((k + kWarps - 1) / kWarps);
    orient_moments_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(patches),
        static_cast<const uint8_t*>(valid),
        static_cast<const float2*>(weights), static_cast<float*>(angle), k);
  }
  return static_cast<int>(cudaGetLastError());
}
