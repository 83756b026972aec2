// Kernel J: one level of the ORB pyramid from the level before it, in a
// fixed order of operations.
//
// Computes what slam_loop_closing_tpu_torch/ops/image.py's resize_banded
// computes: the antialiased bilinear resize of jax.image.resize at
// bfloat16, one axis contracted in float32 and rounded to bfloat16 (round
// to nearest even), then the other; rows first unless h > w. Each output of
// an axis sums its T taps (image.resize_taps: the first input index and T
// bfloat16 weights, 3 at the ORB pyramid's scale 1.2) in ascending input
// index, starting from the first tap: acc = w_0 x_0, then acc += w_k x_k.
// Every product of two bfloat16 values is exact in float32, so the order
// of the adds is all that could move a bit, and here it is fixed: the bits
// of a level do not depend on the batch size, unlike the dense float32
// GEMMs it replaces, whose order cuBLAS picks by shape.
//
// Replaces: no TPU kernel. The JAX package lets XLA lower jax.image.resize
// to per-axis interpolation matmuls (slam_loop_closing_tpu/ops/image.py,
// resize_bilinear and pyramid); the port ran them as six dense float32
// cuBLAS products over [in, out] weight matrices.
//
// Design: one launch a level, one block of 64 x 4 threads per 16 x 64
// output tile of one frame. The first pass writes the tile's intermediate
// (rounded to bfloat16, held as float) to shared memory: rows first, the
// 16 output rows over the input columns the tile's 64 outputs read (about
// 80 at scale 1.2); columns first, the input rows the tile's 16 output rows
// read (about 22) over its 64 output columns. The second pass reads only
// shared memory. Both passes read along rows, so a warp's loads of the
// input are contiguous. The first level reads the float32 frames and
// rounds them to bfloat16 on load; later levels read the bfloat16 level
// before. Each launch writes the level twice: bfloat16 for the next level,
// float32 for kernel A.
//
// Bound on the H100: bytes. The input read once, the two outputs written
// once (2 + 4 bytes an output pixel): at 1080p about 32 MB a frame for the
// three levels, against 3 x 2 x 3 multiply-adds an output pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;   // output columns a block (threadIdx.x)
constexpr int kTileH = 16;   // output rows a block
constexpr int kRowsY = 4;    // threadIdx.y
constexpr int kMaxSmem = 48 * 1024;
constexpr int kMaxTaps = 8;  // image.MAX_TAPS

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load(const float* p) {
  return round_bf16(__ldg(p));
}

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// sum_k w[k] * x[k * stride], k ascending, every product and add rounded:
// x in device memory (the first pass)
template <typename T>
__device__ __forceinline__ float taps(const float* __restrict__ w, int n,
                                      const T* x, size_t stride) {
  float acc = __fmul_rn(__ldg(w), load(x));
  for (int k = 1; k < n; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), load(x + k * stride)));
  return acc;
}

// the same sum over the intermediate in shared memory (the second pass)
__device__ __forceinline__ float taps_mid(const float* __restrict__ w, int n,
                                          const float* m, int stride) {
  float acc = __fmul_rn(__ldg(w), m[0]);
  for (int k = 1; k < n; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + k), m[k * stride]));
  return acc;
}

__device__ __forceinline__ void put(__nv_bfloat16* out_b, float* out_f,
                                    size_t o, float acc) {
  const __nv_bfloat16 v = __float2bfloat16_rn(acc);
  out_b[o] = v;
  out_f[o] = __bfloat162float(v);
}

// x: [b, h, w] (float32 or bfloat16); out_b, out_f: [b, oh, ow]; rs, rw:
// the row taps (start [oh], weights [oh, tr]); cs, cw: the column taps.
// mid holds rows first kTileH x span floats, columns first span x kTileW.
template <typename In, bool kRowsFirst>
__global__ void __launch_bounds__(kTileW * kRowsY)
pyramid_level_kernel(const In* __restrict__ x,
                     __nv_bfloat16* __restrict__ out_b,
                     float* __restrict__ out_f, const int* __restrict__ rs,
                     const float* __restrict__ rw, int tr,
                     const int* __restrict__ cs, const float* __restrict__ cw,
                     int tc, int h, int w, int oh, int ow, int span) {
  extern __shared__ float mid[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int r1 = min(r0 + kTileH, oh), c1 = min(c0 + kTileW, ow);
  const In* xb = x + static_cast<size_t>(blockIdx.z) * h * w;
  const size_t ob = static_cast<size_t>(blockIdx.z) * oh * ow;
  if (kRowsFirst) {
    // mid[i][j]: output row r0 + i at input column cbase + j
    const int cbase = __ldg(cs + c0);
    const int ncols = __ldg(cs + c1 - 1) + tc - cbase;
    for (int i = ty; i < r1 - r0; i += kRowsY) {
      const int r = r0 + i;
      const In* src = xb + static_cast<size_t>(__ldg(rs + r)) * w + cbase;
      for (int j = tx; j < ncols; j += kTileW)
        mid[i * span + j] = round_bf16(taps(rw + r * tr, tr, src + j,
                                            static_cast<size_t>(w)));
    }
    __syncthreads();
    const int c = c0 + tx;
    if (c >= c1) return;
    const int s = __ldg(cs + c) - cbase;
    for (int i = ty; i < r1 - r0; i += kRowsY)
      put(out_b, out_f, ob + static_cast<size_t>(r0 + i) * ow + c,
          taps_mid(cw + c * tc, tc, mid + i * span + s, 1));
  } else {
    // mid[i][j]: input row rbase + i at output column c0 + j
    const int rbase = __ldg(rs + r0);
    const int nrows = __ldg(rs + r1 - 1) + tr - rbase;
    const int c = c0 + tx;
    const bool in = c < c1;
    const int s = in ? __ldg(cs + c) : 0;
    for (int i = ty; i < nrows; i += kRowsY)
      if (in)
        mid[i * kTileW + tx] = round_bf16(taps(
            cw + c * tc, tc, xb + static_cast<size_t>(rbase + i) * w + s, 1));
    __syncthreads();
    if (!in) return;
    for (int i = ty; i < r1 - r0; i += kRowsY) {
      const int r = r0 + i;
      put(out_b, out_f, ob + static_cast<size_t>(r) * ow + c,
          taps_mid(rw + r * tr, tr,
                   mid + (__ldg(rs + r) - rbase) * kTileW + tx, kTileW));
    }
  }
}

template <typename In, bool kRowsFirst>
cudaError_t launch(const void* x, void* out_b, void* out_f, const void* rs,
                   const void* rw, int tr, const void* cs, const void* cw,
                   int tc, int b, int h, int w, int oh, int ow, int span,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * span * (kRowsFirst ? kTileH : kTileW);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((ow + kTileW - 1) / kTileW, (oh + kTileH - 1) / kTileH, b);
  pyramid_level_kernel<In, kRowsFirst><<<grid, dim3(kTileW, kRowsY), smem,
                                         stream>>>(
      static_cast<const In*>(x), static_cast<__nv_bfloat16*>(out_b),
      static_cast<float*>(out_f), static_cast<const int*>(rs),
      static_cast<const float*>(rw), tr, static_cast<const int*>(cs),
      static_cast<const float*>(cw), tc, h, w, oh, ow, span);
  return cudaSuccess;
}

}  // namespace

// One pyramid level: out_b (bfloat16) and out_f (float32) [b, oh, ow] from
// x [b, h, w], float32 (in_bf16 = 0, rounded to bfloat16 on load) or
// bfloat16 (in_bf16 = 1). rs/rw (tr taps) and cs/cw (tc taps) are the row
// and column tap tables of image.resize_taps; span is the widest input
// extent of a tile's first pass (the caller computes it from the tables).
extern "C" int slam_pyramid_level(const void* x, int in_bf16, void* out_b,
                                  void* out_f, const void* rs, const void* rw,
                                  int tr, const void* cs, const void* cw,
                                  int tc, int b, int h, int w, int oh, int ow,
                                  int rows_first, int span, void* stream) {
  if (b > 0 && oh > 0 && ow > 0) {
    if (b > 65535 || tr < 1 || tc < 1 || tr > kMaxTaps || tc > kMaxTaps ||
        span < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (in_bf16)
      err = rows_first ? launch<__nv_bfloat16, true>(x, out_b, out_f, rs, rw,
                                                     tr, cs, cw, tc, b, h, w,
                                                     oh, ow, span, s)
                       : launch<__nv_bfloat16, false>(x, out_b, out_f, rs, rw,
                                                      tr, cs, cw, tc, b, h, w,
                                                      oh, ow, span, s);
    else
      err = rows_first ? launch<float, true>(x, out_b, out_f, rs, rw, tr, cs,
                                             cw, tc, b, h, w, oh, ow, span, s)
                       : launch<float, false>(x, out_b, out_f, rs, rw, tr, cs,
                                              cw, tc, b, h, w, oh, ow, span,
                                              s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
