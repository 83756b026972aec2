// Kernel J: one banded antialiased bilinear resize of a batch of frames in
// a fixed order of operations, in two modes:
//
// * the ORB pyramid level (slam_pyramid_level): what
//   slam_loop_closing_tpu_torch/ops/image.py's resize_banded computes at
//   bfloat16: the resize of jax.image.resize at bfloat16, one axis
//   contracted in float32 and rounded to bfloat16 (round to nearest even),
//   then the other; the input rounded to bfloat16 on load (the first
//   level reads the float32 frames, later levels the bfloat16 level
//   before); the level written twice, bfloat16 for the next level and
//   float32 for kernel A;
// * the SIFT octave halving (slam_resize_f32): resize_banded at float32,
//   the same passes with nothing rounded but each product and add, read
//   and written in float32.
//
// Rows first unless h > w. Each output of an axis sums its T taps
// (image.resize_taps: the first input index and T weights, bfloat16 or
// float32; 3 at the ORB pyramid's scale 1.2, 4 at a halving) in ascending
// input index, starting from the first tap: acc = w_0 x_0, then
// acc = acc + w_k x_k, every product and add rounded on its own (no FMA).
// The bits of an output do not depend on the batch size, unlike the dense
// float32 GEMMs it replaces, whose order cuBLAS picks by shape. In the
// bfloat16 mode every product of two bfloat16 values is exact in float32,
// so its outputs also equal those dense products on the CPU fixtures.
//
// Replaces: no TPU kernel. The JAX package lets XLA lower jax.image.resize
// to per-axis interpolation matmuls (slam_loop_closing_tpu/ops/image.py,
// resize_bilinear and pyramid; ops/sift.py's octave halving); the port ran
// them as dense float32 cuBLAS products over [in, out] weight matrices.
//
// Design: one launch a level, one block of 256 threads an output tile of
// one frame (kTileH x kTileW outputs: 32 x 64 at the ORB levels, 16 x 64
// at the halving, the tiles csrc/probes/probe_pyramid_forms.py found
// fastest). The block copies the tile's taps and its whole input
// footprint (the input rows and columns its outputs read, about 41 x 80
// at scale 1.2) into shared memory first, so every input element is read
// from device memory once: a warp along kRowsInFlight rows at a time, a
// lane every 32nd column, all loads issued before any store and no
// division in the index. The first pass writes the intermediate to shared
// memory (rows first: the tile's output rows over the footprint's columns,
// a warp along a row, the row's taps in registers) and the second pass
// writes the outputs, a thread a column (its taps in registers) over every
// other output row, so a warp's stores are 32 consecutive outputs. The
// path's tap counts (3 and 3 at the ORB levels, 4 and 4 at a halving) are
// compiled in, which unrolls every tap loop; other counts take a generic
// instance. csrc/probes/probe_pyramid_forms.py times the forms that lost.
//
// Bound on the H100: bytes. The input read once and the outputs written
// once (bfloat16 mode: 2 + 4 bytes an output pixel; float32: 4); the
// multiplies and adds (2T - 1 an output of each pass) are far below the
// FMA pipe's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 8;        // image.MAX_TAPS
constexpr int kRowsInFlight = 2;   // footprint rows a warp stages at once
constexpr int kMaxSmem = 200 * 1024;
constexpr int kLevelTileH = 32, kLevelTileW = 64;   // bfloat16 mode
constexpr int kHalfTileH = 16, kHalfTileW = 64;     // float32 mode

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kRound>
__device__ __forceinline__ float load(const float* p) {
  const float v = __ldg(p);
  return kRound ? round_bf16(v) : v;
}

template <bool kRound>
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kT taps an output on both axes (3 at the ORB pyramid's scale 1.2, 4 at a
// halving), or 0: up to kMaxTaps, as many as the tables say
template <int kT>
struct Taps {
  static constexpr int kSlots = kT ? kT : kMaxTaps;
  float w[kSlots];

  // the weights of one output, zeros past its count t
  __device__ __forceinline__ void load(const float* src, int t) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) w[k] = (kT || k < t) ? src[k] : 0.0f;
  }

  // sum_k w[k] * x[k * stride], k ascending, every product and add
  // rounded on its own
  __device__ __forceinline__ float dot(const float* x, int stride,
                                       int t) const {
    float acc = __fmul_rn(w[0], x[0]);
#pragma unroll
    for (int k = 1; k < kSlots; ++k)
      if (kT || k < t) acc = __fadd_rn(acc, __fmul_rn(w[k], x[k * stride]));
    return acc;
  }
};

// one output tile. x: [b, h, w]; out_b (bfloat16 mode) and out_f: [b, oh,
// ow]; rs, rw: the row taps (start [oh], weights [oh, tr]); cs, cw: the
// column taps. span_r, span_c: the most input rows (columns) a tile's
// outputs read, which size the shared memory.
template <typename In, bool kRound, bool kRowsFirst, int TH, int TW, int kT>
__device__ __forceinline__ void resize_tile(
    const In* __restrict__ x, __nv_bfloat16* __restrict__ out_b,
    float* __restrict__ out_f, const int* __restrict__ rs,
    const float* __restrict__ rw, int tr, const int* __restrict__ cs,
    const float* __restrict__ cw, int tc, int h, int w, int oh, int ow,
    int span_r, int span_c) {
  constexpr int kColLoads = TW / 32 + 1;   // footprint columns a lane loads
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int nr = min(TH, oh - r0), nc = min(TW, ow - c0);
  float* rw_s = smem;                                  // [TH, tr]
  float* cw_s = rw_s + TH * tr;                        // [TW, tc]
  int* rs_s = reinterpret_cast<int*>(cw_s + TW * tc);  // [TH]
  int* cs_s = rs_s + TH;                               // [TW]
  float* xs = reinterpret_cast<float*>(cs_s + TW);     // [span_r, span_c]
  float* mid = xs + span_r * span_c;
  const int rbase = __ldg(rs + r0), cbase = __ldg(cs + c0);
  const int nrows = __ldg(rs + r0 + nr - 1) + tr - rbase;
  const int ncols = __ldg(cs + c0 + nc - 1) + tc - cbase;
  for (int i = tid; i < nr * tr; i += kThreads) rw_s[i] = __ldg(rw + r0 * tr + i);
  for (int i = tid; i < nc * tc; i += kThreads) cw_s[i] = __ldg(cw + c0 * tc + i);
  for (int i = tid; i < nr; i += kThreads) rs_s[i] = __ldg(rs + r0 + i) - rbase;
  for (int i = tid; i < nc; i += kThreads) cs_s[i] = __ldg(cs + c0 + i) - cbase;

  // the input footprint: a warp along kRowsInFlight rows at a time, a lane
  // every 32nd column, all of their loads issued before any store
  const In* xb = x + static_cast<size_t>(blockIdx.z) * h * w +
                 static_cast<size_t>(rbase) * w + cbase;
  for (int rr = warp; rr < nrows; rr += kWarps * kRowsInFlight) {
    for (int cc0 = lane; cc0 < ncols; cc0 += 32 * kColLoads) {
      float v[kRowsInFlight][kColLoads];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const In* src = xb + static_cast<size_t>(rr + q * kWarps) * w;
#pragma unroll
        for (int u = 0; u < kColLoads; ++u) {
          const int cc = cc0 + 32 * u;
          v[q][u] = (rr + q * kWarps < nrows && cc < ncols)
                        ? load<kRound>(src + cc)
                        : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q)
#pragma unroll
        for (int u = 0; u < kColLoads; ++u) {
          const int cc = cc0 + 32 * u;
          if (rr + q * kWarps < nrows && cc < ncols)
            xs[(rr + q * kWarps) * span_c + cc] = v[q][u];
        }
    }
  }
  __syncthreads();

  Taps<kT> taps;
  if (kRowsFirst) {
    // mid [TH, span_c]: output row i at footprint column j, a warp a row
    for (int i = warp; i < nr; i += kWarps) {
      taps.load(rw_s + i * tr, tr);
      const float* src = xs + rs_s[i] * span_c;
      for (int j = lane; j < ncols; j += 32) {
        const float acc = taps.dot(src + j, span_c, tr);
        mid[i * span_c + j] = kRound ? round_bf16(acc) : acc;
      }
    }
  } else {
    // mid [span_r, TW]: footprint row i at output column j, a thread a
    // column
    const int j = tid % TW;
    if (j < nc) {
      taps.load(cw_s + j * tc, tc);
      const float* src = xs + cs_s[j];
      for (int i = tid / TW; i < nrows; i += kThreads / TW) {
        const float acc = taps.dot(src + i * span_c, 1, tc);
        mid[i * TW + j] = kRound ? round_bf16(acc) : acc;
      }
    }
  }
  __syncthreads();

  // the outputs: a thread a column, rows i0, i0 + kThreads / TW, ...; a
  // warp stores 32 consecutive outputs of a row
  const int c = tid % TW;
  if (c >= nc) return;
  const int i0 = tid / TW;
  const size_t o0 = static_cast<size_t>(blockIdx.z) * oh * ow +
                    static_cast<size_t>(r0 + i0) * ow + c0 + c;
  const int step = (kThreads / TW) * ow;
  if (kRowsFirst) taps.load(cw_s + c * tc, tc);
  const float* m = kRowsFirst ? mid + i0 * span_c + cs_s[c] : mid + c;
  for (int i = i0, o = 0; i < nr; i += kThreads / TW, o += step) {
    float acc;
    if (kRowsFirst) {
      acc = taps.dot(m, 1, tc);
      m += (kThreads / TW) * span_c;
    } else {
      Taps<kT> row;
      row.load(rw_s + i * tr, tr);
      acc = row.dot(m + rs_s[i] * TW, TW, tr);
    }
    if (kRound) {
      const __nv_bfloat16 v = __float2bfloat16_rn(acc);
      out_b[o0 + o] = v;
      out_f[o0 + o] = __bfloat162float(v);
    } else {
      out_f[o0 + o] = acc;
    }
  }
}

template <typename In, bool kRowsFirst, int kT>
__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const In* __restrict__ x,
                     __nv_bfloat16* __restrict__ out_b,
                     float* __restrict__ out_f, const int* __restrict__ rs,
                     const float* __restrict__ rw, int tr,
                     const int* __restrict__ cs, const float* __restrict__ cw,
                     int tc, int h, int w, int oh, int ow, int span_r,
                     int span_c) {
  resize_tile<In, true, kRowsFirst, kLevelTileH, kLevelTileW, kT>(
      x, out_b, out_f, rs, rw, tr, cs, cw, tc, h, w, oh, ow, span_r, span_c);
}

template <bool kRowsFirst, int kT>
__global__ void __launch_bounds__(kThreads)
resize_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const int* __restrict__ rs, const float* __restrict__ rw,
                  int tr, const int* __restrict__ cs,
                  const float* __restrict__ cw, int tc, int h, int w, int oh,
                  int ow, int span_r, int span_c) {
  resize_tile<float, false, kRowsFirst, kHalfTileH, kHalfTileW, kT>(
      x, nullptr, out, rs, rw, tr, cs, cw, tc, h, w, oh, ow, span_r, span_c);
}

// shared memory of a tile: taps, starts, the footprint, the intermediate
size_t smem_bytes(int th, int tw, int tr, int tc, int span_r, int span_c,
                  bool rows_first) {
  const size_t words = static_cast<size_t>(th) * tr + tw * tc + th + tw +
                       static_cast<size_t>(span_r) * span_c +
                       (rows_first ? static_cast<size_t>(th) * span_c
                                   : static_cast<size_t>(span_r) * tw);
  return words * 4;
}

bool valid_args(int b, int tr, int tc, int span_r, int span_c) {
  return b <= 65535 && tr >= 1 && tc >= 1 && tr <= kMaxTaps &&
         tc <= kMaxTaps && span_r >= 1 && span_c >= 1;
}

// opt the kernel into more than 48 KB of dynamic shared memory where the
// tile needs it (an attribute of the current device)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

// kT of a tap-count pair: the path's counts compiled in, others generic
int fixed_taps(int tr, int tc, int fixed) {
  return tr == fixed && tc == fixed ? fixed : 0;
}

template <typename In, bool kRowsFirst, int kT>
cudaError_t launch_level_taps(const void* x, void* out_b, void* out_f,
                         const void* rs, const void* rw, int tr,
                         const void* cs, const void* cw, int tc, int b, int h,
                         int w, int oh, int ow, int span_r, int span_c,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(kLevelTileH, kLevelTileW, tr, tc, span_r,
                                 span_c, kRowsFirst);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = pyramid_level_kernel<In, kRowsFirst, kT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ow + kLevelTileW - 1) / kLevelTileW,
                  (oh + kLevelTileH - 1) / kLevelTileH, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<__nv_bfloat16*>(out_b),
      static_cast<float*>(out_f), static_cast<const int*>(rs),
      static_cast<const float*>(rw), tr, static_cast<const int*>(cs),
      static_cast<const float*>(cw), tc, h, w, oh, ow, span_r, span_c);
  return cudaSuccess;
}

template <typename In, bool kRowsFirst>
cudaError_t launch_level(const void* x, void* out_b, void* out_f,
                         const void* rs, const void* rw, int tr,
                         const void* cs, const void* cw, int tc, int b, int h,
                         int w, int oh, int ow, int span_r, int span_c,
                         cudaStream_t stream) {
  auto launch = fixed_taps(tr, tc, 3) ? &launch_level_taps<In, kRowsFirst, 3>
                                      : &launch_level_taps<In, kRowsFirst, 0>;
  return launch(x, out_b, out_f, rs, rw, tr, cs, cw, tc, b, h, w, oh, ow,
                span_r, span_c, stream);
}

template <bool kRowsFirst, int kT>
cudaError_t launch_f32_taps(const void* x, void* out, const void* rs,
                       const void* rw, int tr, const void* cs, const void* cw,
                       int tc, int b, int h, int w, int oh, int ow,
                       int span_r, int span_c, cudaStream_t stream) {
  const size_t smem = smem_bytes(kHalfTileH, kHalfTileW, tr, tc, span_r,
                                 span_c, kRowsFirst);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = resize_f32_kernel<kRowsFirst, kT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ow + kHalfTileW - 1) / kHalfTileW,
                  (oh + kHalfTileH - 1) / kHalfTileH, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const int*>(rs), static_cast<const float*>(rw), tr,
      static_cast<const int*>(cs), static_cast<const float*>(cw), tc, h, w,
      oh, ow, span_r, span_c);
  return cudaSuccess;
}

template <bool kRowsFirst>
cudaError_t launch_f32(const void* x, void* out, const void* rs,
                       const void* rw, int tr, const void* cs, const void* cw,
                       int tc, int b, int h, int w, int oh, int ow,
                       int span_r, int span_c, cudaStream_t stream) {
  auto launch = fixed_taps(tr, tc, 4) ? &launch_f32_taps<kRowsFirst, 4>
                                      : &launch_f32_taps<kRowsFirst, 0>;
  return launch(x, out, rs, rw, tr, cs, cw, tc, b, h, w, oh, ow, span_r,
                span_c, stream);
}

}  // namespace

// One pyramid level: out_b (bfloat16) and out_f (float32) [b, oh, ow] from
// x [b, h, w], float32 (in_bf16 = 0, rounded to bfloat16 on load) or
// bfloat16 (in_bf16 = 1). rs/rw (tr taps) and cs/cw (tc taps) are the row
// and column tap tables of image.resize_taps at bfloat16; span_r and span_c
// are the most input rows and columns a 32 x 64 output tile reads (the
// caller computes them from the tables).
extern "C" int slam_pyramid_level(const void* x, int in_bf16, void* out_b,
                                  void* out_f, const void* rs, const void* rw,
                                  int tr, const void* cs, const void* cw,
                                  int tc, int b, int h, int w, int oh, int ow,
                                  int rows_first, int span_r, int span_c,
                                  void* stream) {
  if (b > 0 && oh > 0 && ow > 0) {
    if (!valid_args(b, tr, tc, span_r, span_c))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (in_bf16)
      err = rows_first
                ? launch_level<__nv_bfloat16, true>(x, out_b, out_f, rs, rw,
                                                    tr, cs, cw, tc, b, h, w,
                                                    oh, ow, span_r, span_c, s)
                : launch_level<__nv_bfloat16, false>(x, out_b, out_f, rs, rw,
                                                     tr, cs, cw, tc, b, h, w,
                                                     oh, ow, span_r, span_c,
                                                     s);
    else
      err = rows_first
                ? launch_level<float, true>(x, out_b, out_f, rs, rw, tr, cs,
                                            cw, tc, b, h, w, oh, ow, span_r,
                                            span_c, s)
                : launch_level<float, false>(x, out_b, out_f, rs, rw, tr, cs,
                                             cw, tc, b, h, w, oh, ow, span_r,
                                             span_c, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float32 mode: out [b, oh, ow] float32 from x [b, h, w] float32 with
// the float32 tap tables of image.resize_taps; span_r and span_c for a
// 16 x 64 output tile.
extern "C" int slam_resize_f32(const void* x, void* out, const void* rs,
                               const void* rw, int tr, const void* cs,
                               const void* cw, int tc, int b, int h, int w,
                               int oh, int ow, int rows_first, int span_r,
                               int span_c, void* stream) {
  if (b > 0 && oh > 0 && ow > 0) {
    if (!valid_args(b, tr, tc, span_r, span_c))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        rows_first ? launch_f32<true>(x, out, rs, rw, tr, cs, cw, tc, b, h, w,
                                      oh, ow, span_r, span_c, s)
                   : launch_f32<false>(x, out, rs, rw, tr, cs, cw, tc, b, h,
                                       w, oh, ow, span_r, span_c, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
