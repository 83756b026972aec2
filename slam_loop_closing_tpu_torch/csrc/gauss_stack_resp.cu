// Kernel H: one SIFT octave of a batch of float32 frames [B, H, W]: the
// Gaussian chain of L = S+3 levels and, optionally, the gated DoG extremum
// response of the S interior DoG planes.
//   gauss[b, 0] = blur(img[b], sigma_0), gauss[b, l] = blur(gauss[b, l-1],
//   sigma_l), each a separable reflect-padded blur (vertical, then
//   horizontal) with the level's host taps (radius <= 9);
//   resp[b, j](y, x) = |v|, v = DoG plane j+1 = gauss[j+2] - gauss[j+1], where
//   v is a strict 26-neighbour extremum of DoG planes j..j+2, |v| >= thr,
//   the 2x2 Hessian of central differences has det > 0 and
//   tr^2 * r < (r+1)^2 * det, and (y, x) lies `border` px inside the frame;
//   0 elsewhere.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py,
// _gauss_stack_resp_kernel (via gauss_stack_resp_pallas) and, in its
// gauss-only mode (s = 0), _gauss_stack_kernel (via gauss_stack_pallas).
//
// Arithmetic of the plain chain (ops/sift.py: image.gaussian_blur per level,
// then the gates), not the TPU kernel's: every level reflects its own input,
// as chained blurs do (the TPU kernel reflected the input once and carried a
// widened halo); the taps run in the plain order with __fmul_rn/__fadd_rn, so
// nvcc cannot contract them into FMAs; the DoG is one __fsub_rn; the
// extremum test is an exact max/min tree; the gradients are
// (a - b) * 0.5 (jnp.gradient's and torch.gradient's central difference)
// and the edge test keeps the plain operation order. The result is bitwise
// equal to the plain version.
//
// Design. The blur: one launch per level, so each level still reflects its
// own input at the frame edge. A block owns a 128 x 16 output tile and one
// thread per column of the tile and its 2R-column halo. The vertical pass
// slides a window of 2R+1 rows in registers down that column, one global
// load a row (the radius is a template parameter, so the window unrolls
// into registers), and stores the column to shared memory; the horizontal
// pass computes four adjacent outputs a thread from 16-byte shared loads
// and stores them with one 16-byte store where the row is 16-byte aligned.
// Taller tiles read less halo but hold fewer warps an SM: 16 rows measured
// fastest at octaves 0 and 1 of 8 x 1080p and within 0.012 ms of 8 rows at
// the smaller ones (csrc/probes/probe_gauss_forms.py).
// The gates: one launch for all S planes. A block loads the L Gaussian
// planes over its 32 x 16 output tile and a 2-pixel halo once (an index
// outside the frame is clamped, and never used by a pixel the border gate
// lets through, as border >= 2), forms the S+2 DoG planes in shared memory,
// and each thread takes two output rows of a column: per DoG plane the 3x3
// max and min (and, for a centre plane, those without the centre) from row
// maxima of three, each formed once and shared by the response planes above
// and below; the Hessian runs only where the extremum and contrast gates
// pass.
//
// Bound on the H100: at 8 x 1080p, S = 3, radii 5, 4, 5, 6, 7, 9 (78 taps),
// the chain issues 4 * 78 - 2 * 6 = 300 FMA-pipe instructions a pixel (a
// tap is a multiply and an add, no FMA): 0.149 ms at 33.45 T/s against
// 0.139 ms of bytes (the frames read once, 6 levels written once), so the
// gauss-only mode is bound by operations. The gates add S+2 DoG subtracts
// and 12 (S+2) + 8 S = 84 min/max a pixel (0.083 ms on that pipe) and 3
// response planes written: 0.198 ms of bytes bound the whole call. The
// per-level design moves more than that: every level is read back once (6 x
// 66 MB) and the gates read all 6 again (398 MB).
//
// Later work: several levels a launch with a halo of the sum of their radii,
// each level reflecting its own input (the fused chain), which removes the
// read-back of the levels; and the gates' loads of the next tile in flight
// while the block computes the current one (the gates' load and compute
// phases overlap only across blocks now).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxR = 9;
constexpr int kMaxTaps = 2 * kMaxR + 1;
constexpr int kMaxLevels = 8;

// blur tiles: kBlurW x kBlurRows outputs, one thread per column of the
// tile and its halo (kBlurW + 2R <= kBlurThreads), shared rows padded to a
// multiple of 4 floats for the 16-byte loads of the horizontal pass
constexpr int kBlurW = 128;
constexpr int kBlurRows = 16;
constexpr int kBlurThreads = 160;
constexpr int kBlurStride = kBlurW + 2 * kMaxR + 2;
static_assert(kBlurW + 2 * kMaxR <= kBlurThreads, "a thread per column");
static_assert(kBlurStride % 4 == 0, "16-byte shared rows");

// gate tiles: kGateW x kGateH outputs, two rows a thread, a 2-pixel halo
constexpr int kGateW = 32;
constexpr int kGateH = 16;
constexpr int kGateThreads = kGateW * kGateH / 2;
constexpr int kHaloW = kGateW + 4;
constexpr int kHaloH = kGateH + 4;

struct Taps {
  float k[kMaxTaps];
};

// numpy "reflect" index (edge sample not repeated), clamped so that tile
// positions far past a ragged edge still read inside the frame.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// One level: src frame b at src + b * src_stride, dst likewise. Needs
// R < h, w.
template <int R>
__global__ void __launch_bounds__(kBlurThreads)
blur_window_kernel(const float* __restrict__ src, size_t src_stride,
                   float* __restrict__ dst, size_t dst_stride,
                   const Taps taps, int h, int w) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kQuads = kBlurW / 4;
  constexpr int kVec = (4 + 2 * R + 3) / 4;   // float4s under 4 outputs
  __shared__ __align__(16) float svert[kBlurRows][kBlurStride];
  const float* in = src + blockIdx.z * src_stride;
  float* out = dst + blockIdx.z * dst_stride;
  const int x0 = blockIdx.x * kBlurW, y0 = blockIdx.y * kBlurRows;
  const int rows = min(kBlurRows, h - y0);
  const int c = threadIdx.x;
  // vertical pass: column x0 - R + c, a window of 2R+1 rows in registers
  if (c < kBlurW + 2 * R) {
    const float* col = in + reflect(x0 - R + c, w);
    float win[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps - 1; ++k)
      win[k + 1] = __ldg(col + static_cast<size_t>(reflect(y0 - R + k, h)) * w);
#pragma unroll
    for (int r = 0; r < kBlurRows; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int k = 0; k < kTaps - 1; ++k) win[k] = win[k + 1];
      win[kTaps - 1] =
          __ldg(col + static_cast<size_t>(reflect(y0 + r + R, h)) * w);
      float v = __fmul_rn(taps.k[0], win[0]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j)
        v = __fadd_rn(v, __fmul_rn(taps.k[j], win[j]));
      svert[r][c] = v;
    }
  }
  __syncthreads();
  // horizontal pass: four adjacent outputs a thread, a row a warp
  const bool vec_store = (w & 3) == 0;
  for (int t = threadIdx.x; t < rows * kQuads; t += kBlurThreads) {
    const int r = t / kQuads, q = t % kQuads;
    const int x = x0 + 4 * q;
    if (x >= w) continue;
    float s[4 * kVec];
    const float4* sp = reinterpret_cast<const float4*>(&svert[r][4 * q]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float4 v = sp[i];
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = __fmul_rn(taps.k[0], s[i]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j)
        v = __fadd_rn(v, __fmul_rn(taps.k[j], s[i + j]));
      o[i] = v;
    }
    float* p = out + static_cast<size_t>(y0 + r) * w + x;
    if (vec_store) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x + i < w) p[i] = o[i];
    }
  }
}

// gauss: [b, S+3, h, w]; resp: [b, S, h, w]; blockIdx.z = b.
template <int S>
__global__ void __launch_bounds__(kGateThreads)
dog_gates_kernel(const float* __restrict__ gauss, float* __restrict__ resp,
                 int h, int w, float thr, float edge_r, float edge_rhs,
                 int border) {
  constexpr int kLevels = S + 3, kDog = S + 2;
  constexpr int kHalo = kHaloH * kHaloW;
  __shared__ float sdog[kDog][kHaloH][kHaloW];
  const size_t hw = static_cast<size_t>(h) * w;
  const float* g = gauss + blockIdx.z * kLevels * hw;
  const int x0 = blockIdx.x * kGateW, y0 = blockIdx.y * kGateH;
  const int tid = threadIdx.y * kGateW + threadIdx.x;
  // every Gaussian plane over the tile and its halo read once; the DoG
  // planes formed once into shared memory
#pragma unroll
  for (int k = 0; k < (kHalo + kGateThreads - 1) / kGateThreads; ++k) {
    const int i = tid + k * kGateThreads;
    if (i < kHalo) {
      const int hy = i / kHaloW, hx = i % kHaloW;
      const int gy = min(max(y0 - 2 + hy, 0), h - 1);
      const int gx = min(max(x0 - 2 + hx, 0), w - 1);
      const float* p = g + static_cast<size_t>(gy) * w + gx;
      float v[kLevels];
#pragma unroll
      for (int l = 0; l < kLevels; ++l) v[l] = __ldg(p + l * hw);
#pragma unroll
      for (int d = 0; d < kDog; ++d)
        sdog[d][hy][hx] = __fsub_rn(v[d + 1], v[d]);
    }
  }
  __syncthreads();
  const int sx = threadIdx.x + 2, sy = 2 * threadIdx.y + 2;
  // neighbour max/min of response plane j at output row o, and its centre
  float mx[S][2], mn[S][2], ctr[S][2];
#pragma unroll
  for (int d = 0; d < kDog; ++d) {
    // row maxima of three at shared rows sy-1 .. sy+2; the centre plane's
    // left/right pair and centre at rows sy, sy+1
    float rmax[4], rmin[4], lmax[2], lmin[2], cv[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = sdog[d][sy - 1 + k][sx - 1];
      const float b = sdog[d][sy - 1 + k][sx];
      const float c = sdog[d][sy - 1 + k][sx + 1];
      rmax[k] = fmaxf(fmaxf(a, b), c);
      rmin[k] = fminf(fminf(a, b), c);
      if (k == 1 || k == 2) {
        lmax[k - 1] = fmaxf(a, c);
        lmin[k - 1] = fminf(a, c);
        cv[k - 1] = b;
      }
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float amax = fmaxf(rmax[o], rmax[o + 2]);
      const float amin = fminf(rmin[o], rmin[o + 2]);
      if (d < S || d >= 2) {          // a neighbour plane: the full 3x3
        const float full_max = fmaxf(amax, rmax[o + 1]);
        const float full_min = fminf(amin, rmin[o + 1]);
        if (d < S) {                  // below response plane d
          mx[d][o] = full_max;
          mn[d][o] = full_min;
        }
        if (d >= 2) {                 // above response plane d - 2
          mx[d - 2][o] = fmaxf(mx[d - 2][o], full_max);
          mn[d - 2][o] = fminf(mn[d - 2][o], full_min);
        }
      }
      if (d >= 1 && d <= S) {         // the centre of response plane d - 1
        mx[d - 1][o] = fmaxf(mx[d - 1][o], fmaxf(amax, lmax[o]));
        mn[d - 1][o] = fminf(mn[d - 1][o], fminf(amin, lmin[o]));
        ctr[d - 1][o] = cv[o];
      }
    }
  }
  const int x = blockIdx.x * kGateW + threadIdx.x;
  const bool in_x = x >= border && x < w - border;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int y = y0 + 2 * threadIdx.y + o;
    if (x >= w || y >= h) continue;
    const bool inside = in_x && y >= border && y < h - border;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float v = ctr[j][o];
      const float av = fabsf(v);
      float out = 0.f;
      if (inside && (v > mx[j][o] || v < mn[j][o]) && av >= thr) {
        // central differences of DoG plane j+1, in the plain order:
        // gx = (d[x+1] - d[x-1]) * 0.5, gxx = (gx[x+1] - gx[x-1]) * 0.5, ...
        const int cy = sy + o;
        auto dog = [&](int dy, int dx) {
          return sdog[j + 1][cy + dy][sx + dx];
        };
        auto half = [](float a, float c) {
          return __fmul_rn(__fsub_rn(a, c), 0.5f);
        };
        const float gx_r = half(dog(0, 2), v);
        const float gx_l = half(v, dog(0, -2));
        const float gy_d = half(dog(2, 0), v);
        const float gy_u = half(v, dog(-2, 0));
        const float gx_d = half(dog(1, 1), dog(1, -1));
        const float gx_u = half(dog(-1, 1), dog(-1, -1));
        const float gxx = half(gx_r, gx_l);
        const float gyy = half(gy_d, gy_u);
        const float gxy = half(gx_d, gx_u);
        const float tr = __fadd_rn(gxx, gyy);
        const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
        if (det > 0.f &&
            __fmul_rn(__fmul_rn(tr, tr), edge_r) < __fmul_rn(edge_rhs, det))
          out = av;
      }
      resp[(static_cast<size_t>(blockIdx.z) * S + j) * hw +
           static_cast<size_t>(y) * w + x] = out;
    }
  }
}

template <int R>
void launch_blur(const float* src, size_t src_stride, float* dst,
                 size_t dst_stride, const Taps& taps, int b, int h, int w,
                 cudaStream_t stream) {
  const dim3 grid((w + kBlurW - 1) / kBlurW, (h + kBlurRows - 1) / kBlurRows,
                  b);
  blur_window_kernel<R><<<grid, kBlurThreads, 0, stream>>>(
      src, src_stride, dst, dst_stride, taps, h, w);
}

bool blur(int r, const float* src, size_t src_stride, float* dst,
          size_t dst_stride, const Taps& taps, int b, int h, int w,
          cudaStream_t st) {
  switch (r) {
#define SLAM_BLUR_CASE(R)                                                     \
  case R:                                                                     \
    launch_blur<R>(src, src_stride, dst, dst_stride, taps, b, h, w, st);     \
    return true;
    SLAM_BLUR_CASE(1) SLAM_BLUR_CASE(2) SLAM_BLUR_CASE(3)
    SLAM_BLUR_CASE(4) SLAM_BLUR_CASE(5) SLAM_BLUR_CASE(6)
    SLAM_BLUR_CASE(7) SLAM_BLUR_CASE(8) SLAM_BLUR_CASE(9)
#undef SLAM_BLUR_CASE
    default: return false;
  }
}

bool gates(int s, const float* gauss, float* resp, int b, int h, int w,
           float thr, float edge_r, float edge_rhs, int border,
           cudaStream_t st) {
  const dim3 grid((w + kGateW - 1) / kGateW, (h + kGateH - 1) / kGateH, b);
  const dim3 block(kGateW, kGateH / 2);
  switch (s) {
#define SLAM_GATES_CASE(S)                                              \
  case S:                                                               \
    dog_gates_kernel<S><<<grid, block, 0, st>>>(gauss, resp, h, w, thr, \
                                                edge_r, edge_rhs, border); \
    return true;
    SLAM_GATES_CASE(1) SLAM_GATES_CASE(2) SLAM_GATES_CASE(3)
    SLAM_GATES_CASE(4) SLAM_GATES_CASE(5)
#undef SLAM_GATES_CASE
    default: return false;
  }
}

}  // namespace

// taps: [levels, 19] float32 host memory, level l's 2 r_l + 1 taps first;
// radii: [levels] host ints in 1..9; s = 0 computes the chain only (resp
// unused), s > 0 also the s gated response planes (levels = s + 3, border
// >= 2).
extern "C" int slam_gauss_stack_resp(const void* img, void* gauss, void* resp,
                                     const float* taps, const int* radii,
                                     int levels, int b, int h, int w, int s,
                                     float thr, float edge_r, float edge_rhs,
                                     int border, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (s > 0 && levels != s + 3) ||
      (s > 0 && border < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t hw = static_cast<size_t>(h) * w;
  float* g = static_cast<float*>(gauss);
  for (int l = 0; l < levels; ++l) {
    Taps t;
    for (int i = 0; i < kMaxTaps; ++i) t.k[i] = taps[l * kMaxTaps + i];
    const float* src = l == 0 ? static_cast<const float*>(img) : g + (l - 1) * hw;
    const size_t src_stride = l == 0 ? hw : levels * hw;
    if (!blur(radii[l], src, src_stride, g + l * hw, levels * hw, t, b, h, w,
              st))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s > 0 && !gates(s, g, static_cast<float*>(resp), b, h, w, thr, edge_r,
                      edge_rhs, border, st))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
