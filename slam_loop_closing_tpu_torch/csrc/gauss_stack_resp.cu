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
// Design: one launch per level (a 32x8 output tile per block, the input
// tile with its reflected halo and the vertical pass in shared memory; the
// radius is a template parameter, so the tap loops unroll), then one launch
// of the gates (a thread per output pixel and plane, reading the four
// Gaussian planes around it through the cache).
//
// Bound on the H100: memory traffic. At a 1080p chunk of 8 frames the
// octave reads 66 MB of frames and writes 6 levels (398 MB) and 3 response
// planes (199 MB); the chain reads every level once more and the gates read
// 4 planes per response plane: about 1.8 GB of device traffic for a lower
// bound of 0.66 GB (each input read once, each output written once), ~0.2 ms
// at 3.35 TB/s. Later work: the chain in one launch with the levels kept in
// shared memory (the TPU kernel's scheme), and the gates fused into the last
// levels' pass.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kMaxR = 9;
constexpr int kMaxTaps = 2 * kMaxR + 1;
constexpr int kMaxLevels = 8;

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

// src: frame b at src + b * src_stride; dst likewise. Needs R < h, w.
template <int R>
__global__ void __launch_bounds__(kTileW * kTileH)
blur_level_kernel(const float* __restrict__ src, size_t src_stride,
                  float* __restrict__ dst, size_t dst_stride, const Taps taps,
                  int h, int w) {
  constexpr int kTaps = 2 * R + 1;
  constexpr int kIW = kTileW + 2 * R;
  constexpr int kIH = kTileH + 2 * R;
  constexpr int kThreads = kTileW * kTileH;
  __shared__ float simg[kIH][kIW];
  __shared__ float svert[kTileH][kIW];
  const float* in = src + blockIdx.z * src_stride;
  float* out = dst + blockIdx.z * dst_stride;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kIH * kIW; i += kThreads) {
    const int gy = reflect(y0 + i / kIW - R, h);
    const int gx = reflect(x0 + i % kIW - R, w);
    simg[i / kIW][i % kIW] = in[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();
  // vertical pass over every column the horizontal pass reads
  for (int i = tid; i < kTileH * kIW; i += kThreads) {
    const int r = i / kIW, c = i % kIW;
    float v = __fmul_rn(taps.k[0], simg[r][c]);
#pragma unroll
    for (int j = 1; j < kTaps; ++j)
      v = __fadd_rn(v, __fmul_rn(taps.k[j], simg[r + j][c]));
    svert[r][c] = v;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float v = __fmul_rn(taps.k[0], svert[threadIdx.y][threadIdx.x]);
#pragma unroll
  for (int j = 1; j < kTaps; ++j)
    v = __fadd_rn(v, __fmul_rn(taps.k[j], svert[threadIdx.y][threadIdx.x + j]));
  out[static_cast<size_t>(y) * w + x] = v;
}

// gauss: [b, levels, h, w]; resp: [b, s, h, w]; blockIdx.z = b * s + j.
__global__ void __launch_bounds__(kTileW * kTileH)
gates_kernel(const float* __restrict__ gauss, float* __restrict__ resp,
             int levels, int s, int h, int w, float thr, float edge_r,
             float edge_rhs, int border) {
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = blockIdx.z / s, j = blockIdx.z % s;
  const size_t hw = static_cast<size_t>(h) * w;
  float out = 0.f;
  if (y >= border && y < h - border && x >= border && x < w - border) {
    // the four Gaussian planes around DoG planes j, j+1, j+2
    const float* g = gauss + (static_cast<size_t>(b) * levels + j) * hw;
    auto dog = [&](int p, int yy, int xx) {
      const size_t o = static_cast<size_t>(yy) * w + xx;
      return __fsub_rn(g[(p + 1) * hw + o], g[p * hw + o]);
    };
    const float v = dog(1, y, x);
    float mx = -CUDART_INF_F, mn = CUDART_INF_F;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (p == 1 && dy == 0 && dx == 0) continue;
          const float d = dog(p, y + dy, x + dx);
          mx = fmaxf(mx, d);
          mn = fminf(mn, d);
        }
    const float av = fabsf(v);
    if ((v > mx || v < mn) && av >= thr) {
      // central differences of DoG plane j+1, in the plain order:
      // gx = (d[x+1] - d[x-1]) * 0.5, gxx = (gx[x+1] - gx[x-1]) * 0.5, ...
      auto half = [](float a, float c) { return __fmul_rn(__fsub_rn(a, c), 0.5f); };
      const float gx_r = half(dog(1, y, x + 2), v);
      const float gx_l = half(v, dog(1, y, x - 2));
      const float gy_d = half(dog(1, y + 2, x), v);
      const float gy_u = half(v, dog(1, y - 2, x));
      const float gx_d = half(dog(1, y + 1, x + 1), dog(1, y + 1, x - 1));
      const float gx_u = half(dog(1, y - 1, x + 1), dog(1, y - 1, x - 1));
      const float gxx = half(gx_r, gx_l);
      const float gyy = half(gy_d, gy_u);
      const float gxy = half(gx_d, gx_u);
      const float tr = __fadd_rn(gxx, gyy);
      const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
      if (det > 0.f &&
          __fmul_rn(__fmul_rn(tr, tr), edge_r) < __fmul_rn(edge_rhs, det))
        out = av;
    }
  }
  resp[(static_cast<size_t>(b) * s + j) * hw + static_cast<size_t>(y) * w + x] =
      out;
}

template <int R>
void launch_blur(const float* src, size_t src_stride, float* dst,
                 size_t dst_stride, const Taps& taps, int b, int h, int w,
                 cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  blur_level_kernel<R><<<grid, dim3(kTileW, kTileH), 0, stream>>>(
      src, src_stride, dst, dst_stride, taps, h, w);
}

bool blur(int r, const float* src, size_t src_stride, float* dst,
          size_t dst_stride, const Taps& taps, int b, int h, int w,
          cudaStream_t st) {
  switch (r) {
    case 1: launch_blur<1>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 2: launch_blur<2>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 3: launch_blur<3>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 4: launch_blur<4>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 5: launch_blur<5>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 6: launch_blur<6>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 7: launch_blur<7>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 8: launch_blur<8>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    case 9: launch_blur<9>(src, src_stride, dst, dst_stride, taps, b, h, w, st); return true;
    default: return false;
  }
}

}  // namespace

// taps: [levels, 19] float32 host memory, level l's 2 r_l + 1 taps first;
// radii: [levels] host ints in 1..9; s = 0 computes the chain only (resp
// unused), s > 0 also the s gated response planes (levels = s + 3).
extern "C" int slam_gauss_stack_resp(const void* img, void* gauss, void* resp,
                                     const float* taps, const int* radii,
                                     int levels, int b, int h, int w, int s,
                                     float thr, float edge_r, float edge_rhs,
                                     int border, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (s > 0 && levels != s + 3))
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
  if (s > 0) {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    b * s);
    gates_kernel<<<grid, dim3(kTileW, kTileH), 0, st>>>(
        g, static_cast<float*>(resp), levels, s, h, w, thr, edge_r, edge_rhs,
        border);
  }
  return static_cast<int>(cudaGetLastError());
}
