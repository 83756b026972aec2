// Fused FAST-9 corner score, 3x3 non-maximum suppression and the ORB
// descriptor-prefilter Gaussian blur (sigma 2, radius 3) of a batch of
// float32 frames [B, H, W].
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _fast_kernel (via
// fast_score_nms_blur / fast_score_nms).
//
// Semantics are those of the float32 reference path, not the TPU kernel's
// bfloat16 one: fast.fast_score_map + fast.nms + image.gaussian_blur.
//  * Score: for a window of the 16-pixel ring, min_i((r_i - c) - t) equals
//    (min_i r_i - c) - t exactly, because x -> fl(fl(x - c) - t) is monotone;
//    likewise for the dark arc with the window max. So one sliding min/max
//    over the ring gives the reference's bits; the score uses only
//    subtract/min/max and is bitwise equal to the plain version.
//  * NMS keeps a score that is >= all 8 neighbours (-inf outside the frame).
//  * The blur pads by reflection (numpy "reflect"), runs vertical then
//    horizontal in the reference's tap order, and uses __fmul_rn/__fadd_rn
//    so nvcc cannot contract it into FMAs: bitwise equal to the plain
//    version's separate multiply and add.
//
// Bound on the H100: memory traffic. Per pixel it reads the frame twice
// (once per launch, halo reuse through shared memory) and the score map once,
// and writes three maps: ~24 B/pixel, some 50 MB per 1080p frame batch of 8.
// The ~60 min/max operations per pixel are far below the ALU rate.
// Later work: one launch (score tile with a 1-px halo recomputed in shared
// memory) drops the score map's round trip through device memory; bf16 or
// uint8 input would quarter the read bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kRing = 3;  // FAST circle radius
constexpr int kBlurR = 3;
constexpr int kTaps = 2 * kBlurR + 1;

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// numpy "reflect" index (edge sample not repeated), clamped so that tile
// positions far past a ragged edge still read inside the frame.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ score, int h, int w,
                                  float thr) {
  __shared__ float tile[kTileH + 2 * kRing][kTileW + 2 * kRing];
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kTW = kTileW + 2 * kRing;
  for (int i = tid; i < (kTileH + 2 * kRing) * kTW; i += kTileW * kTileH) {
    const int gy = y0 + i / kTW - kRing, gx = x0 + i % kTW - kRing;
    tile[i / kTW][i % kTW] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                                 ? img[frame + static_cast<size_t>(gy) * w + gx]
                                 : 0.f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float out = 0.f;
  if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
    const int ty = threadIdx.y + kRing, tx = threadIdx.x + kRing;
    const float c = tile[ty][tx];
    float ring[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) ring[k] = tile[ty + kDy[k]][tx + kDx[k]];
    float best_min = -CUDART_INF_F, worst_max = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float mn = ring[k], mx = ring[k];
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        mn = fminf(mn, ring[(k + i) & 15]);
        mx = fmaxf(mx, ring[(k + i) & 15]);
      }
      best_min = fmaxf(best_min, mn);
      worst_max = fminf(worst_max, mx);
    }
    const float bright = __fsub_rn(__fsub_rn(best_min, c), thr);
    const float dark = __fsub_rn(__fsub_rn(c, worst_max), thr);
    out = fmaxf(fmaxf(bright, dark), 0.f);
  }
  score[frame + static_cast<size_t>(y) * w + x] = out;
}

struct Taps {
  float k[kTaps];
};

__global__ void nms_blur_kernel(const float* __restrict__ img,
                                const float* __restrict__ score,
                                float* __restrict__ score_out,
                                float* __restrict__ blur_out, const Taps taps,
                                int h, int w) {
  __shared__ float simg[kTileH + 2 * kBlurR][kTileW + 2 * kBlurR];
  __shared__ float svert[kTileH][kTileW + 2 * kBlurR];
  __shared__ float ssc[kTileH + 2][kTileW + 2];
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kThreads = kTileW * kTileH;
  constexpr int kIW = kTileW + 2 * kBlurR;
  for (int i = tid; i < (kTileH + 2 * kBlurR) * kIW; i += kThreads) {
    const int gy = reflect(y0 + i / kIW - kBlurR, h);
    const int gx = reflect(x0 + i % kIW - kBlurR, w);
    simg[i / kIW][i % kIW] = img[frame + static_cast<size_t>(gy) * w + gx];
  }
  constexpr int kSW = kTileW + 2;
  for (int i = tid; i < (kTileH + 2) * kSW; i += kThreads) {
    const int gy = y0 + i / kSW - 1, gx = x0 + i % kSW - 1;
    ssc[i / kSW][i % kSW] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                                ? score[frame + static_cast<size_t>(gy) * w + gx]
                                : -CUDART_INF_F;
  }
  const float* k = taps.k;
  __syncthreads();
  // vertical pass over every column the horizontal pass reads
  for (int i = tid; i < kTileH * kIW; i += kThreads) {
    const int r = i / kIW, c = i % kIW;
    float v = __fmul_rn(k[0], simg[r][c]);
#pragma unroll
    for (int j = 1; j < kTaps; ++j) v = __fadd_rn(v, __fmul_rn(k[j], simg[r + j][c]));
    svert[r][c] = v;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int ty = threadIdx.y, tx = threadIdx.x;
  float bl = __fmul_rn(k[0], svert[ty][tx]);
#pragma unroll
  for (int j = 1; j < kTaps; ++j) bl = __fadd_rn(bl, __fmul_rn(k[j], svert[ty][tx + j]));
  const float s = ssc[ty + 1][tx + 1];
  float local_max = s;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) local_max = fmaxf(local_max, ssc[ty + dy][tx + dx]);
  const size_t o = frame + static_cast<size_t>(y) * w + x;
  score_out[o] = s >= local_max ? s : 0.f;
  blur_out[o] = bl;
}

}  // namespace

// taps: the 7 blur weights, float32, host memory (passed by value)
extern "C" int slam_fast_score_nms_blur(const void* img, void* score_tmp,
                                        void* score_out, void* blur_out,
                                        const float* taps, int b, int h, int w,
                                        float threshold, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  Taps t;
  for (int i = 0; i < kTaps; ++i) t.k[i] = taps[i];
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fast_score_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(img),
                                           static_cast<float*>(score_tmp), h, w,
                                           threshold);
  nms_blur_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(img), static_cast<const float*>(score_tmp),
      static_cast<float*>(score_out), static_cast<float*>(blur_out), t, h, w);
  return static_cast<int>(cudaGetLastError());
}
