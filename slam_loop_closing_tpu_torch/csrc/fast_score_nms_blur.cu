// Fused FAST-9 corner score, 3x3 non-maximum suppression and the ORB
// descriptor-prefilter Gaussian blur (sigma 2, radius 3) of a batch of
// float32 frames [B, H, W], in one launch.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _fast_kernel (via
// fast_score_nms_blur / fast_score_nms).
//
// Semantics are those of the float32 reference path, not the TPU kernel's
// bfloat16 one: fast.fast_score_map + fast.nms + image.gaussian_blur.
//  * Score: for a window of the 16-pixel ring, min_i((r_i - c) - t) equals
//    (min_i r_i - c) - t exactly, because x -> fl(fl(x - c) - t) is monotone;
//    likewise for the dark arc with the window max. So the ring's window
//    extrema give the reference's bits: the score uses only subtract and
//    min/max and is bitwise equal to the plain version.
//  * NMS keeps a score that is >= all 8 neighbours (-inf outside the frame).
//  * The blur pads by reflection (numpy "reflect"), runs vertical then
//    horizontal in the reference's tap order, and uses __fmul_rn/__fadd_rn
//    so nvcc cannot contract it into FMAs: bitwise equal to the plain
//    version's separate multiply and add.
//
// Bound on the H100: with a direct sliding window (16 windows x 8 minima
// and 8 maxima, then the best and worst arcs: 288 min/max a pixel) the
// min/max instructions set the pace, since FMNMX issues at half the FFMA
// rate (csrc/probes/probe_rates.py measures both). With the design below
// only the pixels that pass the pre-test take the arc extrema (about 2% on
// chip_smoke.py's orbit frames), and the bound is the memory traffic: the
// frame read once, the suppressed score and the blur written, 12 B a
// pixel. The design:
//  * one launch: a block loads its 64 x 16 output tile with a 4-px halo
//    (3 for the ring, 1 for the NMS neighbours; the blur's radius 3 fits)
//    into shared memory once, with 16-byte loads where the row layout
//    allows, computes the score over the tile and a 1-px ring into shared
//    memory, and writes only the suppressed score and the blur;
//  * arc extrema by doubling: minima over cyclic windows of 2, 4, 8, then
//    9 ring samples (and the maxima likewise): 2 x 80 min/max a pixel;
//  * the exact compass pre-test: any 9-arc holds two neighbouring samples of
//    the compass 0, 4, 8, 12; a pixel where no such pair passes the bright
//    test (fl(fl(r - c) - t) > 0) and none passes the dark one has score 0
//    exactly, and a warp whose pixels all fail skips the arc extrema;
//  * the blur's vertical pass runs four rows a thread and the NMS and the
//    horizontal pass four columns a thread (16-byte shared and global
//    accesses), so loaded values are reused; the ring samples are not
//    reused across pixels: 17 shared loads against 160 min/max a pixel;
//  * 2,040 blocks of 256 threads for one 1080p frame (B = 1, the live
//    path) fill the 132 SMs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 64;                  // output tile
constexpr int kTileH = 16;
constexpr int kBlurR = 3;
constexpr int kTaps = 2 * kBlurR + 1;
constexpr int kHalo = 4;                    // FAST ring 3 + the NMS neighbour
constexpr int kIW = kTileW + 2 * kHalo;     // 72: frame tile
constexpr int kIH = kTileH + 2 * kHalo;     // 24
constexpr int kSW = kTileW + 2;             // 66: score with its 1-px ring
constexpr int kSH = kTileH + 2;             // 18
constexpr int kSStride = 68;                // 16-byte rows
constexpr int kVW = kTileW + 2 * kBlurR;    // 70: columns of the vertical pass
constexpr int kVStride = 72;
constexpr int kVRows = 4;                   // vertical-pass rows a thread
constexpr int kScoreIters = (kSW * kSH + kThreads - 1) / kThreads;

static_assert(kTileW * kTileH == 4 * kThreads, "four outputs a thread");

struct Taps {
  float k[kTaps];
};

// numpy "reflect" index (edge sample not repeated), clamped so that tile
// positions far past a ragged edge still read inside the frame.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// bright (b) and dark (d) passes of one sample: fl(fl(x - c) - t) > 0 and
// fl(fl(c - x) - t) > 0
__device__ __forceinline__ unsigned passes(float x, float c, float thr) {
  return (__fsub_rn(__fsub_rn(x, c), thr) > 0.f ? 1u : 0u) |
         (__fsub_rn(__fsub_rn(c, x), thr) > 0.f ? 2u : 0u);
}

// true unless the score is 0 for certain: some neighbouring pair of the
// compass samples 0, 4, 8, 12 passes the bright test, or some pair the dark
// one (every 9-arc holds such a pair)
__device__ __forceinline__ bool compass_pass(float n, float e, float s,
                                             float w, float c, float thr) {
  const unsigned pn = passes(n, c, thr), pe = passes(e, c, thr),
                 ps = passes(s, c, thr), pw = passes(w, c, thr);
  return ((pn & pe) | (pe & ps) | (ps & pw) | (pw & pn)) != 0;
}

// FAST-9 score from the 16 ring samples (clockwise from 12 o'clock) and the
// centre: arc extrema by doubling over the cyclic ring
__device__ __forceinline__ float fast_score(const float (&r)[16], float c,
                                            float thr) {
  float lo2[16], hi2[16], lo4[16], hi4[16], lo8[16], hi8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo2[k] = fminf(r[k], r[(k + 1) & 15]);
    hi2[k] = fmaxf(r[k], r[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo4[k] = fminf(lo2[k], lo2[(k + 2) & 15]);
    hi4[k] = fmaxf(hi2[k], hi2[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo8[k] = fminf(lo4[k], lo4[(k + 4) & 15]);
    hi8[k] = fmaxf(hi4[k], hi4[(k + 4) & 15]);
  }
  float best = fminf(lo8[0], r[8]), worst = fmaxf(hi8[0], r[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    best = fmaxf(best, fminf(lo8[k], r[(k + 8) & 15]));
    worst = fminf(worst, fmaxf(hi8[k], r[(k + 8) & 15]));
  }
  const float bright = __fsub_rn(__fsub_rn(best, c), thr);
  const float dark = __fsub_rn(__fsub_rn(c, worst), thr);
  return fmaxf(fmaxf(bright, dark), 0.f);
}

__global__ void __launch_bounds__(kThreads)
fast_score_nms_blur_kernel(const float* __restrict__ img,
                           float* __restrict__ score_out,
                           float* __restrict__ blur_out, const Taps taps,
                           int h, int w, float thr, int vec) {
  __shared__ __align__(16) float sim[kIH][kIW];
  __shared__ __align__(16) float ssc[kSH][kSStride];
  __shared__ __align__(16) float svert[kTileH][kVStride];
  const size_t frame = static_cast<size_t>(blockIdx.z) * h * w;
  const float* src = img + frame;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x;

  // the frame tile with its halo, reflect-indexed (the blur's padding; the
  // score reads only samples inside the frame)
  constexpr int kChunks = kIW / 4;
  for (int i = tid; i < kIH * kChunks; i += kThreads) {
    const int r = i / kChunks, c4 = (i % kChunks) * 4;
    const int gy = reflect(y0 - kHalo + r, h);
    const int gx = x0 - kHalo + c4;
    const float* row = src + static_cast<size_t>(gy) * w;
    float4 v;
    if (vec && gx >= 0 && gx + 3 < w) {
      v = *reinterpret_cast<const float4*>(row + gx);
    } else {
      v = make_float4(row[reflect(gx, w)], row[reflect(gx + 1, w)],
                      row[reflect(gx + 2, w)], row[reflect(gx + 3, w)]);
    }
    *reinterpret_cast<float4*>(&sim[r][c4]) = v;
  }
  __syncthreads();

  // score over the tile and its 1-px ring: -inf outside the frame, 0 within
  // 3 px of its border
#pragma unroll 1
  for (int it = 0; it < kScoreIters; ++it) {
    const int i = tid + it * kThreads;
    const bool live = i < kSW * kSH;
    const int sy = live ? i / kSW : 0, sx = live ? i % kSW : 0;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const bool interior = gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3;
    const float* p = &sim[sy + 3][sx + 3];
    const float c = *p;
    const bool need = live && interior &&
                      compass_pass(p[-3 * kIW], p[3], p[3 * kIW], p[-3], c,
                                   thr);
    float s = inside ? 0.f : -CUDART_INF_F;
    if (__any_sync(0xffffffffu, need) && need) {
      const float r[16] = {p[-3 * kIW],     p[-3 * kIW + 1], p[-2 * kIW + 2],
                           p[-kIW + 3],     p[3],            p[kIW + 3],
                           p[2 * kIW + 2],  p[3 * kIW + 1],  p[3 * kIW],
                           p[3 * kIW - 1],  p[2 * kIW - 2],  p[kIW - 3],
                           p[-3],           p[-kIW - 3],     p[-2 * kIW - 2],
                           p[-3 * kIW - 1]};
      s = fast_score(r, c, thr);
    }
    if (live) ssc[sy][sx] = s;
  }

  // vertical blur pass, kVRows rows of one column a thread
  const float* k = taps.k;
  for (int i = tid; i < kVW * (kTileH / kVRows); i += kThreads) {
    const int c = i % kVW, r0 = (i / kVW) * kVRows;
    float col[kVRows + kTaps - 1];
#pragma unroll
    for (int j = 0; j < kVRows + kTaps - 1; ++j) col[j] = sim[r0 + 1 + j][c + 1];
#pragma unroll
    for (int r = 0; r < kVRows; ++r) {
      float v = __fmul_rn(k[0], col[r]);
#pragma unroll
      for (int j = 1; j < kTaps; ++j) v = __fadd_rn(v, __fmul_rn(k[j], col[r + j]));
      svert[r0 + r][c] = v;
    }
  }
  __syncthreads();

  // NMS and horizontal pass: four neighbouring outputs of one row a thread
  const int oy = tid / (kTileW / 4), ox = (tid % (kTileW / 4)) * 4;
  const int y = y0 + oy, x = x0 + ox;
  if (y >= h || x >= w) return;
  float sr[3][6];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const float4 a = *reinterpret_cast<const float4*>(&ssc[oy + dy][ox]);
    const float2 b = *reinterpret_cast<const float2*>(&ssc[oy + dy][ox + 4]);
    sr[dy][0] = a.x; sr[dy][1] = a.y; sr[dy][2] = a.z; sr[dy][3] = a.w;
    sr[dy][4] = b.x; sr[dy][5] = b.y;
  }
  float vr[4 + kTaps - 1];
  {
    const float4 a = *reinterpret_cast<const float4*>(&svert[oy][ox]);
    const float4 b = *reinterpret_cast<const float4*>(&svert[oy][ox + 4]);
    const float2 c = *reinterpret_cast<const float2*>(&svert[oy][ox + 8]);
    vr[0] = a.x; vr[1] = a.y; vr[2] = a.z; vr[3] = a.w;
    vr[4] = b.x; vr[5] = b.y; vr[6] = b.z; vr[7] = b.w;
    vr[8] = c.x; vr[9] = c.y;
  }
  float so[4], bo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float s = sr[1][e + 1];
    float m = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, sr[dy][e + dx]);
    so[e] = s >= m ? s : 0.f;
    float v = __fmul_rn(k[0], vr[e]);
#pragma unroll
    for (int j = 1; j < kTaps; ++j) v = __fadd_rn(v, __fmul_rn(k[j], vr[e + j]));
    bo[e] = v;
  }
  const size_t o = frame + static_cast<size_t>(y) * w + x;
  if (vec && x + 3 < w) {
    *reinterpret_cast<float4*>(score_out + o) = make_float4(so[0], so[1], so[2], so[3]);
    *reinterpret_cast<float4*>(blur_out + o) = make_float4(bo[0], bo[1], bo[2], bo[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (x + e < w) {
        score_out[o + e] = so[e];
        blur_out[o + e] = bo[e];
      }
    }
  }
}

}  // namespace

// taps: the 7 blur weights, float32, host memory (passed by value)
extern "C" int slam_fast_score_nms_blur(const void* img, void* score_out,
                                        void* blur_out, const float* taps,
                                        int b, int h, int w, float threshold,
                                        void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  Taps t;
  for (int i = 0; i < kTaps; ++i) t.k[i] = taps[i];
  // 16-byte rows: every frame, row and tile start is then 16-byte aligned
  const int vec = w % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(score_out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(blur_out) % 16 == 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  fast_score_nms_blur_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(score_out),
      static_cast<float*>(blur_out), t, h, w, threshold, vec);
  return static_cast<int>(cudaGetLastError());
}
