// Probe of the instruction rates that the kernels' bounds need, in
// registers only: float min/max (FMNMX, kernel A's arc extrema and NMS),
// FFMA (the float32 pipe that also issues kernel A's blur multiplies and
// adds), and mma.sync.m16n8k8 tf32 (kernel G's 3xTF32 cross term). Each
// thread runs kChains independent dependency chains, so enough warps an SM
// keep every pipe busy. Built and timed by probe_rates.py; not part of the
// library.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

// kind 0: fminf/fmaxf; 1: fmaf; 2: mma.sync m16n8k8 tf32. Every warp runs
// iters x 2 x kChains FMNMX or FFMA a thread, or iters x kChains mma.
__global__ void __launch_bounds__(kThreads)
rate_kernel(int kind, int iters, float* __restrict__ out) {
  const float seed = static_cast<float>(threadIdx.x + blockIdx.x) * 1e-3f;
  float x[kChains], y[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    x[c] = seed + c;
    y[c] = seed - c;
  }
  if (kind == 0) {
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) x[c] = fminf(x[c], y[(c + 1) % kChains]);
#pragma unroll
      for (int c = 0; c < kChains; ++c) y[c] = fmaxf(y[c], x[(c + 3) % kChains]);
    }
  } else if (kind == 1) {
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) x[c] = fmaf(x[c], y[(c + 1) % kChains], 0.5f);
#pragma unroll
      for (int c = 0; c < kChains; ++c) y[c] = fmaf(y[c], x[(c + 3) % kChains], -0.5f);
    }
  } else {
    float acc[kChains][4];
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
    const uint32_t a0 = __float_as_uint(seed), a1 = a0 ^ 0x5555u,
                   a2 = a0 ^ 0xaaaau, a3 = a0 + 0x1000u;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const uint32_t b0 = a0 + (c << 13), b1 = a1 + (i << 13);
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += x[c] + y[c];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// out: [blocks * 256] float
extern "C" int probe_rate(int kind, int blocks, int iters, void* out,
                          void* stream) {
  rate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      kind, iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
