// Kernel N's first form (a warp a segment), kept for
// probe_segment_forms.py to time beside the library's: the same sums, bit
// for bit, one sum a launch.
//
// Computes what slam_loop_closing_tpu_torch/ops/cuda_kernels.py's
// segment_sum_plain computes: out[i] = the sum of values[order[k]] for k =
// offsets[i] .. offsets[i+1] - 1, in ascending k, from 0, each term added
// with __fadd_rn (no FMA, no atomics); an empty segment gives 0. `order` is
// a stable argsort of the row index, so a segment's terms come in
// ascending row order: the sums of a sequential index_add_ on the CPU, bit
// for bit (signed zeros too). Float atomics (CUDA's index_add_) sum in the
// order the rows happen to arrive, which changes from run to run; here the
// bits of a sum depend on its inputs only.
//
// Replaces: no TPU kernel. The JAX package assembles these sums with
// .at[].add, which XLA lowers to a scatter
// (slam_loop_closing_tpu/ops/ba.py:129-189, ops/pgo.py:93-138).
//
// Design: a warp a segment, 8 warps a block; lane c holds component c of
// the sum (and c + 32 for rows wider than 32: the 6x6 blocks). A batch of
// up to kBatch rows is read at once: lane j loads the batch's j-th row
// number, each lane then loads its component of every row of the batch
// into registers (kBatch independent loads), and the next batch's loads
// are issued before the add chain of this one runs, so the chain never
// waits for memory except at a segment's start. A long segment (a camera
// seen thousands of times) stays on one warp: splitting it over warps
// would add partial sums in another order than the CPU's.
//
// Bound on the H100: bytes (each row read once, its row number, the
// offsets, the output written once); the adds are one an input float.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // segments a block

template <int kBatch, bool kWide>
struct Rows {
  float a[kBatch];
  float b[kWide ? kBatch : 1];
};

// this lane's components of rows k0 .. k0 + count - 1 (count <= kBatch)
template <int kBatch, bool kWide>
__device__ __forceinline__ void load_rows(Rows<kBatch, kWide>& r,
                                          const float* __restrict__ values,
                                          const int* __restrict__ order,
                                          int k0, int count, int d,
                                          int lane) {
  const int mine = lane < count ? __ldg(order + k0 + lane) : 0;
  const bool has_a = lane < d, has_b = kWide && lane + 32 < d;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const size_t row =
        static_cast<size_t>(__shfl_sync(0xffffffffu, mine, j)) * d;
    r.a[j] = (j < count && has_a) ? __ldg(values + row + lane) : 0.0f;
    if (kWide)
      r.b[j] = (j < count && has_b) ? __ldg(values + row + lane + 32) : 0.0f;
  }
}

// values [E, d], order [E] (a stable argsort of the rows' segment), offsets
// [n + 1]: out [n, d]. kWide: d in 33..64, else d <= 32.
template <int kBatch, bool kWide>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ values,
                   const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ out,
                   int n, int d) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n) return;
  const int begin = __ldg(offsets + seg), end = __ldg(offsets + seg + 1);
  float acc_a = 0.0f, acc_b = 0.0f;
  Rows<kBatch, kWide> cur;
  load_rows(cur, values, order, begin, min(kBatch, end - begin), d, lane);
  for (int k0 = begin; k0 < end; k0 += kBatch) {
    const int count = min(kBatch, end - k0);
    // the next batch's loads in flight while this batch's adds run (none
    // past the segment's end)
    Rows<kBatch, kWide> next;
    load_rows(next, values, order, k0 + kBatch,
              max(0, min(kBatch, end - k0 - kBatch)), d, lane);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < count) {
        acc_a = __fadd_rn(acc_a, cur.a[j]);
        if (kWide) acc_b = __fadd_rn(acc_b, cur.b[j]);
      }
    }
    cur = next;
  }
  float* o = out + static_cast<size_t>(seg) * d;
  if (lane < d) o[lane] = acc_a;
  if (kWide && lane + 32 < d) o[lane + 32] = acc_b;
}

}  // namespace

// out [n, d] float32 from values [E, d] float32, order [E] int32 and
// offsets [n + 1] int32 (d <= 64).
extern "C" int slam_segment_sum_warp(const void* values, const void* order,
                                const void* offsets, void* out, int n, int d,
                                void* stream) {
  if (n > 0) {
    if (d < 1 || d > 64) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>((n + kWarps - 1) / kWarps);
    const auto* v = static_cast<const float*>(values);
    const auto* o = static_cast<const int*>(order);
    const auto* off = static_cast<const int*>(offsets);
    auto* y = static_cast<float*>(out);
    if (d > 32)
      segment_sum_kernel<16, true><<<grid, kWarps * 32, 0, s>>>(v, o, off, y,
                                                               n, d);
    else
      segment_sum_kernel<32, false><<<grid, kWarps * 32, 0, s>>>(v, o, off,
                                                                y, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
