// Kernel G: squared-L2 top-2 nearest neighbours of float32 descriptors over
// a (query frame, target frame) pair list on the descriptor stores, read in
// place. For pair p and query row i of frame qidx[p]:
//   d(i, j) = max(|q_i|^2 - 2 q_i.t_j + |t_j|^2, 0)  over valid targets j of
//             frame tidx[p]
//   d1  = min_j d(i, j),  idx = the lowest j that reaches d1,
//   d2  = min over the other columns (so a duplicate target gives d2 = d1).
// An invalid query row, or one with no valid target, gets (1e30, 0, 1e30);
// with one valid target d2 = 1e30 (the JAX package's reference path:
// matching.knn2 of matching.l2sq_matrix with masked pairs at 1e30).
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _l2_knn2_kernel
// (via l2_knn2). The TPU kernel took the cross term as a bf16 product; here
// the operands stay float32, the precision of the JAX reference path. The
// TPU kernel ran one query tile against one target set; here one launch
// covers a whole pair list (the SfM loop search's 1,176 pairs at 4,000 rows
// would need 2.4 GB as gathered copies).
//
// Design: a block of 8 warps takes 32 query rows of one pair (4 per warp),
// staged in shared memory with their norms; 64 target rows at a time are
// staged beside them (rows padded to 132 floats, so the float4 reads of 8
// neighbouring lanes fall in distinct bank groups). Lane l holds the dot
// products of its warp's 4 rows with targets l and l + 32 of the stage (8
// accumulators, query float4s broadcast from shared memory) and the two
// targets' norms; each lane keeps (d1, idx, d2) per row with a strict '<'
// over its targets in increasing order, and a shuffle merge keeps the
// lexicographically smaller (d1, idx) with d2 = min(winner's d2, loser's
// d1). The distance is formed in the plain version's order with
// __fmul_rn/__fadd_rn/__fsub_rn; dots and norms accumulate with fmaf in
// descriptor order (exact for integer-valued descriptors, where the kernel
// is bitwise equal to the plain version; within 1e-5 otherwise, cuBLAS
// sums in another order).
//
// Bound on the H100: float32 operations, 2 x 128 FLOPs per (query, target)
// pair: 4.8 TFLOP for 1,176 pairs of 4,000 x 4,000 rows, ~72 ms at the
// 67 TFLOP/s SIMT peak. Per 4 descriptor elements a lane issues 4 broadcast
// and 2 float4 shared loads for 32 FMAs; on an H100 SXM at 700 W that runs
// at about 87% of the SIMT peak over all rows. Rows are computed whether
// valid or not: callers pack valid rows first. Later work: a bf16 or TF32
// tensor-core product (wgmma) with a quality check (ROADMAP R14).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kQRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTRows = 64;                     // target rows per stage
constexpr int kDim = 128;
constexpr int kTStride = kDim + 4;
constexpr float kBigF = 1e30f;
constexpr size_t kSmem =
    sizeof(float) * (kQRows * kDim + kTRows * kTStride + kQRows) + kTRows;

// q: [fq, n_q, 128] float; t: [ft, n_t, 128]; vq: [fq, n_q], vt: [ft, n_t]
// uint8; qidx, tidx: [p] int32; d1, d2: [p, n_q] float; idx: [p, n_q] int32.
// Block b handles query rows (b % row_blocks) * kQRows ... of pair
// b / row_blocks.
__global__ void __launch_bounds__(kThreads)
l2_knn2_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vt,
               const int* __restrict__ qidx, const int* __restrict__ tidx,
               float* __restrict__ d1, int* __restrict__ idx,
               float* __restrict__ d2, int n_q, int n_t, int row_blocks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                       // [kQRows][kDim]
  float* st = sq + kQRows * kDim;         // [kTRows][kTStride]
  float* snq = st + kTRows * kTStride;    // [kQRows]
  uint8_t* sv = reinterpret_cast<uint8_t*>(snq + kQRows);  // [kTRows]

  const int pair = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kQRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_base = static_cast<size_t>(qidx[pair]) * n_q;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* t4 = reinterpret_cast<const float4*>(t);
  constexpr int kVec = kDim / 4;

  for (int i = threadIdx.x; i < kQRows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec, row = row0 + r;
    reinterpret_cast<float4*>(sq + r * kDim)[c] =
        row < n_q ? q4[(q_base + row) * kVec + c] : make_float4(0, 0, 0, 0);
  }
  __syncthreads();
  if (threadIdx.x < kQRows) {
    const float* r = sq + threadIdx.x * kDim;
    float s = 0.f;
    for (int k = 0; k < kDim; ++k) s = fmaf(r[k], r[k], s);
    snq[threadIdx.x] = s;
  }

  const int lr = warp * kRowsPerWarp;  // the warp's first local query row
  bool act[kRowsPerWarp];
  bool any = false;
  float b1[kRowsPerWarp], b2[kRowsPerWarp];
  int j1[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + lr + r;
    act[r] = row < n_q && vq[q_base + row] != 0;
    any |= act[r];
    b1[r] = kBigF;
    b2[r] = kBigF;
    j1[r] = 0;
  }

  for (int t0 = 0; t0 < n_t; t0 += kTRows) {
    __syncthreads();  // the previous stage is no longer being read
    for (int i = threadIdx.x; i < kTRows * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec, row = t0 + r;
      reinterpret_cast<float4*>(st + r * kTStride)[c] =
          row < n_t ? t4[(t_base + row) * kVec + c] : make_float4(0, 0, 0, 0);
    }
    if (threadIdx.x < kTRows) {
      const int row = t0 + threadIdx.x;
      sv[threadIdx.x] = row < n_t ? vt[t_base + row] : 0;
    }
    __syncthreads();
    if (!any) continue;  // uniform over the warp
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
    float na = 0.f, nb = 0.f;
    const float* ta_row = st + lane * kTStride;
    const float* tb_row = st + (lane + 32) * kTStride;
#pragma unroll 4
    for (int k = 0; k < kDim; k += 4) {
      const float4 ta = *reinterpret_cast<const float4*>(ta_row + k);
      const float4 tb = *reinterpret_cast<const float4*>(tb_row + k);
      na = fmaf(ta.x, ta.x, na);
      na = fmaf(ta.y, ta.y, na);
      na = fmaf(ta.z, ta.z, na);
      na = fmaf(ta.w, ta.w, na);
      nb = fmaf(tb.x, tb.x, nb);
      nb = fmaf(tb.y, tb.y, nb);
      nb = fmaf(tb.z, tb.z, nb);
      nb = fmaf(tb.w, tb.w, nb);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sq + (lr + r) * kDim + k);
        acc[r][0] = fmaf(qv.x, ta.x, acc[r][0]);
        acc[r][0] = fmaf(qv.y, ta.y, acc[r][0]);
        acc[r][0] = fmaf(qv.z, ta.z, acc[r][0]);
        acc[r][0] = fmaf(qv.w, ta.w, acc[r][0]);
        acc[r][1] = fmaf(qv.x, tb.x, acc[r][1]);
        acc[r][1] = fmaf(qv.y, tb.y, acc[r][1]);
        acc[r][1] = fmaf(qv.z, tb.z, acc[r][1]);
        acc[r][1] = fmaf(qv.w, tb.w, acc[r][1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jl = lane + 32 * h;
      if (t0 + jl >= n_t || !sv[jl]) continue;
      const float nt = h ? nb : na;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!act[r]) continue;
        const float d = fmaxf(
            __fadd_rn(__fsub_rn(snq[lr + r], __fmul_rn(2.f, acc[r][h])), nt),
            0.f);
        if (d < b1[r]) {
          b2[r] = b1[r];
          b1[r] = d;
          j1[r] = t0 + jl;
        } else if (d < b2[r]) {
          b2[r] = d;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    for (int o = 16; o > 0; o >>= 1) {
      const float ob1 = __shfl_xor_sync(0xffffffffu, b1[r], o);
      const int oj1 = __shfl_xor_sync(0xffffffffu, j1[r], o);
      const float ob2 = __shfl_xor_sync(0xffffffffu, b2[r], o);
      if (ob1 < b1[r] || (ob1 == b1[r] && oj1 < j1[r])) {
        b2[r] = fminf(ob2, b1[r]);
        b1[r] = ob1;
        j1[r] = oj1;
      } else {
        b2[r] = fminf(b2[r], ob1);
      }
    }
    const int row = row0 + lr + r;
    if (lane == 0 && row < n_q) {
      const size_t o = static_cast<size_t>(pair) * n_q + row;
      d1[o] = b1[r];
      idx[o] = j1[r];
      d2[o] = b2[r];
    }
  }
}

}  // namespace

extern "C" int slam_l2_knn2(const void* q, const void* t, const void* vq,
                            const void* vt, const void* qidx, const void* tidx,
                            void* d1, void* idx, void* d2, int p, int n_q,
                            int n_t, void* stream) {
  if (p > 0 && n_q > 0) {
    cudaFuncSetAttribute(l2_knn2_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    const int row_blocks = (n_q + kQRows - 1) / kQRows;
    const unsigned blocks = static_cast<unsigned>(p) *
                            static_cast<unsigned>(row_blocks);
    l2_knn2_kernel<<<blocks, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx),
        static_cast<float*>(d1), static_cast<int*>(idx),
        static_cast<float*>(d2), n_q, n_t, row_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
