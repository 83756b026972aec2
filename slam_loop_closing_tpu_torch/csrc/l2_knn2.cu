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
// it keeps float32 accuracy. The TPU kernel ran one query tile against one
// target set; here one launch covers a whole pair list (the SfM loop
// search's 1,176 pairs at 4,000 rows would need 2.4 GB as gathered copies).
//
// Bound on the H100: the cross term's multiply-adds, 128 a valid (query,
// target) row pair. Float32 SIMT runs them at 67 TFLOP/s at best; here they
// run on the tensor cores in 3xTF32: each operand x splits into
// hi = tf32(x) (cvt.rna) and lo = x - hi, and the dot is
// hi.hi' + (hi.lo' + lo.hi') from three mma.sync.m16n8k8 tf32 products with
// float32 accumulators, hi.hi' in four and the two small terms in two more.
// The dropped lo.lo' and lo's own rounding are 2^-21 of |x||x'|: float32
// accuracy. On integer-valued descriptors (0..255) lo is 0 and every
// product and partial sum is an exact integer, so the kernel is bitwise
// equal to the plain version there; on SIFT descriptors d1 and d2 stay
// within 1e-5 of it. Three tf32 products a float32 one, at the card's dense
// tf32 rate (495 TFLOP/s, which wgmma reaches), is the bound; the
// mma.sync.m16n8k8 issued here runs at 55% of that rate alone
// (csrc/probes/probe_rates.py).
//
// Design:
//  * extents, from the validity bytes each block reads anyway: its own query
//    rows' last valid row + 1 and the target frame's (at most n_t bytes, one
//    block reduction; no extents are passed in, no readback). A query block
//    with no valid row writes the invalid-row result and exits; the target
//    stages stop at the target frame's extent. Valid rows need not come
//    first: invalid rows inside an extent are computed and masked.
//  * a block of 8 warps takes 128 query rows of one pair, 16 a warp, held in
//    registers as the A fragments of all 16 k-steps, hi and lo (128
//    registers a thread); one block an SM. When the pair list gives fewer
//    blocks than SMs (the keyframe step's one pair: 12), the target stages
//    are split over several blocks a query block (at least two stages
//    each), and a second kernel merges their (d1, idx, d2) in split order
//    with the same rule as the lanes' merge.
//  * target rows stream through three shared-memory stages of 64 rows
//    (cp.async, two stages ahead). Once a stage has landed, all 256 threads
//    split it in place, four threads a row: hi and lo side by side (rows of
//    272 floats, so the 16-byte fragment reads of a quarter warp fall on all
//    32 banks), and the row's norm in the same pass. The inner loop is then
//    two 16-byte shared loads (four elements of hi and of lo of one target
//    row: the B fragments of two k-steps; the k order inside a step is
//    free, the same on both operands) and six mma.
//  * norms once per row: accumulated in float64 and rounded once to float32
//    (exact for integer-valued descriptors), so |q|^2 and |t|^2 carry no
//    float32 summation error; hi.hi' goes to four accumulators, four k-steps
//    each, which bounds the tensor cores' own accumulation error. A query
//    equal to a target then lands as close to 0 as the plain version does.
//  * the epilogue: the distance in the plain version's order; each lane
//    holds two query rows and two target columns of each 8-column tile and
//    keeps (d1, idx, d2) with a strict '<' over its columns in increasing
//    order, without branches (an inactive query row has norm +inf, an
//    invalid target row norm +inf and zeros for its data, so their
//    distances are +inf and change nothing); a shuffle merge over the 4
//    lanes of a row keeps the lexicographically smaller (d1, idx) with
//    d2 = min(winner's d2, loser's d1). The loop takes two 8-column tiles a
//    step, so one tile's epilogue overlaps the next tile's mma (246
//    registers, no spills); a branchy epilogue sat on the critical path.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQRows = 16 * kWarps;     // query rows a block: one m-tile a warp
constexpr int kTRows = 64;              // target rows a stage
constexpr int kStages = 3;
constexpr int kDim = 128;
constexpr int kQStride = kDim + 16;     // floats a staged query row
constexpr int kLo = kDim + 8;           // a staged target row: hi, then lo
constexpr int kRS = 2 * kDim + 16;      // floats a staged target row
constexpr int kSteps = kDim / 8;        // k-steps of m16n8k8
constexpr int kBig = 4;                 // accumulators of hi.hi'
constexpr int kUnroll = 2;              // tiles a loop step: one tile's
                                        // epilogue overlaps the next's mma
constexpr int kStageFloats = kTRows * kRS;
constexpr float kBigF = 1e30f;
constexpr size_t kSmem =
    sizeof(float) * (kStages * kStageFloats + kStages * kTRows + kQRows);
static_assert(kQRows * kQStride <= kStages * kStageFloats,
              "the query rows are staged in the target stages' space");
static_assert(kThreads == 4 * kTRows, "four threads split a staged row");

// hi = tf32(x) rounded to nearest, ties away; lo = x - hi, exact in float32
// (the mma reads its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  hi = h;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(h)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// |row|^2 of a 128-float row in float64, rounded once
__device__ __forceinline__ float row_norm(const float* row) {
  double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
  for (int k = 0; k < kDim; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + k);
    s[0] = fma(static_cast<double>(v.x), static_cast<double>(v.x), s[0]);
    s[1] = fma(static_cast<double>(v.y), static_cast<double>(v.y), s[1]);
    s[2] = fma(static_cast<double>(v.z), static_cast<double>(v.z), s[2]);
    s[3] = fma(static_cast<double>(v.w), static_cast<double>(v.w), s[3]);
  }
  return static_cast<float>((s[0] + s[1]) + (s[2] + s[3]));
}

// one distance into a lane's (d1, idx, d2), columns in increasing order: a
// strict '<' keeps the lowest index of a tie, and d2 takes the other value;
// +inf (an inactive row or an invalid target) changes nothing
__device__ __forceinline__ void top2(float d, int j, float& b1, int& j1,
                                     float& b2) {
  b2 = fminf(b2, fmaxf(b1, d));
  j1 = d < b1 ? j : j1;
  b1 = fminf(b1, d);
}

// max(|q|^2 - 2 q.t + |t|^2, 0) in the plain version's order (2 q.t is
// exact, so the fused form rounds as the subtract of the product does)
__device__ __forceinline__ float l2_distance(float nq, float dot, float nt) {
  return fmaxf(__fadd_rn(fmaf(-2.f, dot, nq), nt), 0.f);
}

// (b1, j1, b2) of disjoint column sets merged: the lexicographically
// smaller (d1, idx) wins, d2 = min(winner's d2, loser's d1)
__device__ __forceinline__ void merge_top2(float ob1, int oj1, float ob2,
                                           float& b1, int& j1, float& b2) {
  if (ob1 < b1 || (ob1 == b1 && oj1 < j1)) {
    b2 = fminf(ob2, b1);
    b1 = ob1;
    j1 = oj1;
  } else {
    b2 = fminf(b2, ob1);
  }
}

// q: [fq, n_q, 128] float; t: [ft, n_t, 128]; vq: [fq, n_q], vt: [ft, n_t]
// uint8; qidx, tidx: [p] int32; d1, d2: [splits, p, n_q] float; idx:
// [splits, p, n_q] int32.
// Block b handles query rows (b / splits % row_blocks) * kQRows ... of pair
// b / splits / row_blocks against the target stages of split b % splits
// (split_stages stages each).
__global__ void __launch_bounds__(kThreads, 1)
l2_knn2_kernel(const float* __restrict__ q, const float* __restrict__ t,
               const uint8_t* __restrict__ vq, const uint8_t* __restrict__ vt,
               const int* __restrict__ qidx, const int* __restrict__ tidx,
               float* __restrict__ d1, int* __restrict__ idx,
               float* __restrict__ d2, int p, int n_q, int n_t,
               int row_blocks, int splits, int split_stages) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);   // [kStages][kTRows][kRS]
  float* tnorm = stage + kStages * kStageFloats;    // [kStages][kTRows]
  float* qnorm = tnorm + kStages * kTRows;          // [kQRows]

  const int part = blockIdx.x % splits, block = blockIdx.x / splits;
  const int pair = block / row_blocks;
  const int row0 = (block % row_blocks) * kQRows;
  const int qf = qidx[pair], tf = tidx[pair];
  const int q_rows = min(kQRows, n_q - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float* qrows = q + (static_cast<size_t>(qf) * n_q + row0) * kDim;
  const float* trows = t + static_cast<size_t>(tf) * n_t * kDim;
  const uint8_t* qvalid = vq + static_cast<size_t>(qf) * n_q + row0;
  const uint8_t* tvalid = vt + static_cast<size_t>(tf) * n_t;

  // the extents: this block's query rows that may be valid (its last valid
  // row + 1) and the target frame's
  __shared__ int ext[2];
  if (threadIdx.x == 0) ext[0] = ext[1] = 0;
  __syncthreads();
  int eq = 0, et = 0;
  for (int r = threadIdx.x; r < q_rows; r += kThreads)
    if (qvalid[r]) eq = r + 1;
  for (int j = threadIdx.x; j < n_t; j += kThreads)
    if (tvalid[j]) et = j + 1;
  eq = __reduce_max_sync(0xffffffffu, eq);
  et = __reduce_max_sync(0xffffffffu, et);
  if (lane == 0) {
    atomicMax(&ext[0], eq);
    atomicMax(&ext[1], et);
  }
  __syncthreads();
  const int q_end = ext[0], t_end = ext[1];
  const size_t out0 = (static_cast<size_t>(part) * p + pair) * n_q + row0;
  if (q_end == 0) {  // no valid query row in this block
    for (int r = threadIdx.x; r < q_rows; r += kThreads) {
      d1[out0 + r] = kBigF;
      idx[out0 + r] = 0;
      d2[out0 + r] = kBigF;
    }
    return;
  }

  // the query rows (zeros past the extent), their norms, then the fragments
  for (int i = threadIdx.x; i < kQRows * (kDim / 4); i += kThreads) {
    const int r = i / (kDim / 4), c = i % (kDim / 4);
    reinterpret_cast<float4*>(stage + r * kQStride)[c] =
        r < q_end && qvalid[r]
            ? reinterpret_cast<const float4*>(qrows + r * kDim)[c]
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (threadIdx.x < kQRows) qnorm[threadIdx.x] = row_norm(stage + threadIdx.x * kQStride);
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // this lane's query rows
  // A fragment of k-step s: a0 (row g, k = tq), a1 (row g + 8, k = tq),
  // a2 (row g, k = tq + 4), a3 (row g + 8, k = tq + 4); logical k tq and
  // tq + 4 of steps 2u and 2u + 1 are elements 16u + 4tq + {0, 1} and
  // {2, 3}, on both operands
  uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
  for (int u = 0; u < kSteps / 2; ++u) {
    const float4 x0 = *reinterpret_cast<const float4*>(stage + lr0 * kQStride + 16 * u + 4 * tq);
    const float4 x1 = *reinterpret_cast<const float4*>(stage + lr1 * kQStride + 16 * u + 4 * tq);
    split(x0.x, ah[2 * u][0], al[2 * u][0]);
    split(x1.x, ah[2 * u][1], al[2 * u][1]);
    split(x0.y, ah[2 * u][2], al[2 * u][2]);
    split(x1.y, ah[2 * u][3], al[2 * u][3]);
    split(x0.z, ah[2 * u + 1][0], al[2 * u + 1][0]);
    split(x1.z, ah[2 * u + 1][1], al[2 * u + 1][1]);
    split(x0.w, ah[2 * u + 1][2], al[2 * u + 1][2]);
    split(x1.w, ah[2 * u + 1][3], al[2 * u + 1][3]);
  }
  const bool act0 = lr0 < q_end && qvalid[lr0] != 0;
  const bool act1 = lr1 < q_end && qvalid[lr1] != 0;
  const bool warp_active = __any_sync(0xffffffffu, act0 || act1);
  __syncthreads();  // fragments and norms taken: the stage space is free
  // an inactive row's distances are +inf: it keeps (1e30, 0, 1e30)
  const float nq0 = act0 ? qnorm[lr0] : CUDART_INF_F;
  const float nq1 = act1 ? qnorm[lr1] : CUDART_INF_F;

  // this block's target stages: [s_begin, s_end)
  const int s_begin = part * split_stages;
  const int s_end = min((t_end + kTRows - 1) / kTRows, s_begin + split_stages);
  auto issue = [&](int s) {  // stage s, raw, into the lo halves of buffer s % kStages
    float* buf = stage + (s % kStages) * kStageFloats + kLo;
    for (int i = threadIdx.x; i < kTRows * (kDim / 4); i += kThreads) {
      const int r = i / (kDim / 4), c = i % (kDim / 4), row = s * kTRows + r;
      const bool in = row < t_end;  // zeros past the extent
      cp_async16(buf + r * kRS + 4 * c,
                 trows + static_cast<size_t>(in ? row : 0) * kDim + 4 * c,
                 in ? 16 : 0);
    }
  };
  // split stage s in place (four threads a row, every fourth 16-byte chunk)
  // and write its norms: +inf for a row that is not a valid target
  auto prepare = [&](int s) {
    const int r = threadIdx.x >> 2, quarter = threadIdx.x & 3;
    const int j = s * kTRows + r;
    const bool ok = j < t_end && tvalid[j] != 0;
    float* row = stage + (s % kStages) * kStageFloats + r * kRS;
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < kDim / 16; ++i) {
      const int c = 4 * (quarter + 4 * i);
      float4 x = *reinterpret_cast<const float4*>(row + kLo + c);
      if (!ok) x = make_float4(0.f, 0.f, 0.f, 0.f);  // never NaN in a dot
      acc = fma(static_cast<double>(x.x), static_cast<double>(x.x), acc);
      acc = fma(static_cast<double>(x.y), static_cast<double>(x.y), acc);
      acc = fma(static_cast<double>(x.z), static_cast<double>(x.z), acc);
      acc = fma(static_cast<double>(x.w), static_cast<double>(x.w), acc);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(row + c) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(row + kLo + c) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (quarter == 0)
      tnorm[(s % kStages) * kTRows + r] = ok ? static_cast<float>(acc) : CUDART_INF_F;
  };

  float b1[2] = {kBigF, kBigF}, b2[2] = {kBigF, kBigF};
  int j1[2] = {0, 0};
  if (s_begin < s_end) issue(s_begin);
  cp_async_commit();
  if (s_begin + 1 < s_end) issue(s_begin + 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (s_begin < s_end) prepare(s_begin);
  for (int s = s_begin; s < s_end; ++s) {
    // stage s is split with its norms, stage s + 1 has landed, and every
    // warp is done with buffer (s + 2) % kStages
    __syncthreads();
    if (s + 2 < s_end) issue(s + 2);
    cp_async_commit();
    if (s + 1 < s_end) prepare(s + 1);
    if (warp_active) {
      const float* buf = stage + (s % kStages) * kStageFloats;
      const float* nrm = tnorm + (s % kStages) * kTRows;
#pragma unroll kUnroll
      for (int nt = 0; nt < kTRows / 8; ++nt) {  // 8-column tiles
        float big[kBig][4], hl[4], lh[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hl[e] = lh[e] = 0.f;
#pragma unroll
          for (int a = 0; a < kBig; ++a) big[a][e] = 0.f;
        }
        const float* rp = buf + (nt * 8 + g) * kRS + 4 * tq;
#pragma unroll
        for (int u = 0; u < kSteps / 2; ++u) {
          const uint4 bh = *reinterpret_cast<const uint4*>(rp + 16 * u);
          const uint4 bl = *reinterpret_cast<const uint4*>(rp + kLo + 16 * u);
          mma_tf32(big[(2 * u) % kBig], ah[2 * u], bh.x, bh.y);
          mma_tf32(hl, ah[2 * u], bl.x, bl.y);
          mma_tf32(lh, al[2 * u], bh.x, bh.y);
          mma_tf32(big[(2 * u + 1) % kBig], ah[2 * u + 1], bh.z, bh.w);
          mma_tf32(hl, ah[2 * u + 1], bl.z, bl.w);
          mma_tf32(lh, al[2 * u + 1], bh.z, bh.w);
        }
        // accumulator e: row g (e < 2) or g + 8, column 2 tq + (e & 1)
        float dot[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dot[e] = __fadd_rn(__fadd_rn(__fadd_rn(big[0][e], big[1][e]),
                                       __fadd_rn(big[2][e], big[3][e])),
                             __fadd_rn(hl[e], lh[e]));
        const int jl = nt * 8 + 2 * tq;
        const float2 tn = *reinterpret_cast<const float2*>(nrm + jl);
        const int j = s * kTRows + jl;
        top2(l2_distance(nq0, dot[0], tn.x), j, b1[0], j1[0], b2[0]);
        top2(l2_distance(nq0, dot[1], tn.y), j + 1, b1[0], j1[0], b2[0]);
        top2(l2_distance(nq1, dot[2], tn.x), j, b1[1], j1[1], b2[1]);
        top2(l2_distance(nq1, dot[3], tn.y), j + 1, b1[1], j1[1], b2[1]);
      }
    }
    cp_async_wait_all();
  }

  // merge the 4 lanes of each row (lexicographic (d1, idx); d2 keeps the
  // runner-up) and write
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      merge_top2(__shfl_xor_sync(0xffffffffu, b1[r], o),
                 __shfl_xor_sync(0xffffffffu, j1[r], o),
                 __shfl_xor_sync(0xffffffffu, b2[r], o), b1[r], j1[r], b2[r]);
    }
    const int lr = r ? lr1 : lr0;
    if (tq == 0 && row0 + lr < n_q) {
      const size_t o = out0 + lr;
      d1[o] = b1[r];
      idx[o] = j1[r];
      d2[o] = b2[r];
    }
  }
}

// the splits' (d1, idx, d2) of each row merged in split order: [rows]
__global__ void merge_splits_kernel(const float* __restrict__ pd1,
                                    const int* __restrict__ pidx,
                                    const float* __restrict__ pd2,
                                    float* __restrict__ d1,
                                    int* __restrict__ idx,
                                    float* __restrict__ d2, int splits,
                                    size_t rows) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float b1 = pd1[i], b2 = pd2[i];
  int j1 = pidx[i];
  for (int s = 1; s < splits; ++s)
    merge_top2(pd1[s * rows + i], pidx[s * rows + i], pd2[s * rows + i], b1,
               j1, b2);
  d1[i] = b1;
  idx[i] = j1;
  d2[i] = b2;
}

}  // namespace

// splits > 1: the target stages are split over that many blocks a query
// block, whose results go to partial ([3, splits, p, n_q] 32-bit words)
// and are merged by a second, small kernel
extern "C" int slam_l2_knn2(const void* q, const void* t, const void* vq,
                            const void* vt, const void* qidx,
                            const void* tidx, void* d1, void* idx, void* d2,
                            void* partial, int p, int n_q, int n_t,
                            int splits, void* stream) {
  if (p > 0 && n_q > 0) {
    cudaFuncSetAttribute(l2_knn2_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmem));
    const int row_blocks = (n_q + kQRows - 1) / kQRows;
    const int split_stages = ((n_t + kTRows - 1) / kTRows + splits - 1) / splits;
    const size_t rows = static_cast<size_t>(p) * n_q;
    float* pd1 = splits > 1 ? static_cast<float*>(partial) : static_cast<float*>(d1);
    int* pidx = splits > 1 ? reinterpret_cast<int*>(pd1 + splits * rows)
                           : static_cast<int*>(idx);
    float* pd2 = splits > 1 ? reinterpret_cast<float*>(pidx + splits * rows)
                            : static_cast<float*>(d2);
    const unsigned blocks = static_cast<unsigned>(p) *
                            static_cast<unsigned>(row_blocks) *
                            static_cast<unsigned>(splits);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    l2_knn2_kernel<<<blocks, kThreads, kSmem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx), pd1,
        pidx, pd2, p, n_q, n_t, row_blocks, splits, split_stages);
    if (splits > 1)
      merge_splits_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                            s>>>(pd1, pidx, pd2, static_cast<float*>(d1),
                                 static_cast<int*>(idx),
                                 static_cast<float*>(d2), splits, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
