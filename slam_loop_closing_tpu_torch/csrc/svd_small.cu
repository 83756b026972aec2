// Kernel S: a batched one-sided (Hestenes) Jacobi SVD of float32 n x n
// matrices, n in {3, 4, 9}: the essential and fundamental matrices (3 x 3),
// the DLT systems of triangulation (4 x 4) and the R of the 8-point solve's
// QR (9 x 9).
//
// Computes what slam_loop_closing_tpu_torch/ops/cuda_kernels.py's
// svd_small_plain computes, bit for bit. For each matrix A, with G = A and
// V = I (both kept by column, in float64):
// - Sweeps of the round-robin ordering: with m = n rounded up to even, round
//   r (0 .. m - 2) pairs the positions k and m - 1 - k of the arrangement
//   arr_r[0] = 0, arr_r[p] = 1 + (p - 1 - r) mod (m - 1); a pair (i, j),
//   i < j, with j = n (odd n) is skipped. The pairs of a round touch
//   disjoint columns, so the plain version runs a round as one batched op.
// - A pair: alpha = sum_k g_ki^2, beta = sum_k g_kj^2, gamma = sum_k g_ki
//   g_kj, k ascending from the first product. The pair is rotated only
//   while gamma^2 > tol^2 alpha beta, tol = 2^-23 (the columns are then
//   orthogonal to float32's precision); then zeta = (beta - alpha) / (2
//   gamma), t = copysign(1 / (|zeta| + sqrt(1 + zeta^2)), zeta), c = 1 /
//   sqrt(1 + t^2), s = c t, and g_i <- c g_i - s g_j, g_j <- s g_i + c g_j
//   (and so for V), each product and add rounded on its own. |zeta| <=
//   sqrt(beta / alpha) / (2 tol), so zeta^2 overflows only for a column
//   below about 1e-150, far under what float32 inputs produce (and then t =
//   0: a rotation that moves nothing). NaN or inf columns fail the rotation
//   test and are left as they are.
// - A matrix stops after the first sweep that rotates nothing, or after
//   kSweeps. A skipped rotation leaves the bits as they were, so a sweep
//   after that one would rotate nothing either: the plain version runs the
//   whole batch until every matrix has had such a sweep, and each matrix
//   gets the kernel's bits.
// - sigma_i = sqrt(sum_k g_ki^2). Columns are sorted by descending sigma,
//   stably (a tie keeps column order; a NaN sigma sorts last), so a zero
//   matrix gives V = I, as LAPACK does. S is sigma in that order, the rows
//   of Vh the columns of V.
// - U (n = 3 only): u1 = g1 / sigma1 and u2 = g2 / sigma2 from the sorted
//   columns; a zero sigma takes a column of the identity instead (u1 = e1;
//   u2 from e_k, k the first index of the smallest |u1_k|, with its u1
//   component removed and normalized), and u3 = u1 x u2, so det U = +1 and
//   no division by a zero sigma3. v3 changes sign where g3 . u3 < 0 (g3 =
//   A v3), so that U diag(S) Vh = A still holds.
// - U, S and Vh are rounded to float32 at the end.
// Float64 throughout, because float32 rotations leave V about 1e-6 from
// the exact singular vectors, as far as LAPACK's float32 SVD is: the 8-point
// refits then move a point at the Sampson gate as often as not; in float64
// the vectors are exact to the output's rounding. Everything is written
// with the _rn intrinsics: nothing is contracted into an FMA, and the bits
// of a matrix's result depend on that matrix only, not on its batch or its
// neighbours.
//
// Replaces: no TPU kernel. The JAX package computes these SVDs with
// jnp.linalg.svd, left to XLA (slam_loop_closing_tpu/ops/epipolar.py:106,
// :129, :165, :199). The port ran them through torch.linalg.svd, whose
// cuSOLVER path reads its convergence info back to the host twice a call.
//
// Design: a group of P lanes a matrix, a lane a pair of each round. P is
// the real pairs of a round (n / 2: 4 at n = 9, 2 at n = 4, 1 at n = 3), so
// a round costs one pair's latency, not P: the parameters of a rotation
// are a strict chain of two divisions, two square roots and a third
// division, in float64 software sequences, and one thread could not
// overlap one pair's chain with the next. A warp holds 32 / P groups (no
// group straddles a warp), a block is kThreads threads, and the grid gives
// every matrix exactly one group. Lane p of round r takes the p-th real
// pair (lane_pair below; tests/test_torch_svd_small.py mirrors it): its sums,
// test, parameters and rotation are exactly the thread form's, in the same
// order, and the pairs of a round touch disjoint columns, so running them
// at once changes no bit. The warp syncs after each round, and a sweep's
// "rotated" is the warp's __any_sync (see the kernel). G and V (and then
// sigma) live in shared memory by column, 2 n^2 + n doubles a matrix
// (1,368 bytes at n = 9); a lane loads its two columns of G into
// registers, and its two of V once the chain is done, so nothing spills
// (the thread form held all of G and V: 255 registers and 7.3 KB of
// spills a thread at n = 9). A group of one lane (n = 3) keeps its
// matrix in registers, as the thread form did. The tail spreads
// over the group: lane p takes the columns p, p + P, ... for sigma, its
// rank (sigma read back from shared memory) and its row of S and Vh; U (n
// = 3) is one lane's. Bound on the H100: the latency of the chain of
// rounds (sweeps x rounds x one pair's dependent arithmetic: its sums, its
// test, its parameters and its rotation, fixed by the bits), far above the
// float64 rate's bound at these batches; the matrices are a few hundred
// bytes each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;                        // threads a block
constexpr int kSweeps = 30;                         // sweeps a matrix at most
constexpr double kTol2 = 1.4210854715202004e-14;    // (2^-23)^2

// position p of the round-robin arrangement of round r, m columns (even)
__host__ __device__ constexpr int slot(int m, int r, int p) {
  return p == 0 ? 0 : 1 + ((p - 1 - r) % (m - 1) + (m - 1)) % (m - 1);
}

// lanes a matrix: the real pairs of a round
__host__ __device__ constexpr int lanes(int n) { return n / 2; }

// a group of one lane keeps its matrix in registers, not shared memory
__host__ __device__ constexpr bool in_registers(int n) {
  return lanes(n) == 1;
}

// doubles a matrix takes in shared memory: G and V by column, then sigma;
// odd, so that the groups of a warp start on different banks
__host__ __device__ constexpr int footprint(int n) {
  return (2 * n * n + n) | 1;
}

struct Pair {
  int i, j;
};

// the pair (i, j), i < j, of lane p in round r: the p-th of the round's
// pairs (k, m - 1 - k), in ascending k, that does not hold the padding
// column m - 1 of an odd n (at position r of round r >= 1, at m - 1 of
// round 0)
__host__ __device__ constexpr Pair lane_pair(int n, int r, int p) {
  const int m = n + (n & 1);
  const int q = r == 0 ? m - 1 : r;
  const int pad = q < m - 1 - q ? q : m - 1 - q;
  const int k = (n & 1) && p >= pad ? p + 1 : p;
  const int x = slot(m, r, k), y = slot(m, r, m - 1 - k);
  return Pair{x < y ? x : y, x < y ? y : x};
}

// one matrix's columns of G and V, and its sigma: in registers (a group of
// one lane: every index is a constant once the loops are unrolled) or in
// the group's part of shared memory
template <int N, bool kShared>
struct Columns {
  double g_[N][N], v_[N][N], s_[N];
  __device__ explicit Columns(double*) {}
  __device__ double* g(int c) { return g_[c]; }
  __device__ double* v(int c) { return v_[c]; }
  __device__ double* sig() { return s_; }
};

template <int N>
struct Columns<N, true> {
  double* base;
  __device__ explicit Columns(double* b) : base(b) {}
  __device__ double* g(int c) { return base + c * N; }
  __device__ double* v(int c) { return base + (N + c) * N; }
  __device__ double* sig() { return base + 2 * N * N; }
};

__device__ __forceinline__ double dot3(const double* x, const double* y) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x[0], y[0]), __dmul_rn(x[1], y[1])),
                   __dmul_rn(x[2], y[2]));
}

// one Jacobi rotation of columns (gi, gj) of G and (vi, vj) of V, i < j;
// false if it was skipped
template <int N>
__device__ __forceinline__ bool rotate(double* gi, double* gj, double* vi,
                                       double* vj) {
  double x[N], y[N], p[N], q[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = gi[k];
    y[k] = gj[k];
  }
  double al = __dmul_rn(x[0], x[0]);
  double be = __dmul_rn(y[0], y[0]);
  double ga = __dmul_rn(x[0], y[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    al = __dadd_rn(al, __dmul_rn(x[k], x[k]));
    be = __dadd_rn(be, __dmul_rn(y[k], y[k]));
    ga = __dadd_rn(ga, __dmul_rn(x[k], y[k]));
  }
  if (!(__dmul_rn(ga, ga) > __dmul_rn(__dmul_rn(kTol2, al), be)))
    return false;
  const double zeta = __ddiv_rn(__dsub_rn(be, al), __dadd_rn(ga, ga));
  const double root = __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(zeta, zeta)));
  const double t =
      copysign(__ddiv_rn(1.0, __dadd_rn(fabs(zeta), root)), zeta);
  const double c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
  const double s = __dmul_rn(c, t);
  // V's columns only now: held across the chain's calls they spill
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[k] = vi[k];
    q[k] = vj[k];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    gi[k] = __dsub_rn(__dmul_rn(c, x[k]), __dmul_rn(s, y[k]));
    gj[k] = __dadd_rn(__dmul_rn(s, x[k]), __dmul_rn(c, y[k]));
    vi[k] = __dsub_rn(__dmul_rn(c, p[k]), __dmul_rn(s, q[k]));
    vj[k] = __dadd_rn(__dmul_rn(s, p[k]), __dmul_rn(c, q[k]));
  }
  return true;
}

// a: [batch, N, N] row-major; s: [batch, N]; vh: [batch, N, N]; u: [batch,
// 3, 3] (kU, N = 3 only). Matrix b is the group of threads b P .. b P + P -
// 1 of the grid; its shared memory is its group's slot of the block's.
// A warp of several groups syncs and stops as one (__syncwarp and
// __any_sync over all its lanes: groups that sync apart diverge, and their
// chains then run one after another), so it runs until every group of it
// has had a quiet sweep, which changes no bit; its groups past the batch
// run on zeros and store nothing. A lane that is its own group (n = 3)
// stops on its own, and returns at once past the batch, as the thread
// form did. At least one block an SM (__launch_bounds__'s second
// argument) lets ptxas use the registers that keep the 3 x 3 tail with U
// from spilling.
template <int N, bool kU>
__global__ void __launch_bounds__(kThreads, 1)
svd_small_kernel(const float* __restrict__ a, float* __restrict__ u,
                 float* __restrict__ s, float* __restrict__ vh, int batch) {
  constexpr int P = lanes(N);
  constexpr int M = N + (N & 1);
  constexpr int kCols = (N + P - 1) / P;  // columns a lane finishes
  static_assert(32 % P == 0, "a group must not straddle a warp");
  static_assert(!kU || P == 1, "U for 3 x 3 matrices only");
  extern __shared__ double smem[];
  // the lane's index: in 32 bits at one lane a matrix (the batch is below
  // 2^31), where 64 bits cost 20-30 ns a 3 x 3 launch (probe_svd_forms.py)
  using Index = typename std::conditional<P == 1, int, long long>::type;
  const Index t = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  const long long b = t / P;
  const bool live = b < batch;
  // a lane of its own returns past the batch (else its tail would run
  // beside a live lane's sweeps); a warp of groups, when it has no matrix
  if (P == 1 ? !live : (t & ~31ll) / P >= batch) return;
  const int p = threadIdx.x % P;
  Columns<N, !in_registers(N)> m(smem + threadIdx.x / P * footprint(N));

  const float* ab = a + b * N * N;
#pragma unroll
  for (int e = p; e < N * N; e += P) {
    const int r = e / N, c = e % N;
    m.g(c)[r] = live ? static_cast<double>(ab[e]) : 0.0;
    m.v(c)[r] = r == c ? 1.0 : 0.0;
  }
  if constexpr (P > 1) __syncwarp();
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      const Pair ij = lane_pair(N, r, p);
      rotated |= rotate<N>(m.g(ij.i), m.g(ij.j), m.v(ij.i), m.v(ij.j));
      if constexpr (P > 1) __syncwarp();
    }
    if constexpr (P > 1) rotated = __any_sync(0xffffffffu, rotated);
    if (!rotated) break;
  }

  double* sig = m.sig();
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = p + t * P;
    if (c < N) {
      const double* gc = m.g(c);
      double ss = __dmul_rn(gc[0], gc[0]);
#pragma unroll
      for (int k = 1; k < N; ++k) ss = __dadd_rn(ss, __dmul_rn(gc[k], gc[k]));
      sig[c] = __dsqrt_rn(ss);
    }
  }
  if constexpr (P > 1) __syncwarp();
  int rank[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = p + t * P;
    rank[t] = 0;
    if (c < N) {
      const double kc = sig[c] == sig[c] ? sig[c] : -1.0;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        const double kd = sig[d] == sig[d] ? sig[d] : -1.0;
        rank[t] += (kd > kc) || (d < c && kd == kc);
      }
    }
  }

  if (!live) return;
  bool flip = false;  // v3 changes sign
  if constexpr (kU) {
    double gs[3][3] = {}, sg[3] = {};  // the sorted columns
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (rank[c] == q) {
          sg[q] = sig[c];
#pragma unroll
          for (int k = 0; k < 3; ++k) gs[q][k] = m.g(c)[k];
        }
      }
    }
    double u1[3], u2[3], u3[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      u1[k] = sg[0] > 0.0 ? __ddiv_rn(gs[0][k], sg[0]) : (k == 0 ? 1.0 : 0.0);
    if (sg[1] > 0.0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) u2[k] = __ddiv_rn(gs[1][k], sg[1]);
    } else {
      // e_k less its u1 component, k the first smallest |u1_k|
      int kk = fabs(u1[1]) < fabs(u1[0]) ? 1 : 0;
      const double uk0 = kk == 1 ? u1[1] : u1[0];
      kk = fabs(u1[2]) < fabs(uk0) ? 2 : kk;
      const double uk = kk == 2 ? u1[2] : uk0;
      double w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = __dsub_rn(k == kk ? 1.0 : 0.0, __dmul_rn(uk, u1[k]));
      const double nrm = __dsqrt_rn(dot3(w, w));
#pragma unroll
      for (int k = 0; k < 3; ++k) u2[k] = __ddiv_rn(w[k], nrm);
    }
    u3[0] = __dsub_rn(__dmul_rn(u1[1], u2[2]), __dmul_rn(u1[2], u2[1]));
    u3[1] = __dsub_rn(__dmul_rn(u1[2], u2[0]), __dmul_rn(u1[0], u2[2]));
    u3[2] = __dsub_rn(__dmul_rn(u1[0], u2[1]), __dmul_rn(u1[1], u2[0]));
    flip = dot3(gs[2], u3) < 0.0;
    float* ub = u + b * 9;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ub[k * 3 + 0] = __double2float_rn(u1[k]);
      ub[k * 3 + 1] = __double2float_rn(u2[k]);
      ub[k * 3 + 2] = __double2float_rn(u3[k]);
    }
  }

  float* sb = s + b * N;
  float* vb = vh + b * N * N;
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = p + t * P;
    if (c < N) {
      sb[rank[t]] = __double2float_rn(sig[c]);
      const bool neg = flip && rank[t] == N - 1;
      const double* vc = m.v(c);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float x = __double2float_rn(vc[k]);
        vb[rank[t] * N + k] = neg ? -x : x;
      }
    }
  }
}

// a group of lanes(N) threads a matrix, kThreads a block
template <int N, bool kU>
void launch(const void* a, void* u, void* s, void* vh, int batch,
            cudaStream_t stream) {
  const long long lanes_needed = static_cast<long long>(batch) * lanes(N);
  const unsigned blocks =
      static_cast<unsigned>((lanes_needed + kThreads - 1) / kThreads);
  const size_t shared =
      in_registers(N) ? 0 : kThreads / lanes(N) * footprint(N) * sizeof(double);
  svd_small_kernel<N, kU><<<blocks, kThreads, shared, stream>>>(
      static_cast<const float*>(a), static_cast<float*>(u),
      static_cast<float*>(s), static_cast<float*>(vh), batch);
}

}  // namespace

// (U [batch, 3, 3] if u is not null (n = 3), S [batch, n], Vh [batch, n, n])
// of the matrices a [batch, n, n], n in {3, 4, 9}
extern "C" int slam_svd_small(const void* a, void* u, void* s, void* vh,
                              int n, int batch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch > 0) {
    if (n == 3 && u != nullptr) {
      launch<3, true>(a, u, s, vh, batch, st);
    } else if (n == 3) {
      launch<3, false>(a, u, s, vh, batch, st);
    } else if (n == 4 && u == nullptr) {
      launch<4, false>(a, u, s, vh, batch, st);
    } else if (n == 9 && u == nullptr) {
      launch<9, false>(a, u, s, vh, batch, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
