// Kernel S's first form (a thread a matrix), kept for probe_svd_forms.py
// to time beside the library's: the same bits at every shape and batch.
// Not built into the library that the main paths load.
//
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
// Design: one thread a matrix, G and V in registers or local memory (every
// loop over the schedule is unrolled, so every index is a constant; at n =
// 9 the 162 doubles exceed the registers and spill). Bound on the H100:
// operations, the float64 sums and rotations of every sweep; the matrices
// are a few hundred bytes each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 30;                         // sweeps a matrix at most
constexpr double kTol2 = 1.4210854715202004e-14;    // (2^-23)^2

// position p of the round-robin arrangement of round r, m columns (even)
__host__ __device__ constexpr int slot(int m, int r, int p) {
  return p == 0 ? 0 : 1 + ((p - 1 - r) % (m - 1) + (m - 1)) % (m - 1);
}

__device__ __forceinline__ double dot3(const double (&x)[3],
                                       const double (&y)[3]) {
  return __dadd_rn(__dadd_rn(__dmul_rn(x[0], y[0]), __dmul_rn(x[1], y[1])),
                   __dmul_rn(x[2], y[2]));
}

// one Jacobi rotation of columns i < j of G and V; false if it was skipped
template <int N>
__device__ __forceinline__ bool rotate(double (&g)[N][N], double (&v)[N][N],
                                       int i, int j) {
  double al = __dmul_rn(g[i][0], g[i][0]);
  double be = __dmul_rn(g[j][0], g[j][0]);
  double ga = __dmul_rn(g[i][0], g[j][0]);
#pragma unroll
  for (int k = 1; k < N; ++k) {
    al = __dadd_rn(al, __dmul_rn(g[i][k], g[i][k]));
    be = __dadd_rn(be, __dmul_rn(g[j][k], g[j][k]));
    ga = __dadd_rn(ga, __dmul_rn(g[i][k], g[j][k]));
  }
  if (!(__dmul_rn(ga, ga) > __dmul_rn(__dmul_rn(kTol2, al), be)))
    return false;
  const double zeta = __ddiv_rn(__dsub_rn(be, al), __dadd_rn(ga, ga));
  const double root = __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(zeta, zeta)));
  const double t =
      copysign(__ddiv_rn(1.0, __dadd_rn(fabs(zeta), root)), zeta);
  const double c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
  const double s = __dmul_rn(c, t);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const double x = g[i][k], y = g[j][k];
    g[i][k] = __dsub_rn(__dmul_rn(c, x), __dmul_rn(s, y));
    g[j][k] = __dadd_rn(__dmul_rn(s, x), __dmul_rn(c, y));
    const double p = v[i][k], q = v[j][k];
    v[i][k] = __dsub_rn(__dmul_rn(c, p), __dmul_rn(s, q));
    v[j][k] = __dadd_rn(__dmul_rn(s, p), __dmul_rn(c, q));
  }
  return true;
}

// a: [batch, N, N] row-major; s: [batch, N]; vh: [batch, N, N]; u: [batch,
// 3, 3] (kU, N = 3 only)
template <int N, bool kU>
__global__ void __launch_bounds__(kThreads)
svd_small_kernel(const float* __restrict__ a, float* __restrict__ u,
                 float* __restrict__ s, float* __restrict__ vh, int batch) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float* ab = a + static_cast<size_t>(b) * N * N;
  double g[N][N], v[N][N];  // [column][row]
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      g[c][r] = static_cast<double>(ab[r * N + c]);
      v[c][r] = r == c ? 1.0 : 0.0;
    }
  }
  constexpr int M = N + (N & 1);
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        const int p = slot(M, r, k), q = slot(M, r, M - 1 - k);
        const int i = p < q ? p : q, j = p < q ? q : p;
        if (j < N) rotated |= rotate<N>(g, v, i, j);
      }
    }
    if (!rotated) break;
  }

  double sig[N], key[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    double ss = __dmul_rn(g[c][0], g[c][0]);
#pragma unroll
    for (int k = 1; k < N; ++k) ss = __dadd_rn(ss, __dmul_rn(g[c][k], g[c][k]));
    sig[c] = __dsqrt_rn(ss);
    key[c] = sig[c] == sig[c] ? sig[c] : -1.0;
  }
  int rank[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    int rk = 0;
#pragma unroll
    for (int d = 0; d < N; ++d)
      rk += (key[d] > key[c]) || (d < c && key[d] == key[c]);
    rank[c] = rk;
  }

  bool flip = false;  // v3 changes sign
  if constexpr (kU) {
    double gs[3][3] = {}, sg[3] = {};  // the sorted columns
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (rank[c] == p) {
          sg[p] = sig[c];
#pragma unroll
          for (int k = 0; k < 3; ++k) gs[p][k] = g[c][k];
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
    float* ub = u + static_cast<size_t>(b) * 9;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ub[k * 3 + 0] = __double2float_rn(u1[k]);
      ub[k * 3 + 1] = __double2float_rn(u2[k]);
      ub[k * 3 + 2] = __double2float_rn(u3[k]);
    }
  }

  float* sb = s + static_cast<size_t>(b) * N;
  float* vb = vh + static_cast<size_t>(b) * N * N;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    sb[rank[c]] = __double2float_rn(sig[c]);
    const bool neg = flip && rank[c] == N - 1;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x = __double2float_rn(v[c][k]);
      vb[rank[c] * N + k] = neg ? -x : x;
    }
  }
}

template <int N, bool kU>
void launch(const void* a, void* u, void* s, void* vh, int batch,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((batch + kThreads - 1) /
                                                kThreads);
  svd_small_kernel<N, kU><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<float*>(u),
      static_cast<float*>(s), static_cast<float*>(vh), batch);
}

}  // namespace

// (U [batch, 3, 3] if u is not null (n = 3), S [batch, n], Vh [batch, n, n])
// of the matrices a [batch, n, n], n in {3, 4, 9}
extern "C" int slam_svd_small_thread(const void* a, void* u, void* s, void* vh,
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
