// Latencies behind kernel S, for probe_svd_forms.py: one thread times, with
// clock64() and the global timer, many repetitions of one piece of a lane's
// work, each repetition waiting on the one before:
//   which 0: the loop's carry alone (x <- x0 + x * 0: a multiply and an
//            add), the overhead of which 1;
//   which 1: a rotation's parameter chain (zeta, the two square roots, the
//            three divisions, s), its result carried as in which 0;
//   which 2: one whole pair of an n x n matrix (n = 3, 4 or 9) as a lane of
//            kernel S runs it (rotate<n> of csrc/svd_small.cu: its columns
//            of G and V loaded
//            from shared memory, the three sums, the test, the chain and
//            the rotation stored back), on fresh columns each time: a
//            repetition first copies one of 16 column sets into the
//            working columns;
//   which 3: the copy of which 2 alone, its overhead;
//   which 4: one pair's dependent arithmetic alone (rotate<n> on columns
//            held in registers: no shared-memory load or store), the
//            same set each time; the first entry of each of its two
//            columns of G waits on the last repetition's result as the
//            carry of which 0 does, so the sums, the test, the chain and
//            the rotation run as one dependent line.
// The pair takes (which 2) - (which 3), its arithmetic (which 4) - (which
// 0), the chain (which 1) - (which 0).
// times: [cycles, nanoseconds, rotations] of the `iters` repetitions.

#include "../svd_small.cu"

namespace {

constexpr int kSets = 16;
constexpr int kSet = 4 * 9;  // the columns i, j of G and of V

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void chain_kernel(const double* __restrict__ in, double* out,
                             long long* times, int iters, int which, int n) {
  __shared__ double sets[kSets][kSet], work[kSet];
  for (int s = 0; s < kSets; ++s)
    for (int e = 0; e < kSet; ++e) sets[s][e] = in[s * kSet + e];
  const double al = in[kSets * kSet], be = in[kSets * kSet + 1];
  const double ga0 = in[kSets * kSet + 2];
  double x = ga0;
  long long rotations = 0;
  int k = 0;
  const long long c0 = clock64(), t0 = global_ns();
  if (which == 0) {
#pragma unroll 1
    for (int it = 0; it < iters; ++it) x = __dadd_rn(ga0, __dmul_rn(x, 0.0));
  } else if (which == 1) {
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      const double ga = x;
      const double zeta = __ddiv_rn(__dsub_rn(be, al), __dadd_rn(ga, ga));
      const double root = __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(zeta, zeta)));
      const double t =
          copysign(__ddiv_rn(1.0, __dadd_rn(fabs(zeta), root)), zeta);
      const double c =
          __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
      const double s = __dmul_rn(c, t);
      x = __dadd_rn(ga0, __dmul_rn(s, 0.0));
    }
  } else {
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int e = 0; e < kSet; ++e) work[e] = sets[k][e];
      if (which == 2 && n == 9)
        rotations += rotate<9>(work, work + 9, work + 18, work + 27);
      else if (which == 2 && n == 4)
        rotations += rotate<4>(work, work + 4, work + 8, work + 12);
      else if (which == 2)
        rotations += rotate<3>(work, work + 3, work + 6, work + 9);
      // the next set waits on this one's result
      k = (it + 1 + (work[0] > 1e300)) % kSets;
    }
    x = work[0];
  }
  const long long c1 = clock64(), t1 = global_ns();
  out[0] = x;
  times[0] = c1 - c0;
  times[1] = t1 - t0;
  times[2] = rotations;
}

// which 4 at n = N: set 0's columns in registers
template <int N>
__global__ void pair_regs_kernel(const double* __restrict__ in, double* out,
                                 long long* times, int iters) {
  double base[4 * N], w[4 * N];
#pragma unroll
  for (int e = 0; e < 4 * N; ++e) base[e] = in[e];
  double x = 0.0;
  long long rotations = 0;
  const long long c0 = clock64(), t0 = global_ns();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int e = 0; e < 4 * N; ++e)
      w[e] = e == 0 || e == N ? __dadd_rn(base[e], __dmul_rn(x, 0.0))
                              : base[e];
    rotations += rotate<N>(w, w + N, w + 2 * N, w + 3 * N);
    x = w[0];
  }
  const long long c1 = clock64(), t1 = global_ns();
  double sum = 0.0;  // keeps every rotated column
#pragma unroll
  for (int e = 0; e < 4 * N; ++e) sum = __dadd_rn(sum, w[e]);
  out[0] = sum;
  times[0] = c1 - c0;
  times[1] = t1 - t0;
  times[2] = rotations;
}

}  // namespace

// in: 16 sets of columns (G i, G j, V i, V j: 4 x 9 doubles each; the
// first 4 n of a set at n < 9), then (alpha, beta, gamma) for the chain;
// out: 1 double; times: 3 int64
extern "C" int slam_svd_chain(const void* in, void* out, void* times,
                              int iters, int which, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* src = static_cast<const double*>(in);
  double* dst = static_cast<double*>(out);
  long long* tm = static_cast<long long*>(times);
  if (which == 4 && n == 9)
    pair_regs_kernel<9><<<1, 1, 0, st>>>(src, dst, tm, iters);
  else if (which == 4 && n == 4)
    pair_regs_kernel<4><<<1, 1, 0, st>>>(src, dst, tm, iters);
  else if (which == 4)
    pair_regs_kernel<3><<<1, 1, 0, st>>>(src, dst, tm, iters);
  else
    chain_kernel<<<1, 1, 0, st>>>(src, dst, tm, iters, which, n);
  return static_cast<int>(cudaGetLastError());
}
