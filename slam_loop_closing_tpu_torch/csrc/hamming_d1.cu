// Kernel I (hamming_d1_kernel). d1-only Hamming nearest neighbour over
// 256-bit descriptors packed as eight 32-bit words, for a list of frame
// pairs: for pair p and every query row i of frame qidx[p],
//   d1[p, i] = min_j hamming(q_i, t_j)   over the valid rows j of frame tidx[p]
// and 2^30 where the target frame has no valid row. No index, and no query
// validity: the caller's count rule applies it.
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _hamming_d1_kernel
// (via hamming_nn_d1 and good_count_pair_pallas). The TPU kernel took the
// maximum of the raw +-1 int8 dot on its matrix unit, one frame pair per
// call; here the distances come from the tensor cores' b1 and-popc product
// on the packed words (hamming_mma.cuh) and the pair list indexes the
// descriptor stores in place, so the dense all-pairs scan of a sequence is
// one launch per chunk of pairs with no gathered copy.
//
// Design: one block of 256 threads per (pair, slab of 1,024 query rows, split
// of the target rows); the block's work is hamming_mma.cuh's
// nearest_valid_distance. With many pairs (the dense scan) there is one
// split and the block writes d1 itself. With few pairs (one 8192 x 8192 call
// is 8 slabs) the target rows are split over blocks to fill the card; each
// split writes its minima to a scratch buffer and a second small kernel takes
// the minimum over splits. No atomics: the result is deterministic and
// bitwise equal to the plain version.
//
// Bound on the H100: the tensor cores' b1 rate (see hamming_mma.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hamming_mma.cuh"

namespace {

using hamming_mma::kSlab;
using hamming_mma::kThreads;

constexpr int kBig = 1 << 30;  // d1 of a row with no valid target

// q: [fq, n_q, 8] words; t: [ft, n_t, 8] words; vt: [ft, n_t] uint8;
// qidx, tidx: [p] int32; out: [splits, p, n_q] int32.
// blockIdx.x = (pair * slabs + slab) * splits + split; split s scans target
// rows [s * split_len, min(n_t, (s + 1) * split_len)).
__global__ void __launch_bounds__(kThreads, hamming_mma::kMinBlocks)
hamming_d1_kernel(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ t,
                  const uint8_t* __restrict__ vt,
                  const int* __restrict__ qidx, const int* __restrict__ tidx,
                  int* __restrict__ out, int p_cnt, int n_q, int n_t,
                  int slabs, int splits, int split_len) {
  __shared__ __align__(16) unsigned char smem[hamming_mma::kSmemBytes];

  const int split = blockIdx.x % splits;
  const int slab = (blockIdx.x / splits) % slabs;
  const int pair = blockIdx.x / (splits * slabs);
  const uint32_t* qf = q + static_cast<size_t>(qidx[pair]) * n_q * 8;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  const int t_begin = split * split_len;
  int* o = out + (static_cast<size_t>(split) * p_cnt + pair) * n_q;
  hamming_mma::nearest_valid_distance(
      qf, n_q, slab * kSlab, t + t_base * 8, vt + t_base, t_begin,
      min(n_t, t_begin + split_len), smem,
      [o](int row, int d) { o[row] = d < 257 ? d : kBig; });
}

// out[i] = min over s of partial[s, i], i < total
__global__ void __launch_bounds__(kThreads)
min_over_splits_kernel(const int* __restrict__ partial, int* __restrict__ out,
                       long long total, int splits) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  int v = partial[i];
  for (int s = 1; s < splits; ++s) v = min(v, partial[s * total + i]);
  out[i] = v;
}

// out[i, j] = popc(q_i & t_j), rows [0, 64) of each: the raw tile product
__global__ void tile_product_kernel(const uint32_t* __restrict__ q,
                                    const uint32_t* __restrict__ t,
                                    int* __restrict__ out) {
  hamming_mma::tile_product_64(q, t, out);
}

}  // namespace

// d1 [p, n_q] of the frame pairs (qidx[p], tidx[p]). With splits == 1 the
// kernel writes d1 and `partial` is not read; with splits > 1 `partial` is a
// [splits, p, n_q] int32 scratch buffer the caller allocated.
extern "C" int slam_hamming_d1(const void* q, const void* t, const void* vt,
                               const void* qidx, const void* tidx, void* d1,
                               void* partial, int p, int n_q, int n_t,
                               int splits, void* stream) {
  if (p > 0 && n_q > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int slabs = (n_q + kSlab - 1) / kSlab;
    if (splits < 1) splits = 1;
    const int split_len = (n_t + splits - 1) / splits;
    const long long blocks = static_cast<long long>(p) * slabs * splits;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    int* dst = static_cast<int*>(splits > 1 ? partial : d1);
    hamming_d1_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
        static_cast<const uint8_t*>(vt), static_cast<const int*>(qidx),
        static_cast<const int*>(tidx), dst, p, n_q, n_t, slabs, splits,
        split_len);
    if (splits > 1) {
      const long long total = static_cast<long long>(p) * n_q;
      const long long rb = (total + kThreads - 1) / kThreads;
      min_over_splits_kernel<<<static_cast<unsigned>(rb), kThreads, 0, s>>>(
          static_cast<const int*>(partial), static_cast<int*>(d1), total,
          splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Layout check of the tensor-core product: out [64, 64] int32 =
// popc(q_i & t_j) of the first 64 rows of q and t ([>= 64, 8] words each),
// through the fragment loads and the mma of hamming_mma.cuh.
extern "C" int slam_hamming_tile_product(const void* q, const void* t,
                                         void* out, void* stream) {
  tile_product_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
