// Two Hamming nearest-neighbour kernels over 256-bit descriptors packed as
// eight 32-bit words.
//
// Kernel D (hamming_nn_kernel). Hamming nearest neighbour: for every query
// row i of M 256-bit descriptors, the valid target row j of N that
// minimises hamming(q_i, t_j), the lowest such j on ties:
//   d1[i]  = min_j hamming(q_i, t_j)        over valid targets j
//   idx[i] = the lowest j that reaches d1[i]
// An invalid query row, or one with no valid target at all, gets
// d1 = 2^30 and idx 0 (the JAX package's reference path: distances of
// masked pairs are 2^30 and argmin takes the first minimum).
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _hamming_nn_kernel
// (via hamming_nn). The TPU kernel ran the +-1 int8 product on its matrix
// unit and left invalid query rows unmasked; here query validity is applied
// in the kernel.
//
// Design: kernel F's block as it is (hamming_knn2.cuh's top2_keys, the
// tensor cores' b1 and-popc product with each distance folded into the key
// (distance << 20) | row), of which D keeps the smallest key: d1 and the
// lowest row at it, by construction; the second key is dropped. One pair
// and 2,000 query rows are 8 slabs of 256 rows, so the target rows are
// split over blocks (ops/cuda_kernels._target_splits, as for F), each split
// block writes its smallest key a row and takes a ticket of its slab, and
// the block that takes the last ticket merges the slab's keys with one
// integer min a split and writes (d1, idx): one launch. The min of distinct
// keys is order-free, so the result does not depend on which block comes
// last: bitwise equal to the plain version.
//
// Bound on the H100: the b1 mma, 512 operations a row pair at 10.1 POP/s:
// 0.0002 ms at 2000 x 2000, below a launch's latency; the launch and the
// merge set the pace.
//
// Kernel F (hamming_knn2_kernel). Hamming top-2 of a list of frame pairs:
// for pair p and query row i of frame qidx[p], over the valid rows j of
// frame tidx[p],
//   d1[p, i] = min_j hamming(q_i, t_j),  idx[p, i] = the lowest j at d1,
//   d2[p, i] = the second smallest distance of the multiset (d1 on a tie);
// (2^30, 0, 2^30) for an invalid query row or a target frame with no valid
// row, d2 = 2^30 where one target row is valid (the JAX package's
// reference path: matching.knn2 of matching.hamming_matrix).
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py,
// _hamming_knn2_kernel (via hamming_knn2). The TPU kernel ran the +-1 int8
// product on its matrix unit, one target set per call, and left invalid
// query rows unmasked; here the pair list indexes the stores in place and
// query validity is applied in the kernel.
//
// Design: hamming_knn2.cuh's top2_keys, the tensor cores' b1 and-popc
// product with each distance folded into a key (distance << 20 | target
// row), so the top-2 is three integer min/max a distance and every merge is
// exact and order-free. One block of 256 threads per (pair, slab of 256
// query rows, split of the target rows): a warp holds two 16-row query
// tiles as fragments (the epilogue, not the mma, sets the pace: 4 tiles
// gained 6% at the loop search and lost 43% at one unsplit pair, 8 lost at
// both; csrc/probes/probe_support_knn2.py). With many pairs (the loop
// search) there is one split and the block writes (d1, idx, d2); with few
// (the keyframe step's one pair: 4 slabs) the target rows are split over
// blocks, each writes its two keys a row to a scratch buffer and takes a
// ticket of its slab, and the block that takes the last ticket merges the
// slab's keys: one launch either way. The merge is order-free on distinct
// keys, so the result does not depend on which block comes last: bitwise
// equal to the plain version.
//
// Bound on the H100: the b1 mma at the rate csrc/probes/
// probe_hamming_forms.py measures (10.1 POP/s, 512 operations a row pair).
// The epilogue's 4 integer instructions a distance (one multiply-add, 3
// min/max) issue on the ALU pipes at 64 a clock an SM, which is what holds
// the kernel at 6.6x the mma's bound at the loop search (0.086 against
// 0.013 ms; the old branchy epilogue on the same mma ran 38% slower).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hamming_knn2.cuh"

namespace {

constexpr int kThreads = 256;

// (d1, idx) of a query row from its smallest key (popc(q) added): (2^30, 0)
// for an invalid query row or one with no valid target
__device__ __forceinline__ void store1(int* __restrict__ d1,
                                       int* __restrict__ idx, int row,
                                       bool valid, int k1) {
  const bool hit = valid && k1 < hamming_knn2::kNoKey;
  d1[row] = hit ? k1 >> hamming_knn2::kIdxBits : hamming_knn2::kBig;
  idx[row] = hit ? k1 & hamming_knn2::kIdxMask : 0;
}

constexpr int kKnnTiles = 2;  // 16-row query tiles a warp
constexpr int kKnnSlab = hamming_knn2::kSlabRows<kKnnTiles>;  // 256 rows
static_assert(kKnnSlab == kThreads, "the merge gives each thread one row");

// q: [fq, n_q, 8] words; t: [ft, n_t, 8] words; vq: [fq, n_q], vt: [ft,
// n_t] uint8; qidx, tidx: [p] int32; d1, idx, d2: [p, n_q] int32.
// blockIdx.x = (pair * slabs + slab) * splits + split; split s scans target
// rows [s * split_len, min(n_t, (s + 1) * split_len)). With splits > 1
// each block writes its two keys a row to partial ([splits, p, n_q] int2)
// and takes a ticket from tickets[pair * slabs + slab] (zero on entry); the
// block that takes the last one merges the slab's keys over the splits,
// writes (d1, idx, d2) and returns the ticket to zero for the next launch.
__global__ void __launch_bounds__(kThreads)
hamming_knn2_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ t,
                    const uint8_t* __restrict__ vq,
                    const uint8_t* __restrict__ vt,
                    const int* __restrict__ qidx, const int* __restrict__ tidx,
                    int* __restrict__ d1, int* __restrict__ idx,
                    int* __restrict__ d2, int2* __restrict__ partial,
                    unsigned* __restrict__ tickets, int p_cnt, int n_q,
                    int n_t, int slabs, int splits, int split_len) {
  __shared__ __align__(16) unsigned char smem[hamming_knn2::kSmemBytes];
  __shared__ bool last;
  const int split = blockIdx.x % splits;
  const int slab = (blockIdx.x / splits) % slabs;
  const int pair = blockIdx.x / (splits * slabs);
  const size_t q_base = static_cast<size_t>(qidx[pair]) * n_q;
  const size_t t_base = static_cast<size_t>(tidx[pair]) * n_t;
  const int t_begin = split * split_len;
  const size_t o = static_cast<size_t>(pair) * n_q;
  const size_t plane = static_cast<size_t>(p_cnt) * n_q;
  hamming_knn2::top2_keys<kKnnTiles>(
      q + q_base * 8, n_q, slab * kKnnSlab, t + t_base * 8, vt + t_base,
      t_begin, min(n_t, t_begin + split_len), smem,
      [&](int row, int k1, int k2) {
        if (splits == 1)
          hamming_knn2::store(d1, idx, d2, o + row, vq[q_base + row] != 0, k1,
                              k2);
        else
          partial[split * plane + o + row] = make_int2(k1, k2);
      });
  if (splits == 1) return;
  // every block's keys are visible device-wide before its ticket is taken
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = tickets + static_cast<size_t>(pair) * slabs + slab;
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(splits - 1);
    if (last) *ticket = 0;
  }
  __syncthreads();
  const int row = slab * kKnnSlab + threadIdx.x;
  if (!last || row >= n_q) return;
  // other SMs wrote these keys: read them past the (incoherent) L1
  int2 k = __ldcg(partial + o + row);
  for (int s = 1; s < splits; ++s) {
    const int2 b = __ldcg(partial + s * plane + o + row);
    hamming_knn2::merge2(k.x, k.y, b.x, b.y);
  }
  hamming_knn2::store(d1, idx, d2, o + row, vq[q_base + row] != 0, k.x, k.y);
}

// q: [m, 8] words; t: [n, 8] words; vq: [m], vt: [n] uint8; d1, idx: [m]
// int32. blockIdx.x = slab * splits + split; split s scans target rows
// [s * split_len, min(n, (s + 1) * split_len)). With splits > 1 each block
// writes its smallest key a row to partial ([splits, m] int32) and takes a
// ticket from tickets[slab] (zero on entry); the block that takes the last
// one merges the slab's keys over the splits, writes (d1, idx) and returns
// the ticket to zero for the next launch.
__global__ void __launch_bounds__(kThreads)
hamming_nn_kernel(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ t,
                  const uint8_t* __restrict__ vq,
                  const uint8_t* __restrict__ vt, int* __restrict__ d1,
                  int* __restrict__ idx, int* __restrict__ partial,
                  unsigned* __restrict__ tickets, int m, int n, int splits,
                  int split_len) {
  __shared__ __align__(16) unsigned char smem[hamming_knn2::kSmemBytes];
  __shared__ bool last;
  const int split = blockIdx.x % splits;
  const int slab = blockIdx.x / splits;
  const int t_begin = split * split_len;
  hamming_knn2::top2_keys<kKnnTiles>(
      q, m, slab * kKnnSlab, t, vt, t_begin, min(n, t_begin + split_len),
      smem, [&](int row, int k1, int) {
        if (splits == 1)
          store1(d1, idx, row, vq[row] != 0, k1);
        else
          partial[static_cast<size_t>(split) * m + row] = k1;
      });
  if (splits == 1) return;
  // every block's keys are visible device-wide before its ticket is taken
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = tickets + slab;
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(splits - 1);
    if (last) *ticket = 0;
  }
  __syncthreads();
  const int row = slab * kKnnSlab + threadIdx.x;
  if (!last || row >= m) return;
  // other SMs wrote these keys: read them past the (incoherent) L1
  int k = __ldcg(partial + row);
  for (int s = 1; s < splits; ++s)
    k = min(k, __ldcg(partial + static_cast<size_t>(s) * m + row));
  store1(d1, idx, row, vq[row] != 0, k);
}

}  // namespace

// (d1, idx, d2) [p, n_q] of the frame pairs (qidx[p], tidx[p]). With
// splits == 1 `partial` and `tickets` are not read; with splits > 1
// `partial` is a [splits, p, n_q] int2 scratch buffer and `tickets` holds
// p * ceil(n_q / 256) zeros, which the launch leaves at zero. n_t must be
// below 2^20 (the index bits of a key).
extern "C" int slam_hamming_knn2(const void* q, const void* t, const void* vq,
                                 const void* vt, const void* qidx,
                                 const void* tidx, void* d1, void* idx,
                                 void* d2, void* partial, void* tickets,
                                 int p, int n_q, int n_t, int splits,
                                 void* stream) {
  if (p > 0 && n_q > 0) {
    if (n_t > hamming_knn2::kIdxMask)
      return static_cast<int>(cudaErrorInvalidValue);
    const int slabs = (n_q + kKnnSlab - 1) / kKnnSlab;
    if (splits < 1 || n_t < 1) splits = 1;
    const int split_len = (n_t + splits - 1) / splits;
    if (n_t > 0) splits = (n_t + split_len - 1) / split_len;
    const long long blocks = static_cast<long long>(p) * slabs * splits;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    hamming_knn2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<const int*>(qidx), static_cast<const int*>(tidx),
        static_cast<int*>(d1), static_cast<int*>(idx), static_cast<int*>(d2),
        static_cast<int2*>(partial), static_cast<unsigned*>(tickets), p, n_q,
        n_t, slabs, splits, split_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// (d1, idx) [m] of query rows q [m, 8] against target rows t [n, 8]. With
// splits == 1 `partial` and `tickets` are not read; with splits > 1
// `partial` is a [splits, m] int32 scratch buffer and `tickets` holds
// ceil(m / 256) zeros, which the launch leaves at zero. n must be below
// 2^20 (the index bits of a key).
extern "C" int slam_hamming_nn(const void* q, const void* t, const void* vq,
                               const void* vt, void* d1, void* idx,
                               void* partial, void* tickets, int m, int n,
                               int splits, void* stream) {
  if (m > 0) {
    if (n > hamming_knn2::kIdxMask)
      return static_cast<int>(cudaErrorInvalidValue);
    const int slabs = (m + kKnnSlab - 1) / kKnnSlab;
    if (splits < 1 || n < 1) splits = 1;
    const int split_len = (n + splits - 1) / splits;
    if (n > 0) splits = (n + split_len - 1) / split_len;
    hamming_nn_kernel<<<static_cast<unsigned>(slabs * splits), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
        static_cast<const uint8_t*>(vq), static_cast<const uint8_t*>(vt),
        static_cast<int*>(d1), static_cast<int*>(idx),
        static_cast<int*>(partial), static_cast<unsigned*>(tickets), m, n,
        splits, split_len);
  }
  return static_cast<int>(cudaGetLastError());
}
