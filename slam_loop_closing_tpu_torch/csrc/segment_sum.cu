// Kernel N: segment sums in a fixed order, for the normal equations of
// bundle adjustment and pose-graph optimization.
//
// Computes what slam_loop_closing_tpu_torch/ops/cuda_kernels.py's
// segment_sums computes on the CPU: for each of up to kMaxSums sums over one
// plan, out[i] = the sum of row order[k] for k = offsets[i] ..
// offsets[i+1] - 1, in ascending k, from 0, each term added with __fadd_rn
// (no FMA, no atomics; an empty segment gives 0). A sum's rows come from
// one source, or from two read as their concatenation (row r < split from
// the first, row r >= split from row r - split of the second). `order` is a
// stable argsort of the row index, so a segment's terms come in ascending
// row order: the sums of a sequential index_add_ on the CPU, bit for bit
// (signed zeros too). Float atomics (CUDA's index_add_) sum in the order
// the rows happen to arrive, which changes from run to run; here the bits of
// a sum depend on its inputs only.
//
// Replaces: no TPU kernel. The JAX package assembles these sums with
// .at[].add, which XLA lowers to a scatter
// (slam_loop_closing_tpu/ops/ba.py:129-189, ops/pgo.py:93-138).
//
// Design. A chain is one (segment, component) sum; no chain is ever split
// over threads. The plan sorts the segments into two forms, with no host
// sync: its device list `long_ids` holds the segments of more than
// `short_rows` rows (their number in `long_count`), and the host sizes the
// grid from what it knows, the rows E, the segments n and the widths.
// - Short segments (PGO's two-row poses, BA's points, the error sums): a
//   thread a chain, neighbouring threads on neighbouring components of a
//   row so that the loads of a row coalesce. A thread loads kBatch of its
//   segment's order entries at once, then those rows' values, then adds
//   them; few registers, so an SM holds 64 warps.
// - Long segments (BA's cameras, a camera seen 5,000 times): the first
//   `long_blocks` blocks walk the list, one segment at a time. The block
//   gathers the segment's rows chunk by chunk into a ring of two stages in
//   shared memory with cp.async (4 bytes each: a 36-byte row is not 16-byte
//   aligned, so TMA and wider copies cannot gather it); the order entries
//   of chunk c + 2 and the rows of chunk c + 1 are in flight while one
//   thread a component runs its chain over chunk c from shared memory.
// Several sums over one plan (BA's H and g, PGO's gradient and diagonal)
// share a launch: their components are laid side by side, `width` in all.
//
// Bound on the H100: bytes (each row read once with its order entry, the
// offsets, the sums written once); the adds are one an input float.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSums = 3;
constexpr int kMaxWidth = 64;            // floats a row of one sum
// rows a short chain loads at once (at 8 the 32 registers of kBlocksPerSm
// spill 76 bytes; csrc/probes/probe_segment_forms.py times the forms)
constexpr int kBatch = 4;
constexpr int kStageFloats = 2560;       // a stage of the long form's ring
constexpr int kChunkRows = 256;          // rows a stage at most
constexpr int kBlocksPerSm = 8;          // 64 warps an SM

struct Sums {
  const float* first[kMaxSums];
  const float* second[kMaxSums];
  float* out[kMaxSums];
  int split[kMaxSums];
  int d[kMaxSums];
  int count;
  int width;  // the sums' components side by side
};

// component c (< width) of the sums: which sum, and its component there
struct Component {
  const float* first;
  const float* second;
  float* out;
  int split, d, j;
};

// (selects, not an index into the parameter: a dynamic index would copy
// the struct to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxSums], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : a[2];
}

__device__ __forceinline__ Component component(const Sums& s, int c) {
  int k = 0;
  if (s.count > 1 && c >= s.d[0]) {
    c -= s.d[0];
    k = 1;
    if (s.count > 2 && c >= s.d[1]) {
      c -= s.d[1];
      k = 2;
    }
  }
  return Component{pick(s.first, k), pick(s.second, k), pick(s.out, k),
                   pick(s.split, k), pick(s.d, k), c};
}

__device__ __forceinline__ const float* row_ptr(const Component& m, int r) {
  return r < m.split ? m.first + static_cast<size_t>(r) * m.d + m.j
                     : m.second + static_cast<size_t>(r - m.split) * m.d + m.j;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the short form: chain t (segment t / width, component t % width), unless
// its segment is long
__device__ __forceinline__ void short_chain(const Sums& s,
                                            const int* __restrict__ order,
                                            const int* __restrict__ offsets,
                                            int n, int short_rows,
                                            long long t) {
  const long long seg = t / s.width;
  if (seg >= n) return;
  const int c = static_cast<int>(t - seg * s.width);
  const int begin = __ldg(offsets + seg), end = __ldg(offsets + seg + 1);
  if (end - begin > short_rows) return;
  const Component m = component(s, c);
  float acc = 0.0f;
  for (int k0 = begin; k0 < end; k0 += kBatch) {
    const int count = min(kBatch, end - k0);
    int r[kBatch];
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      r[i] = i < count ? __ldg(order + k0 + i) : 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      v[i] = i < count ? __ldg(row_ptr(m, r[i])) : 0.0f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (i < count) acc = __fadd_rn(acc, v[i]);
  }
  m.out[seg * m.d + m.j] = acc;
}

struct Ring {
  float val[2][kStageFloats];
  int ord[2][kChunkRows];
};

// the long form: this block's share of the long segments' list
__device__ __forceinline__ void long_chains(const Sums& s,
                                            const int* __restrict__ order,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ long_ids,
                                            const int* __restrict__ long_count,
                                            int long_blocks, Ring& ring) {
  const int w = s.width;
  const int rows = min(kChunkRows, kStageFloats / w);  // a chunk's rows
  const int per_pass = kThreads / w;                   // rows a gather pass
  const int c = threadIdx.x % w, j0 = threadIdx.x / w;
  const Component m = component(s, c);
  const int segs = __ldg(long_count);
  for (int li = blockIdx.x; li < segs; li += long_blocks) {
    const int seg = __ldg(long_ids + li);
    const int begin = __ldg(offsets + seg), len = __ldg(offsets + seg + 1)
                                                  - begin;
    const int chunks = (len + rows - 1) / rows;
    auto chunk_rows = [&](int ch) { return min(rows, len - ch * rows); };
    auto issue_order = [&](int ch) {
      for (int i = threadIdx.x; i < chunk_rows(ch); i += kThreads)
        cp_async4(&ring.ord[ch & 1][i], order + begin + ch * rows + i);
    };
    auto issue_rows = [&](int ch) {
      if (j0 >= per_pass) return;
      const int* ord = ring.ord[ch & 1];
      float* val = ring.val[ch & 1];
      for (int i = j0; i < chunk_rows(ch); i += per_pass)
        cp_async4(val + i * w + c, row_ptr(m, ord[i]));
    };
    issue_order(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    issue_rows(0);
    if (chunks > 1) issue_order(1);
    cp_async_commit();
    float acc = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      // chunk ch's rows and chunk ch + 1's order entries have landed, and
      // no thread still reads the stage that the next issue overwrites
      cp_async_wait_all();
      __syncthreads();
      if (ch + 1 < chunks) {
        issue_rows(ch + 1);
        if (ch + 2 < chunks) issue_order(ch + 2);
      }
      cp_async_commit();
      if (threadIdx.x < w) {
        const float* val = ring.val[ch & 1] + threadIdx.x;
        const int count = chunk_rows(ch);
#pragma unroll 8
        for (int i = 0; i < count; ++i) acc = __fadd_rn(acc, val[i * w]);
      }
    }
    if (threadIdx.x < w) m.out[static_cast<size_t>(seg) * m.d + m.j] = acc;
    __syncthreads();  // the ring is free for the next segment
  }
}

// blocks [0, long_blocks) walk the long segments' list; the rest run a
// short chain a thread
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_sum_kernel(Sums s, const int* __restrict__ order,
                   const int* __restrict__ offsets,
                   const int* __restrict__ long_ids,
                   const int* __restrict__ long_count, int n, int short_rows,
                   int long_blocks) {
  __shared__ Ring ring;
  if (static_cast<int>(blockIdx.x) < long_blocks)
    long_chains(s, order, offsets, long_ids, long_count, long_blocks, ring);
  else
    short_chain(s, order, offsets, n, short_rows,
                static_cast<long long>(blockIdx.x - long_blocks) * kThreads
                    + threadIdx.x);
}

int launch(Sums& s, const void* order, const void* offsets,
           const void* long_ids, const void* long_count, int n,
           int short_rows, int long_blocks, void* stream) {
  if (n > 0) {
    if (short_rows < 0 || long_blocks < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    s.width = 0;
    for (int k = 0; k < s.count; ++k) {
      if (s.d[k] < 1 || s.d[k] > kMaxWidth)
        return static_cast<int>(cudaErrorInvalidValue);
      s.width += s.d[k];
    }
    const long long chains = static_cast<long long>(n) * s.width;
    const long long blocks = long_blocks + (chains + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    segment_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        s, static_cast<const int*>(order), static_cast<const int*>(offsets),
        static_cast<const int*>(long_ids),
        static_cast<const int*>(long_count), n, short_rows, long_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Up to three sums over one plan, in one launch. The arguments come as one
// block of int64 that the wrapper packs (ctypes converts the arguments of a
// call one by one; probe_segment_forms.py times both):
//   [0] order [E] int32, [1] offsets [n + 1] int32, [2] long_ids [n] int32
//   whose first *long_count ([3], int32) entries are the segments of more
//   than short_rows rows, [4] n, [5] short_rows, [6] long_blocks (blocks
//   that walk the long list, 0 if none can be long), [7] count (1 to 3);
//   then five a sum k < count: first_k [split_k, d_k] float32, second_k
//   [E - split_k, d_k] float32, split_k (E for one source), d_k (1 to 64),
//   out_k [n, d_k] float32.
extern "C" int slam_segment_sum(const void* block, void* stream) {
  long long a[8 + 5 * kMaxSums];
  memcpy(a, block, 8 * sizeof(long long));
  const long long n = a[4], short_rows = a[5], long_blocks = a[6];
  const long long count = a[7];
  if (count < 1 || count > kMaxSums || n < 0 || n > 0x7fffffffLL
      || short_rows > 0x7fffffffLL || long_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(a + 8, static_cast<const char*>(block) + 8 * sizeof(long long),
         5 * count * sizeof(long long));
  Sums s{};
  s.count = static_cast<int>(count);
  for (int k = 0; k < s.count; ++k) {
    const long long* m = a + 8 + 5 * k;
    if (m[2] < 0 || m[2] > 0x7fffffffLL || m[3] < 1
        || m[3] > kMaxWidth)
      return static_cast<int>(cudaErrorInvalidValue);
    s.first[k] = reinterpret_cast<const float*>(m[0]);
    s.second[k] = reinterpret_cast<const float*>(m[1]);
    s.split[k] = static_cast<int>(m[2]);
    s.d[k] = static_cast<int>(m[3]);
    s.out[k] = reinterpret_cast<float*>(m[4]);
  }
  return launch(s, reinterpret_cast<const void*>(a[0]),
                reinterpret_cast<const void*>(a[1]),
                reinterpret_cast<const void*>(a[2]),
                reinterpret_cast<const void*>(a[3]), static_cast<int>(n),
                static_cast<int>(short_rows), static_cast<int>(long_blocks),
                stream);
}
