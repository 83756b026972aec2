// Kernel Q: rotated BRIEF with the rotation quantised to bins, from the
// 32 x 32 float32 patches of ORB keypoints, written as the two descriptor
// layouts the rest of the port reads.
//
// For keypoint k with patch p (1,024 values, row-major), angle a and
// validity v, and the pair table pairs[bins, 256, 2] of flat pixel indices
// (point A, point B) of each bin's rotated pattern (ops/orb.py,
// brief_pairs):
//   bin   = round_half_even(a / step) floor-mod bins, the division correctly
//           rounded (step is the float32 2 pi / bins),
//   bit j = bf16(p[B_j]) > bf16(p[A_j]) for the bin's pair j,
//   packed[k, w] = bits 32 w ... 32 w + 31 (bit i of word w = bit 32 w + i),
//   signed[k, j] = bit j ? +1 : -1,
// and zeros in both for an invalid row. A pair whose A and B are one pixel
// gives bit 0. This is ops/orb.py's brief_from_patches_binned (a bf16
// product of the patches with each bin's +1/-1 difference matrix, the bin's
// output kept by a select) followed by bits_to_packed and bits_to_signed:
// the product's column j is bf16(p[B_j]) - bf16(p[A_j]), summed in float32
// and rounded to bf16, which keeps the difference's sign.
//
// Replaces: no TPU kernel. The JAX package leaves BRIEF to XLA's products
// (slam_loop_closing_tpu/ops/orb.py, brief_from_patches_binned); the port
// ran 30 cuBLAS products of [K, 1024] @ [1024, 256] a call, 30 selects over
// [K, 256] bf16 and an int64 shift-sum to pack the words.
//
// Design: one warp a keypoint. The warp reads the 4 KB patch with 16-byte
// loads (lane l takes float4s l, l + 32, ..., l + 224: 512 contiguous bytes
// a load), rounds each value to bf16 and stages it in shared memory, 2 KB a
// warp. For word w, lane i reads its pair 32 w + i from the table (30 KB
// for 30 bins, read through the cache), compares the two staged samples,
// and __ballot_sync gives the whole word to every lane; lane i keeps word
// i (i < 8) and word i / 4. Lane i then writes the 8 signed bytes 8 i ...
// 8 i + 7 (bits 8 (i & 3) ... of word i / 4) as one 8-byte store, 256
// contiguous bytes a warp, and lanes 0-7 the 8 words, 32 contiguous bytes.
// An invalid row reads nothing and writes zeros.
//
// Bound on the H100: bytes, the patch read once and 288 bytes of
// descriptors written, about 4.4 KB a keypoint.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // keypoints a block
constexpr int kCols = 1024;            // values a patch
constexpr int kBits = 256;
constexpr int kWords = kBits / 32;

// pairs: [bins, 256] uint32, A in the low and B in the high 16 bits (the
// int16 table [bins, 256, 2] read as words); packed: [k, 8] words; signed:
// [k, 256] int8 written as [k, 32] 8-byte groups
__global__ void __launch_bounds__(kThreads)
brief_bits_kernel(const float4* __restrict__ patches,
                  const float* __restrict__ angle,
                  const uint8_t* __restrict__ valid,
                  const uint32_t* __restrict__ pairs,
                  uint32_t* __restrict__ packed,
                  uint2* __restrict__ signed_out,
                  int k, int bins, float step) {
  __shared__ __nv_bfloat16 tile[kWarps][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= k) return;  // a whole warp: no ballot is left half-empty
  uint32_t mine = 0;  // word `lane` of the packed row (lanes 0-7)
  uint2 bytes = make_uint2(0u, 0u);
  if (valid[row]) {
    const float4* p = patches + static_cast<size_t>(row) * (kCols / 4);
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcs(p + lane + 32 * j);
    __nv_bfloat16* t = tile[warp];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[j].x, v[j].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[j].z, v[j].w);
      uint2 q;
      q.x = *reinterpret_cast<uint32_t*>(&lo);
      q.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(t)[lane + 32 * j] = q;
    }
    __syncwarp();
    // R2: the bin as the GEMM route computes it (true division, round half
    // to even, floor modulo)
    int b = static_cast<int>(rintf(__fdiv_rn(angle[row], step)));
    b = ((b % bins) + bins) % bins;
    const uint32_t* bp = pairs + static_cast<size_t>(b) * kBits + lane;
    uint32_t word = 0;  // word lane / 4, which holds this lane's signed bytes
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t ab = __ldg(bp + 32 * w);
      const float a = __bfloat162float(t[ab & 0xffffu]);
      const float bv = __bfloat162float(t[ab >> 16]);
      const uint32_t ballot = __ballot_sync(0xffffffffu, bv > a);
      if (lane == w) mine = ballot;
      if ((lane >> 2) == w) word = ballot;
    }
    // lane i's 8 signed bytes: bits 8 (i & 3) ... + 7 of word i / 4, each
    // spread to one byte (0 or 1), then 1 -> 0x01, 0 -> 0xff
    const uint32_t eight = (word >> (8 * (lane & 3))) & 0xffu;
    uint32_t spread[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t n = eight >> (4 * h);
      const uint32_t s = (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) |
                         ((n & 8u) << 21);
      spread[h] = ~(s * 0xfeu);
    }
    bytes = make_uint2(spread[0], spread[1]);
  }
  if (lane < kWords) packed[static_cast<size_t>(row) * kWords + lane] = mine;
  signed_out[static_cast<size_t>(row) * 32 + lane] = bytes;
}

}  // namespace

// packed [k, 8] int32 and signed [k, 256] int8 of the patches [k, 32, 32]
// with angles angle [k], validity valid [k] and the pair table pairs
// [bins, 256, 2] int16 (every index below 1,024); step is 2 pi / bins in
// float32
extern "C" int slam_brief_bits(const void* patches, const void* angle,
                               const void* valid, const void* pairs,
                               void* packed, void* signed_out, int k,
                               int bins, float step, void* stream) {
  if (k > 0) {
    const unsigned blocks = static_cast<unsigned>((k + kWarps - 1) / kWarps);
    brief_bits_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(patches),
        static_cast<const float*>(angle),
        static_cast<const uint8_t*>(valid),
        static_cast<const uint32_t*>(pairs), static_cast<uint32_t*>(packed),
        static_cast<uint2*>(signed_out), k, bins, step);
  }
  return static_cast<int>(cudaGetLastError());
}
