// Square patch gather around integer keypoints: for frame b and keypoint k
// at (x, y), out[b, k] = img[b, y0:y0+patch, x0:x0+patch] with
// x0 = clamp(int(x) - center, 0, W - patch), y0 likewise (32/15 for ORB,
// 40/19 for the SIFT variant).
//
// Replaces: slam_loop_closing_tpu/ops/pallas_kernels.py, _patch_kernel (via
// extract_patches_pallas). The TPU kernel hid per-keypoint DMA latency
// behind a ring of aligned window copies; on the H100 a block of 32x8
// threads per keypoint reads each patch row as one coalesced 128-byte line
// and the hardware keeps many blocks' loads in flight.
//
// Bound on the H100: memory traffic, 2 x patch^2 x 4 B per keypoint (8 KB at
// 32x32; ~1.6 GB for 96 frames x 2000 keypoints), moved at the rate at which
// small scattered blocks can be scheduled. Later work: several keypoints per
// block, and fusing the moment and BRIEF products that consume the patches
// so that they never reach device memory.

#include <cuda_runtime.h>

namespace {

__global__ void extract_patches_kernel(const float* __restrict__ img,
                                       const float* __restrict__ xy,
                                       float* __restrict__ out, int k, int h,
                                       int w, int patch, int center) {
  const int kp = blockIdx.x, b = blockIdx.y;
  const size_t key = static_cast<size_t>(b) * k + kp;
  // float -> int truncates toward zero, like astype(int32)
  const int xi = static_cast<int>(xy[2 * key]);
  const int yi = static_cast<int>(xy[2 * key + 1]);
  const int x0 = min(max(xi - center, 0), w - patch);
  const int y0 = min(max(yi - center, 0), h - patch);
  const float* src = img + static_cast<size_t>(b) * h * w +
                     static_cast<size_t>(y0) * w + x0;
  float* dst = out + key * patch * patch;
  for (int r = threadIdx.y; r < patch; r += blockDim.y)
    for (int c = threadIdx.x; c < patch; c += blockDim.x)
      dst[r * patch + c] = src[static_cast<size_t>(r) * w + c];
}

}  // namespace

extern "C" int slam_extract_patches(const void* img, const void* xy, void* out,
                                    int b, int k, int h, int w, int patch,
                                    int center, void* stream) {
  if (b > 0 && k > 0) {
    extract_patches_kernel<<<dim3(k, b), dim3(32, 8), 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), static_cast<const float*>(xy),
        static_cast<float*>(out), k, h, w, patch, center);
  }
  return static_cast<int>(cudaGetLastError());
}
