// Batched square-patch gather: out[b, n, r, c] = img[b, y0+r, x0+c], 0 outside.
//
// Replaces the Pallas TPU kernel plslam_tpu/ops/pallas_patches.py
// (gather_patches_batch, with _kernel and _issue), which stages 128-lane
// aligned image bands by block DMA and picks the window with one-hot
// matmuls because Mosaic cannot slice VMEM at arbitrary offsets.  On Hopper
// a thread can read any address, so the gather is a plain bounds-checked
// copy.
//
// Bound: device-memory bandwidth.  Per frame the VO path gathers
// (2, 1200, 48, 48) and (4, 1536, 48, 48) f32 patches, about 79 MB of
// writes; the reads hit L2 (neighbouring patches overlap, the images are
// 1.4 MB each).  One block per patch, consecutive threads on consecutive
// columns of a patch row, so reads and writes are 48-float coalesced runs.
// Later work fuses the descriptor tails into this gather so the patch
// stacks never reach device memory.

#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ imgs,
                                      const int* __restrict__ y0,
                                      const int* __restrict__ x0,
                                      float* __restrict__ out,
                                      int H, int W, int N, int P) {
  const int patch = blockIdx.x;            // b * N + n
  const int b = patch / N;
  const int py = y0[patch];
  const int px = x0[patch];
  const float* img = imgs + (size_t)b * H * W;
  float* dst = out + (size_t)patch * P * P;
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
    const int y = py + i / P;
    const int x = px + i % P;
    const bool inside = (y >= 0) && (y < H) && (x >= 0) && (x < W);
    dst[i] = inside ? img[(size_t)y * W + x] : 0.0f;
  }
}

}  // namespace

extern "C" int plslam_gather_patches(const float* imgs, const int* y0,
                                     const int* x0, float* out, int B, int H,
                                     int W, int N, int P, void* stream) {
  if (B * N > 0) {
    gather_patches_kernel<<<B * N, 256, 0, (cudaStream_t)stream>>>(
        imgs, y0, x0, out, H, W, N, P);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* plslam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
