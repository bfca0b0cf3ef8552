// Fused FAST-9 score map + 3x3 non-max suppression on a (B, H, W) stack.
//
// Replaces the Pallas TPU kernel plslam_tpu/ops/pallas_fast.py
// (fast_score_nms_batch, body _kernel), which DMAs zero-padded row bands
// into VMEM.  Here each block owns a 32x8 output tile: it stages the
// input tile with a 4-px halo in shared memory (3 px for the Bresenham
// ring, 1 px for NMS), zero outside the image as the Pallas kernel pads,
// computes the score on the tile plus a 1-px ring into shared memory
// (-inf outside the image, the SAME padding of the NMS window), then
// writes the raw map and the NMS map.  One launch per pyramid level.
//
// score = max(bright, dark), bright = max over the 16 arc starts of the
// min of (ring - center) over 9 contiguous ring pixels, dark the same on
// (center - ring); score is zeroed at or below the per-image threshold,
// read from a device buffer (the adaptive FAST threshold never leaves the
// card).  min/max are exact, so the result is bit-identical to the jnp
// form away from the 3-px frame, where that form wraps with jnp.roll.
//
// Bound: arithmetic.  About 290 min/max per pixel against 8 bytes of
// output and 4 of input; a 480x752 level reads 1.4 MB and writes 2.9 MB
// per image.  The shared-memory tile removes the 16x re-read of the ring.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 4;
constexpr int IW = TX + 2 * HALO;   // 40
constexpr int IH = TY + 2 * HALO;   // 16
constexpr int SW = TX + 2;          // 34: score tile with the NMS ring
constexpr int SH = TY + 2;          // 10

__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void fast_score_nms_kernel(const float* __restrict__ imgs,
                                      const float* __restrict__ thr,
                                      float* __restrict__ raw,
                                      float* __restrict__ nms, int H, int W) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];
  const int b = blockIdx.z;
  const int ox = blockIdx.x * TX;
  const int oy = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float* img = imgs + (size_t)b * H * W;

  for (int i = tid; i < IH * IW; i += TX * TY) {
    const int y = oy - HALO + i / IW;
    const int x = ox - HALO + i % IW;
    tile[i / IW][i % IW] =
        (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.0f;
  }
  __syncthreads();

  const float th = thr[b];
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int sy = i / SW;
    const int sx = i % SW;
    const int y = oy - 1 + sy;
    const int x = ox - 1 + sx;
    float s = -CUDART_INF_F;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float c = tile[sy + 3][sx + 3];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = tile[sy + 3 + RING_DY[k]][sx + 3 + RING_DX[k]] - c;
      float bright = -CUDART_INF_F;
      float dark = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k];
        float mx = d[k];
#pragma unroll
        for (int a = 1; a < 9; ++a) {
          mn = fminf(mn, d[(k + a) & 15]);
          mx = fmaxf(mx, d[(k + a) & 15]);
        }
        bright = fmaxf(bright, mn);
        dark = fmaxf(dark, -mx);
      }
      const float m = fmaxf(bright, dark);
      s = m > th ? m : 0.0f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int y = oy + threadIdx.y;
  const int x = ox + threadIdx.x;
  if (y < H && x < W) {
    const float s = score[threadIdx.y + 1][threadIdx.x + 1];
    float mx = s;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[threadIdx.y + dy][threadIdx.x + dx]);
    const size_t o = (size_t)b * H * W + (size_t)y * W + x;
    raw[o] = s;
    nms[o] = (s >= mx && s > 0.0f) ? s : 0.0f;
  }
}

}  // namespace

extern "C" int plslam_fast_score_nms(const float* imgs, const float* thr,
                                     float* raw, float* nms, int B, int H,
                                     int W, void* stream) {
  if (B * H * W > 0) {
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
    fast_score_nms_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        imgs, thr, raw, nms, H, W);
  }
  return (int)cudaGetLastError();
}
