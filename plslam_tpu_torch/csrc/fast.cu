// Fused FAST-9 score map + 3x3 non-max suppression on a (B, H, W) stack.
//
// Replaces the Pallas TPU kernel plslam_tpu/ops/pallas_fast.py
// (fast_score_nms_batch, body _kernel), which DMAs zero-padded row bands
// into VMEM.
//
// score = max(bright, dark), bright = max over the 16 arc starts of the
// min of (ring - center) over 9 contiguous ring pixels, dark the same on
// (center - ring), i.e. -(min over arcs of the max of ring - center);
// score is zeroed at or below the per-image threshold, read from a device
// buffer (the adaptive FAST threshold never leaves the card).  min/max are
// exact and associative, so any order of them gives the jnp form's value
// bit for bit away from the 3-px frame, where that form wraps with
// jnp.roll and this kernel zero-pads.
//
// Bound: device memory, 4 bytes in and 8 out per pixel (6.5 us per VO
// frame at 3.35 TB/s).  The score is all float min/max, which Hopper
// issues at 64 per clock per SM (the CUDA guide's throughput table), so
// the design cuts the min/max per pixel.  Computing each of the 16 arc
// windows apart costs 16 x 16 = 256 of them.  Here the 16 windows of 9
// over the circular ring come from Gil-Werman prefix and suffix runs over
// blocks of 9 (42 min/max per direction, plus 15 to fold the 16 windows),
// 114 per pixel in all, and only where a corner is possible: every arc of
// 9 holds ring point 0 or 8 and point 4 or 12, so a pixel whose compass
// points give no such pair beyond the threshold (in either direction)
// scores exactly 0 after 4 differences and 8 compares.  What is left
// (PERF.md): one launch per level, and in each block three passes split
// by barriers, so the small levels pay a block's latency more than its
// work.
//
// Layout.  A block of 4 warps owns a 32x16 output tile: it stages the
// input tile with a 4-px halo in shared memory (3 px for the Bresenham
// ring, 1 px for NMS), zero outside the image as the Pallas kernel pads.
// Over the tile plus a 1-px ring (the NMS window; -inf outside the image,
// its SAME padding) a first pass runs the compass test and queues the
// pixels that pass in shared memory; a second pass scores the queue in
// dense warps, so the folds cost in proportion to the candidate pixels
// and not to a warp's worst lane.  Then each warp writes rows of the raw
// map and the NMS map.  One launch per pyramid level.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 16;
constexpr int THREADS = 128;
constexpr int HALO = 4;
constexpr int IW = TX + 2 * HALO;   // 40
constexpr int IH = TY + 2 * HALO;   // 24
constexpr int SW = TX + 2;          // 34: score tile with the NMS ring
constexpr int SH = TY + 2;          // 18

__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

template <bool MIN>
__device__ __forceinline__ float win(float a, float b) {
  return MIN ? fminf(a, b) : fmaxf(a, b);
}

// Fold over the 16 circular windows d[k..k+8] (indices mod 16): the window
// op is min (MIN) or max, the fold the other one.  On the unrolled ring
// e[i] = d[i & 15], i < 24, cut into blocks [0, 8], [9, 17], [18, 26]:
// window k is the suffix run of its block from k joined with the prefix
// run of the next block up to k + 8.
template <bool MIN>
__device__ __forceinline__ float fold_windows(const float (&d)[16]) {
  float S[16];   // S[k]: run from k to the end of k's block (k < 16)
  S[8] = d[8];
#pragma unroll
  for (int k = 7; k >= 0; --k) S[k] = win<MIN>(d[k], S[k + 1]);
  float s16 = win<MIN>(d[0], d[1]);            // e16, e17
  S[15] = win<MIN>(d[15], s16);
#pragma unroll
  for (int k = 14; k >= 9; --k) S[k] = win<MIN>(d[k], S[k + 1]);
  float P1[8];   // P1[i]: run e[9 .. 9 + i], i < 8 (e9..e16)
  P1[0] = d[9];
#pragma unroll
  for (int i = 1; i < 7; ++i) P1[i] = win<MIN>(P1[i - 1], d[9 + i]);
  P1[7] = win<MIN>(P1[6], d[0]);
  float P2[6];   // P2[i]: run e[18 .. 18 + i] = d[2 .. 2 + i], i < 6
  P2[0] = d[2];
#pragma unroll
  for (int i = 1; i < 6; ++i) P2[i] = win<MIN>(P2[i - 1], d[2 + i]);

  float acc = win<!MIN>(S[0], S[9]);           // windows 0 and 9 fill a block
#pragma unroll
  for (int k = 1; k <= 8; ++k) acc = win<!MIN>(acc, win<MIN>(S[k], P1[k - 1]));
#pragma unroll
  for (int k = 10; k <= 15; ++k) acc = win<!MIN>(acc, win<MIN>(S[k], P2[k - 10]));
  return acc;
}

__global__ void __launch_bounds__(THREADS) fast_score_nms_kernel(
    const float* __restrict__ imgs, const float* __restrict__ thr, float* __restrict__ raw,
    float* __restrict__ nms, int H, int W) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];
  __shared__ short queue[SH * SW];   // score-tile pixels that may be corners
  __shared__ int queued;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * TX;
  const int oy = blockIdx.y * TY;
  const int tid = threadIdx.x;
  const float* img = imgs + (size_t)b * H * W;

  if (tid == 0) queued = 0;
  // the halo tile in one round of asynchronous 4-byte copies, zero-filled
  // outside the image (a load-then-store loop would pay one memory latency
  // per element a thread copies)
  for (int i = tid; i < IH * IW; i += THREADS) {
    const int y = oy - HALO + i / IW;
    const int x = ox - HALO + i % IW;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    const float* src = inside ? img + (size_t)y * W + x : img;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&tile[i / IW][i % IW]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(inside ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // pass 1: -inf outside the image, 0 inside; a pixel whose compass points
  // (ring points 0, 4, 8, 12) hold a pair beyond the threshold joins the queue
  const float th = thr[b];
  for (int i = tid; i < SH * SW; i += THREADS) {
    const int sy = i / SW;
    const int sx = i % SW;
    const int y = oy - 1 + sy;
    const int x = ox - 1 + sx;
    float s = -CUDART_INF_F;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float c = tile[sy + 3][sx + 3];
      const float e0 = tile[sy][sx + 3] - c, e4 = tile[sy + 3][sx + 6] - c;
      const float e8 = tile[sy + 6][sx + 3] - c, e12 = tile[sy + 3][sx] - c;
      const bool bright = (e0 > th || e8 > th) && (e4 > th || e12 > th);
      const bool dark = (e0 < -th || e8 < -th) && (e4 < -th || e12 < -th);
      if (bright || dark) queue[atomicAdd(&queued, 1)] = (short)i;
      s = 0.0f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  // pass 2: the exact score of the queued pixels, in dense warps
  const int n = queued;
  for (int q = tid; q < n; q += THREADS) {
    const int i = queue[q];
    const int sy = i / SW;
    const int sx = i % SW;
    const float c = tile[sy + 3][sx + 3];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[sy + 3 + RING_DY[k]][sx + 3 + RING_DX[k]] - c;
    const float bright = fold_windows<true>(d);    // max over arcs of the min
    const float dark = -fold_windows<false>(d);    // -(min over arcs of the max)
    const float m = fmaxf(bright, dark);
    score[sy][sx] = m > th ? m : 0.0f;
  }
  __syncthreads();

  const int tx = tid % TX;
  const int x = ox + tx;
  for (int ty = tid / TX; ty < TY; ty += THREADS / TX) {
    const int y = oy + ty;
    if (y < H && x < W) {
      const float s = score[ty + 1][tx + 1];
      float mx = s;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[ty + dy][tx + dx]);
      const size_t o = (size_t)b * H * W + (size_t)y * W + x;
      raw[o] = s;
      nms[o] = (s >= mx && s > 0.0f) ? s : 0.0f;
    }
  }
}

}  // namespace

extern "C" int plslam_fast_score_nms(const float* imgs, const float* thr, float* raw,
                                     float* nms, int B, int H, int W, void* stream) {
  if (B * H * W > 0) {
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
    fast_score_nms_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(imgs, thr, raw, nms, H,
                                                                       W);
  }
  return (int)cudaGetLastError();
}
