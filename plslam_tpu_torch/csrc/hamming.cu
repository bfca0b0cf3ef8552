// 256-bit Hamming distance matrix: (N1, 8) x (N2, 8) int32 words ->
// (N1, N2) int32, popcount(a XOR b) summed over the 8 words.
//
// Replaces the Pallas TPU kernel plslam_tpu/ops/pallas_hamming.py
// (hamming_distance_matrix_pallas, body _kernel), which unpacks the bits to
// +/-1 bf16 and runs a 128x128-tiled MXU matmul, so it needs N1 and N2 to
// be multiples of 128.  Hopper has a popcount instruction, so the distance
// is XOR + __popc on the packed words, with any N1 and N2.
//
// Bound: the output write.  A 1200x1200 call reads 77 KB of descriptors
// and writes 5.8 MB of distances; the arithmetic is 16 integer ops per
// output.  Each block stages a 32-row tile of d1 and a 32-column tile of
// d2 in shared memory; a warp writes 32 consecutive columns of one row.
// Later work fuses the pair mask and the row/column top-2 of the mutual
// NNR matcher so the matrix never reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;      // output tile side
constexpr int ROWS = 8;    // thread rows per block; each thread does T/ROWS rows
constexpr int WORDS = 8;

__global__ void hamming_kernel(const unsigned* __restrict__ d1,
                               const unsigned* __restrict__ d2,
                               int* __restrict__ out, int N1, int N2) {
  __shared__ unsigned a[T][WORDS];
  __shared__ unsigned b[T][WORDS + 1];   // +1: no bank conflicts on column reads
  const int r0 = blockIdx.y * T;
  const int c0 = blockIdx.x * T;
  const int tid = threadIdx.y * T + threadIdx.x;
  for (int i = tid; i < T * WORDS; i += T * ROWS) {
    const int r = i / WORDS;
    const int w = i % WORDS;
    a[r][w] = (r0 + r < N1) ? d1[(size_t)(r0 + r) * WORDS + w] : 0u;
    b[r][w] = (c0 + r < N2) ? d2[(size_t)(c0 + r) * WORDS + w] : 0u;
  }
  __syncthreads();

  const int c = threadIdx.x;
  if (c0 + c >= N2) return;
  unsigned bw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) bw[w] = b[c][w];
  for (int r = threadIdx.y; r < T; r += ROWS) {
    if (r0 + r >= N1) break;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) acc += __popc(a[r][w] ^ bw[w]);
    out[(size_t)(r0 + r) * N2 + c0 + c] = acc;
  }
}

}  // namespace

extern "C" int plslam_hamming(const int* d1, const int* d2, int* out, int N1,
                              int N2, void* stream) {
  if (N1 > 0 && N2 > 0) {
    const dim3 grid((N2 + T - 1) / T, (N1 + T - 1) / T);
    hamming_kernel<<<grid, dim3(T, ROWS), 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const unsigned*>(d1),
        reinterpret_cast<const unsigned*>(d2), out, N1, N2);
  }
  return (int)cudaGetLastError();
}
