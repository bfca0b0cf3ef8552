// 256-bit Hamming distance matrix on the tensor cores: (N1, 8) x (N2, 8)
// int32 words -> (N1, N2) int32, popcount(a XOR b) summed over the 8 words,
// for any N1 and N2 (0 and 1 included); and B such matrices in one launch,
// (B, N1, 8) x (B, N2, 8) -> (B, N1, N2), blockIdx.z the stream, each
// operand at its own stride per stream (0 broadcasts one set to every
// stream).  The 2-D call is B = 1.
//
// Replaces the Pallas TPU kernel plslam_tpu/ops/pallas_hamming.py
// (hamming_distance_matrix_pallas, body _kernel), which unpacks the bits to
// +/-1 bf16 and runs a 128x128-tiled MXU matmul (N1, N2 multiples of 128).
//
// Bound: the output write.  A 1200x1200 call reads 77 KB of descriptors and
// writes 5.76 MB of distances: 1.74 us at 3.35 TB/s.  The inner product is
// 2 * 256 int8 operations per output (0.37 us at 1,979 TOP/s); a popcount
// form on the CUDA cores (16 popcounts per clock per SM) would need 2.8 us.
//
// Design.  A block of 4 warps owns a 64x64 output tile (361 blocks at
// 1200x1200, several per SM).  It stages the tile's 64 + 64 descriptors in
// shared memory with cp.async (zero fill past the ends), and each warp
// computes 16 rows x 64 columns as 8 tensor-core products m16n8 whose K of
// 256 bits is one whole descriptor: mma.m16n8k256.b1.and.popc on the packed
// words as they are (bit order inside a word does not matter to a popcount
// of an AND).  Two products per n-tile, popc(a AND NOT b) + popc(NOT a AND
// b), sum to popc(a XOR b), so the accumulator is the distance, with no row
// or column popcounts.  The warp stages its 16x64 results in shared memory
// and writes each row with 16-byte stores.
//
// The probe (python -m plslam_tpu_torch.hamming_probe, PERF.md has the
// runs) puts six other inner products into the same stage_tile and
// store_tile (csrc/probe/hamming_variants.cu).  On an H100 this form is
// the fastest at every shape the port calls: 3.2-3.6 us at 1200x1200, 1.8-1.9
// us at 24x24.  The popcount form on the CUDA cores takes 5.3-5.7 and 2.9
// us.  Its extra 1.1 us at 24x24 is a whole tile's 256 popcounts per
// thread: 2048 clocks per warp at 16 per clock per SM (4 per quarter), which
// backs the 2.8 us above.  One .xor.popc product
// (compiles for sm_90a) is 0.5 us slower, one .and product with row and
// column popcounts 0.7 us, and int8 +/-1 products 0.9 us.  The kernel sits
// 1.5-1.9 us above its byte bound at every size: even a 24x24 call costs
// 1.8 us, the latency of one stage -> product -> store wave.

#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 8;
constexpr int TM = 64;             // d1 rows per block: 4 warps x 16
constexpr int TN = 64;             // d2 rows per block: 8 n-tiles of 8
constexpr int WARPS = TM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int NT = TN / 8;
constexpr int CSTRIDE = TN + 8;    // staged output row, padded against bank conflicts

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;    // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a tile's descriptors: 2 x 64 rows of 32 bytes, 16 bytes per thread
// each, zero past N1 and N2.
__device__ __forceinline__ void stage_tile(unsigned (&sa)[TM][WORDS], unsigned (&sb)[TN][WORDS],
                                           const unsigned* d1, const unsigned* d2, int r0,
                                           int c0, int N1, int N2) {
  const int row = threadIdx.x >> 1, half = (threadIdx.x & 1) * 4;
  cp_async16(&sa[row][half], d1 + (size_t)min(r0 + row, N1 - 1) * WORDS + half, r0 + row < N1);
  cp_async16(&sb[row][half], d2 + (size_t)min(c0 + row, N2 - 1) * WORDS + half, c0 + row < N2);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Write a warp's 16 rows of the staged tile: 16 lanes per row, 4 columns
// (16 bytes) per lane; scalar stores where N2 % 4 != 0 or at the ragged
// right edge, rows past N1 skipped.
__device__ __forceinline__ void write_rows(const int (&sc)[TM][CSTRIDE], int* __restrict__ out,
                                           int r0, int c0, int N1, int N2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = (N2 & 3) == 0;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int row = warp * 16 + it * 2 + (lane >> 4);
    const int col = (lane & 15) * 4;
    const int R = r0 + row, C = c0 + col;
    if (R >= N1 || C >= N2) continue;
    const int4 v = *reinterpret_cast<const int4*>(&sc[row][col]);
    int* dst = out + (size_t)R * N2 + C;
    if (vec && C + 3 < N2) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (C + i < N2) dst[i] = e[i];
    }
  }
}

// Write a warp's 16 x 64 accumulators, laid out as the m16n8 fragments
// (c0, c1 at (g, 2t), (g, 2t+1); c2, c3 at row g + 8 of n-tile j), through
// shared memory.
__device__ __forceinline__ void store_tile(int (&sc)[TM][CSTRIDE], const int (&acc)[NT][4],
                                           int* __restrict__ out, int r0, int c0, int N1,
                                           int N2) {
  const int lane = threadIdx.x & 31;
  const int ra = (threadIdx.x >> 5) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    *reinterpret_cast<int2*>(&sc[ra][col]) = make_int2(acc[j][0], acc[j][1]);
    *reinterpret_cast<int2*>(&sc[ra + 8][col]) = make_int2(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  write_rows(sc, out, r0, c0, N1, N2);
}

__global__ void __launch_bounds__(THREADS) hamming_mma_kernel(
    const unsigned* __restrict__ d1, const unsigned* __restrict__ d2, int* __restrict__ out,
    int N1, int N2, long long stride1, long long stride2) {
  __shared__ __align__(16) unsigned sa[TM][WORDS];
  __shared__ __align__(16) unsigned sb[TN][WORDS];
  __shared__ __align__(16) int sc[TM][CSTRIDE];
  // this block's stream: its operands at their strides (in words), its
  // output the z-th dense (N1, N2) matrix
  d1 += blockIdx.z * stride1;
  d2 += blockIdx.z * stride2;
  out += (size_t)blockIdx.z * N1 * N2;
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  stage_tile(sa, sb, d1, d2, r0, c0, N1, N2);

  // this warp's A fragment rows are g and g + 8 of its 16
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (threadIdx.x >> 5) * 16 + g;
  // a0..a3: (row g, word t), (row g+8, word t), (row g, word t+4), (row g+8, word t+4);
  // b0, b1: words t and t+4 of column 8j + g
  const unsigned a[4] = {sa[ra][t], sa[ra + 8][t], sa[ra][t + 4], sa[ra + 8][t + 4]};
  const unsigned na[4] = {~a[0], ~a[1], ~a[2], ~a[3]};
  int acc[NT][4] = {};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned b0 = sb[j * 8 + g][t], b1 = sb[j * 8 + g][t + 4];
    mma_b1(acc[j], a, ~b0, ~b1);   // popc(a AND NOT b)
    mma_b1(acc[j], na, b0, b1);    // + popc(NOT a AND b) = popc(a XOR b)
  }
  store_tile(sc, acc, out, r0, c0, N1, N2);
}

}  // namespace

// B streams (B <= 65535, the grid's z limit); stride1 and stride2 in
// int32 words between one stream's descriptors and the next's.
extern "C" int plslam_hamming(const int* d1, const int* d2, int* out, int B, int N1, int N2,
                              long long stride1, long long stride2, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (B > 0 && N1 > 0 && N2 > 0) {
    const dim3 grid((N2 + TN - 1) / TN, (N1 + TM - 1) / TM, B);
    hamming_mma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const unsigned*>(d1), reinterpret_cast<const unsigned*>(d2), out, N1,
        N2, stride1, stride2);
  }
  return (int)cudaGetLastError();
}
