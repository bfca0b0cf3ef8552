// Probe: the inner products that csrc/hamming.cu could use, each inside the
// kernel's own staging and store (stage_tile, store_tile), so that only
// the inner product differs.  Built and timed by
//     python -m plslam_tpu_torch.hamming_probe
// beside the shipped kernel (plslam_hamming, two b1 AND products); the
// port's library does not contain it.
//
// Variants (probe_hamming's `variant`):
//   0 popc        no tensor cores: 8 x popc(a XOR b) per output on the CUDA
//                 cores, at the positions the MMA fragments fill (the whole tile)
//   1 xor         one mma.m16n8k256.b1.xor.popc product per n-tile
//   2 and_pop     one .and.popc product, d = popc(a) + popc(b) - 2 popc(a AND b)
//   3 s8          +/-1 int8 expanded in registers, 8 mma.m16n8k32.s8 per
//                 n-tile, d = (256 - dot) / 2
//   4 popc_valid  popc, skipping the outputs past N1 and N2, which the MMA
//                 forms compute and the store drops
//   5 popc_spread popc on the valid outputs only, spread evenly over the
//                 block's threads (output i of the tile to thread i % 128),
//                 written straight to the staged tile

#include "../hamming.cu"

namespace {

enum { V_POPC = 0, V_XOR = 1, V_AND_POP = 2, V_S8 = 3, V_POPC_VALID = 4, V_POPC_SPREAD = 5,
       N_VARIANTS = 6 };

__device__ __forceinline__ void mma_b1_xor(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                           unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bits 0-3 of n -> four int8 lanes, +1 for a set bit and -1 for a clear one
__device__ __forceinline__ unsigned pm1x4(unsigned n) {
  const unsigned b = ((n & 0xFu) * 0x00204081u) & 0x01010101u;   // byte i = bit i
  return ~(b * 0xFEu);                                           // 0x01 or 0xFF
}

__device__ __forceinline__ int popc_row(const unsigned (&w)[WORDS]) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) n += __popc(w[k]);
  return n;
}

// a descriptor row of shared memory as two 16-byte loads
struct Row {
  uint4 lo, hi;
};

__device__ __forceinline__ Row load_row(const unsigned (&w)[WORDS]) {
  const uint4* v = reinterpret_cast<const uint4*>(w);
  return {v[0], v[1]};
}

__device__ __forceinline__ int popc_xor(const Row& x, const Row& y) {
  return __popc(x.lo.x ^ y.lo.x) + __popc(x.lo.y ^ y.lo.y) + __popc(x.lo.z ^ y.lo.z) +
         __popc(x.lo.w ^ y.lo.w) + __popc(x.hi.x ^ y.hi.x) + __popc(x.hi.y ^ y.hi.y) +
         __popc(x.hi.z ^ y.hi.z) + __popc(x.hi.w ^ y.hi.w);
}

template <int V>
__global__ void __launch_bounds__(THREADS) hamming_variant_kernel(
    const unsigned* __restrict__ d1, const unsigned* __restrict__ d2, int* __restrict__ out,
    int N1, int N2) {
  __shared__ __align__(16) unsigned sa[TM][WORDS];
  __shared__ __align__(16) unsigned sb[TN][WORDS];
  __shared__ __align__(16) int sc[TM][CSTRIDE];
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  stage_tile(sa, sb, d1, d2, r0, c0, N1, N2);

  if (V == V_POPC_SPREAD) {
    const int rows = min(TM, N1 - r0), cols = min(TN, N2 - c0);
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i % cols;
      sc[r][c] = popc_xor(load_row(sa[r]), load_row(sb[c]));
    }
    __syncthreads();
    write_rows(sc, out, r0, c0, N1, N2);
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (threadIdx.x >> 5) * 16 + g;
  int acc[NT][4] = {};
  if (V == V_POPC || V == V_POPC_VALID) {
    // the fragment positions the mma forms fill: rows ra, ra + 8 x columns 8j + 2t, + 1
    const Row x0 = load_row(sa[ra]), x8 = load_row(sa[ra + 8]);
    const bool all = V == V_POPC;
    const bool v0 = all || r0 + ra < N1, v8 = all || r0 + ra + 8 < N1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int cb = j * 8 + 2 * t + k;
        if (!all && c0 + cb >= N2) continue;
        const Row y = load_row(sb[cb]);
        if (v0) acc[j][k] = popc_xor(x0, y);
        if (v8) acc[j][2 + k] = popc_xor(x8, y);
      }
    }
  } else if (V == V_XOR || V == V_AND_POP) {
    const unsigned a[4] = {sa[ra][t], sa[ra + 8][t], sa[ra][t + 4], sa[ra + 8][t + 4]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned b0 = sb[j * 8 + g][t], b1 = sb[j * 8 + g][t + 4];
      if (V == V_XOR) {
        mma_b1_xor(acc[j], a, b0, b1);
      } else {
        mma_b1(acc[j], a, b0, b1);
      }
    }
    if (V == V_AND_POP) {
      const int pa0 = popc_row(sa[ra]), pa8 = popc_row(sa[ra + 8]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int pb0 = popc_row(sb[j * 8 + 2 * t]), pb1 = popc_row(sb[j * 8 + 2 * t + 1]);
        acc[j][0] = pa0 + pb0 - 2 * acc[j][0];
        acc[j][1] = pa0 + pb1 - 2 * acc[j][1];
        acc[j][2] = pa8 + pb0 - 2 * acc[j][2];
        acc[j][3] = pa8 + pb1 - 2 * acc[j][3];
      }
    }
  } else {
    // K step w (32 bits) is descriptor word w; a thread's 4 bytes are bits
    // 4t..4t+3 (a0, a1; b0) and 16+4t..16+4t+3 (a2, a3; b1) of that word
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const unsigned lo = sa[ra][w], hi = sa[ra + 8][w];
      const unsigned a[4] = {pm1x4(lo >> (4 * t)), pm1x4(hi >> (4 * t)),
                             pm1x4(lo >> (16 + 4 * t)), pm1x4(hi >> (16 + 4 * t))};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned bw = sb[j * 8 + g][w];
        mma_s8(acc[j], a, pm1x4(bw >> (4 * t)), pm1x4(bw >> (16 + 4 * t)));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = (256 - acc[j][i]) >> 1;
  }
  store_tile(sc, acc, out, r0, c0, N1, N2);
}

template <int V>
void launch(const int* d1, const int* d2, int* out, int N1, int N2, cudaStream_t stream) {
  const dim3 grid((N2 + TN - 1) / TN, (N1 + TM - 1) / TM);
  hamming_variant_kernel<V><<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const unsigned*>(d1), reinterpret_cast<const unsigned*>(d2), out, N1, N2);
}

}  // namespace

extern "C" int probe_hamming(const int* d1, const int* d2, int* out, int N1, int N2,
                             int variant, void* stream) {
  if (variant < 0 || variant >= N_VARIANTS) return (int)cudaErrorInvalidValue;
  if (N1 > 0 && N2 > 0) {
    const auto s = (cudaStream_t)stream;
    switch (variant) {
      case V_POPC: launch<V_POPC>(d1, d2, out, N1, N2, s); break;
      case V_XOR: launch<V_XOR>(d1, d2, out, N1, N2, s); break;
      case V_AND_POP: launch<V_AND_POP>(d1, d2, out, N1, N2, s); break;
      case V_S8: launch<V_S8>(d1, d2, out, N1, N2, s); break;
      case V_POPC_VALID: launch<V_POPC_VALID>(d1, d2, out, N1, N2, s); break;
      default: launch<V_POPC_SPREAD>(d1, d2, out, N1, N2, s); break;
    }
  }
  return (int)cudaGetLastError();
}
