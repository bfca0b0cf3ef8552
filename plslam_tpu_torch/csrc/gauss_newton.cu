// The robust Gauss-Newton pose solve of frontend/tracker.py (gauss_newton:
// every trip, the final build and the covariance) as one launch: one
// thread block per problem, B problems in one launch (blockIdx.x).
//
// Replaces, on the card, the plain gauss_newton_plain of
// plslam_tpu_torch/frontend/tracker.py (the JAX package's
// frontend/tracker.gauss_newton under jit), which ran ~340 PyTorch kernels
// per normal-equation build and trip, ~5,800 a VO frame.
//
// Bound: latency.  A problem is ~1,100 rows of a few floats (800 points and
// 320 line slots at the EuRoC configuration) and a dozen 6x6 solves; it
// fits one block's shared memory, so the solve never leaves the SM.
//
// Design.
// - Rows (points, then lines) are strided over the block's threads; each
//   thread computes the residuals and Jacobians of its rows in registers,
//   in the plain code's f32 operations and order (the file builds with
//   -fmad=false, so no multiply-add is contracted; no fast-math).
// - The two MAD medians per modality and build are exact selections over
//   the residuals held in shared memory: a radix select, 8 bits a pass, on
//   the order-preserving uint32 image of the f32 keys (masked rows +inf,
//   NaN above +inf, -0 below +0: torch.sort's order on the card).  It
//   returns sorted(valid)[n_valid // 2], 0 with no valid row, as
//   core/robust.masked_median_upper.  Both modalities select in the same
//   passes; the histograms use integer shared-memory atomics (exact).
// - The weighted Gram's 28 used entries (H's lower triangle, g, e) are
//   summed per thread, then by warp shuffles, then over the warps in
//   order: no float atomics, so every replay gives the same bits.
// - One thread runs each trip's small solve (stopping rule, 6x6 Cholesky
//   and its ok test, the step, exp(-step) @ DT, the carry of the form
//   early_exit names) and broadcasts it through shared memory.

#include <cuda_runtime.h>

// Inputs, in the order of TrackedPoints and TrackedLines after DT0.
enum {
  IN_DT0, IN_P, IN_OBS, IN_PSIGMA2, IN_PVALID, IN_PINLIER,
  IN_SP3, IN_EP3, IN_SP, IN_EP, IN_NDC, IN_SOBS, IN_EOBS, IN_LE, IN_LSIGMA2, IN_LVALID,
  IN_LINLIER, N_IN
};
enum { OUT_DT, OUT_COV, OUT_ERR, OUT_GOOD, OUT_DONE, N_OUT };

// The launch's arguments (ops/cuda_gauss_newton.GNArgs); outside the
// anonymous namespace, so the C entry that takes it keeps external linkage.
struct GNArgs {
  const void* in[N_IN];
  long long bstride[N_IN];   // elements between one problem's block and the next (0: shared)
  void* out[N_OUT];
  int batch, n_points, n_lines, use_points, use_lines, plucker, early_exit, max_iters;
  float fx, fy, cx, cy, k20, k21, k22, min_error, min_error_change;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 8192;   // points + lines a problem: ops/cuda_gauss_newton.MAX_ROWS
constexpr int NSUM = 28;         // H lower triangle (21), g (6), e (1)
constexpr unsigned FULL = 0xffffffffu;
constexpr float HOMOG_TH = 1e-7f;                 // tracker.HOMOG_TH
constexpr float MAD_SCALE = 1.4826f;              // robust.MAD_SCALE
constexpr float SCALE_MIN = 1e-4f;                // robust.clipped_mad_scale th_min
constexpr float SCALE_MAX = 2.7955321496988725f;  // 7.815 ** 0.5
constexpr float ERR_PREV0 = 9.9e8f;

struct Smem {
  float r[MAX_ROWS];             // each row's residual
  unsigned char m[MAX_ROWS];     // valid & inlier
  unsigned hist[2][256];
  float part[WARPS][NSUM];
  int count[WARPS][2];
  float T[16];                   // the carry's pose
  float G[NSUM];
  float med[2], scale[2];
  unsigned pref[2];
  unsigned rank[2];
  int nvalid[2];
  int done;
};

__device__ __forceinline__ float clamp_lo(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_hi(float v, float hi) { return v > hi ? hi : v; }
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// torch.sort's order as unsigned keys; every NaN is the largest key.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned x = __float_as_uint(v);
  if (v != v) return FULL;
  return x ^ ((x & 0x80000000u) ? FULL : 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  if (k == FULL) return __int_as_float(0x7fc00000);
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}
constexpr unsigned KEY_INF = 0xff800000u;   // order_key(+inf)

// R p + t of the 4x4 row-major T, one coordinate.
__device__ __forceinline__ float xform(const float* T, int i, float p0, float p1, float p2) {
  return T[4 * i] * p0 + T[4 * i + 1] * p1 + T[4 * i + 2] * p2 + T[4 * i + 3];
}
__device__ __forceinline__ float rot(const float* T, int i, float p0, float p1, float p2) {
  return T[4 * i] * p0 + T[4 * i + 1] * p1 + T[4 * i + 2] * p2;
}
__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

struct Problem {
  const float *P, *obs, *sP3, *eP3, *sp, *ep, *NDc, *sobs, *eobs, *le, *lsigma2;
  const unsigned char *pvalid, *pinlier, *lvalid, *linlier;
};

// tracker.point_residuals: r and, with JAC, the 6-vector Jacobian.
template <bool JAC>
__device__ float point_row(const GNArgs& a, const float* T, const float* P, const float* obs,
                           float* J) {
  float Pc[3];
  for (int i = 0; i < 3; ++i) Pc[i] = xform(T, i, P[0], P[1], P[2]);
  const float e0 = a.fx * Pc[0] / Pc[2] + a.cx - obs[0];
  const float e1 = a.fy * Pc[1] / Pc[2] + a.cy - obs[1];
  const float r = sqrtf(e0 * e0 + e1 * e1);
  if (JAC) {
    const float z2 = clamp_lo(Pc[2] * Pc[2], HOMOG_TH);
    const float zs = clamp_lo(Pc[2], HOMOG_TH);
    const float fxz = a.fx / zs, fyz = a.fy / zs;
    const float rs = clamp_lo(r, HOMOG_TH);
    J[0] = e0 * fxz / rs;
    J[1] = e1 * fyz / rs;
    J[2] = -(e0 * a.fx * Pc[0] + e1 * a.fy * Pc[1]) / z2 / rs;
    cross(Pc, J, J + 3);
  }
  return r;
}

// tracker.line_residuals_endpoint's endpoint_J for one endpoint.
__device__ void endpoint_jac(const GNArgs& a, const float* Pc, const float* lo, float* out) {
  const float z2 = clamp_lo(Pc[2] * Pc[2], HOMOG_TH);
  const float zs = clamp_lo(Pc[2], HOMOG_TH);
  out[0] = lo[0] * a.fx / zs;
  out[1] = lo[1] * a.fy / zs;
  out[2] = -(lo[0] * a.fx * Pc[0] + lo[1] * a.fy * Pc[1]) / z2;
  cross(Pc, out, out + 3);
}

// A line row: r_l (returned), and with JAC its Jacobian, r_g and the f2f
// overlap (line_residuals_plucker / _endpoint, f2f_line_overlap).
template <bool JAC>
__device__ float line_row(const GNArgs& a, const float* T, const Problem& p, int i, float* J,
                          float* r_g, float* overlap) {
  const float* sP3 = p.sP3 + 3 * i;
  const float* eP3 = p.eP3 + 3 * i;
  float sPc[3], ePc[3], spp[2], epp[2];
  const bool need_ends = JAC || !a.plucker;
  if (need_ends) {
    for (int k = 0; k < 3; ++k) {
      sPc[k] = xform(T, k, sP3[0], sP3[1], sP3[2]);
      ePc[k] = xform(T, k, eP3[0], eP3[1], eP3[2]);
    }
    spp[0] = a.fx * sPc[0] / sPc[2] + a.cx;
    spp[1] = a.fy * sPc[1] / sPc[2] + a.cy;
    epp[0] = a.fx * ePc[0] / ePc[2] + a.cx;
    epp[1] = a.fy * ePc[1] / ePc[2] + a.cy;
  }
  float r;
  if (a.plucker) {
    const float* L = p.NDc + 6 * i;
    float n[3], d[3], td[3];
    for (int k = 0; k < 3; ++k) {
      n[k] = rot(T, k, L[0], L[1], L[2]);
      d[k] = rot(T, k, L[3], L[4], L[5]);
    }
    const float t[3] = {T[3], T[7], T[11]};
    cross(t, d, td);
    for (int k = 0; k < 3; ++k) n[k] = n[k] + td[k];
    const float lx = a.fy * n[0], ly = a.fx * n[1];
    const float lz = a.k20 * n[0] + a.k21 * n[1] + a.k22 * n[2];
    const float fm = 1.0f / sqrtf(clamp_lo(lx * lx + ly * ly, HOMOG_TH));
    const float a0 = p.sobs[2 * i], b0 = p.sobs[2 * i + 1];
    const float a1 = p.eobs[2 * i], b1 = p.eobs[2 * i + 1];
    const float e0 = (a0 * lx + b0 * ly + lz) * fm;
    const float e1 = (a1 * lx + b1 * ly + lz) * fm;
    r = sqrtf(e0 * e0 + e1 * e1);
    if (JAC) {
      const float de0[3] = {a0 * fm - lx * e0 * fm * fm, b0 * fm - ly * e0 * fm * fm, fm};
      const float de1[3] = {a1 * fm - lx * e1 * fm * fm, b1 * fm - ly * e1 * fm * fm, fm};
      const float rs = clamp_lo(r, HOMOG_TH);
      float de[3];
      for (int k = 0; k < 3; ++k) de[k] = (de0[k] * e0 + de1[k] * e1) / rs;
      const float u[3] = {a.fy * de[0] + a.k20 * de[2], a.fx * de[1] + a.k21 * de[2],
                          a.k22 * de[2]};
      cross(d, u, J);
      cross(n, u, J + 3);
      *r_g = r * sqrtf(p.lsigma2[i]);
    }
  } else {
    const float* lo = p.le + 3 * i;
    const float e0 = lo[0] * spp[0] + lo[1] * spp[1] + lo[2];
    const float e1 = lo[0] * epp[0] + lo[1] * epp[1] + lo[2];
    r = sqrtf(e0 * e0 + e1 * e1);
    if (JAC) {
      float Js[6], Je[6];
      endpoint_jac(a, sPc, lo, Js);
      endpoint_jac(a, ePc, lo, Je);
      const float rs = clamp_lo(r, HOMOG_TH);
      for (int k = 0; k < 6; ++k) J[k] = (Js[k] * e0 + Je[k] * e1) / rs;
      *r_g = r;
    }
  }
  if (JAC) {
    const float s0 = p.sp[2 * i], s1 = p.sp[2 * i + 1];
    const float l0 = p.ep[2 * i] - s0, l1 = p.ep[2 * i + 1] - s1;
    const float denom = clamp_lo(l0 * l0 + l1 * l1, 1e-12f);
    const float lam_s = ((spp[0] - s0) * l0 + (spp[1] - s1) * l1) / denom;
    const float lam_e = ((epp[0] - s0) * l0 + (epp[1] - s1) * l1) / denom;
    const float ov = clamp_hi(nan_max(lam_s, lam_e), 1.0f) - clamp_lo(nan_min(lam_s, lam_e), 0.0f);
    *overlap = clamp_hi(clamp_lo(ov, 0.0f), 1.0f);
  }
  return r;
}

// Each modality's k-th smallest key (k = nvalid / 2) over its rows, with
// the key of |r - med| (mad) or of r; masked rows are +inf.  Leaves the
// value in out[mod], 0 where no row is valid.  Rows [0, np) are modality
// 0, [np, n) modality 1.
__device__ void select_upper_median(Smem& s, int n, int np, bool mad, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 2) {
    s.pref[tid] = 0;
    s.rank[tid] = (unsigned)(s.nvalid[tid] / 2);
  }
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int j = tid; j < 2 * 256; j += THREADS) (&s.hist[0][0])[j] = 0;
    __syncthreads();
    const unsigned hi = shift == 24 ? 0u : FULL << (shift + 8);
    for (int i = tid; i < n; i += THREADS) {
      const int mod = i >= np;
      const float v = mad ? fabsf(s.r[i] - s.med[mod]) : s.r[i];
      const unsigned key = s.m[i] ? order_key(v) : KEY_INF;
      if ((key & hi) == (s.pref[mod] & hi)) atomicAdd(&s.hist[mod][(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp < 2) {
      const int mod = warp;
      unsigned c[8], sum = 0;
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[mod][lane * 8 + j];
        sum += c[j];
      }
      unsigned incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      const unsigned k = s.rank[mod];
      const unsigned hit = __ballot_sync(FULL, incl > k);
      if (hit != 0 && lane == __ffs(hit) - 1) {
        unsigned cum = incl - sum;
        int j = 0;
        for (; j < 7 && k >= cum + c[j]; ++j) cum += c[j];
        s.pref[mod] |= (unsigned)(lane * 8 + j) << shift;
        s.rank[mod] = k - cum;
      }
    }
    __syncthreads();
  }
  if (tid < 2) out[tid] = s.nvalid[tid] > 0 ? key_value(s.pref[tid]) : 0.0f;
  __syncthreads();
}

// One weighted row into the 28 sums: (a_i w) a_j for H's lower triangle,
// g = (a_i w) a_6, e = (a_7 w) a_7, as the plain (A * w).T @ A.
__device__ __forceinline__ void accumulate(float* acc, const float* av, float w) {
  int q = 0;
  for (int i = 0; i < 6; ++i) {
    const float aw = av[i] * w;
    for (int j = 0; j <= i; ++j) acc[q++] += aw * av[j];
  }
  for (int i = 0; i < 6; ++i) acc[21 + i] += av[i] * w * av[6];
  acc[27] += av[7] * w * av[7];
}

// build_normal_equations at s.T into s.G; returns nothing, s.G[27] is e_sum.
__device__ void build(Smem& s, const GNArgs& a, const Problem& p, int np, int nl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = np + nl;
  // residuals for the medians
  for (int i = tid; i < n; i += THREADS) {
    const float r = i < np ? point_row<false>(a, s.T, p.P + 3 * i, p.obs + 2 * i, nullptr)
                           : line_row<false>(a, s.T, p, i - np, nullptr, nullptr, nullptr);
    s.r[i] = r;
  }
  __syncthreads();
  select_upper_median(s, n, np, false, s.med);
  select_upper_median(s, n, np, true, s.scale);
  if (tid < 2) {
    const float v = MAD_SCALE * s.scale[tid];
    s.scale[tid] = v != v ? v : clamp_hi(clamp_lo(v, SCALE_MIN), SCALE_MAX);
  }
  __syncthreads();
  float acc[NSUM];
  for (int q = 0; q < NSUM; ++q) acc[q] = 0.0f;
  for (int i = tid; i < n; i += THREADS) {
    if (!s.m[i]) continue;
    float av[8], w;
    if (i < np) {
      const float r = point_row<true>(a, s.T, p.P + 3 * i, p.obs + 2 * i, av);
      const float nr = r / s.scale[0];
      w = 1.0f / (nr * nr + 1.0f);
      av[6] = r;
      av[7] = r;
    } else {
      float rg, ov;
      const float r = line_row<true>(a, s.T, p, i - np, av, &rg, &ov);
      const float nr = r / s.scale[1];
      w = 1.0f / (nr * nr + 1.0f) * ov;
      av[6] = rg;
      av[7] = r;
    }
    accumulate(acc, av, w);
  }
  for (int q = 0; q < NSUM; ++q) {
    float v = acc[q];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) s.part[warp][q] = v;
  }
  __syncthreads();
  if (tid < NSUM) {
    float v = s.part[0][tid];
    for (int w = 1; w < WARPS; ++w) v += s.part[w][tid];
    s.G[tid] = v;
  }
  __syncthreads();
}

// Lower Cholesky of the 6x6 H (lower triangle, row-major packed as the
// sums); ok as tracker._cholesky: factorised, finite, positive diagonal.
__device__ bool cholesky6(const float* G, float L[6][6]) {
  bool ok = true;
  int q = 0;
  float H[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) H[i][j] = G[q++];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) L[i][j] = 0.0f;
  for (int j = 0; j < 6 && ok; ++j) {
    float d = H[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    if (!(d > 0.0f)) {
      ok = false;
      break;
    }
    d = sqrtf(d);
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float v = H[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / d;
    }
  }
  for (int i = 0; i < 6 && ok; ++i)
    for (int j = 0; j <= i; ++j) ok = ok && isfinite(L[i][j]);
  return ok;
}

// x = (L L^T)^-1 b.
__device__ void chol_solve6(const float L[6][6], const float* b, float* x) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float v = b[i];
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * x[k];
    x[i] = v / L[i][i];
  }
}

// E = lie.exp_se3(x), the 4x4 row-major transform of the twist [t; w].
__device__ void exp_se3(const float* x, float* E) {
  const float* t = x;
  const float* w = x + 3;
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = t2 < 1e-8f;
  const float ts = small ? 1.0f : sqrtf(t2);
  const float sn = sinf(ts), cs = cosf(ts);
  const float ca = small ? 1.0f - t2 / 6.0f : sn / ts;
  const float cb = small ? 0.5f - t2 / 24.0f : (1.0f - cs) / (ts * ts);
  const float cc = small ? 0.16666667f - t2 / 120.0f : (ts - sn) / (ts * ts * ts);
  const float W[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float WW[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) WW[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = e + ca * W[i][j] + cb * WW[i][j];
      V[i][j] = e + cb * W[i][j] + cc * WW[i][j];
    }
  for (int i = 0; i < 3; ++i) E[4 * i + 3] = V[i][0] * t[0] + V[i][1] * t[1] + V[i][2] * t[2];
  E[12] = 0.0f;
  E[13] = 0.0f;
  E[14] = 0.0f;
  E[15] = 1.0f;
}

__global__ void __launch_bounds__(THREADS) gn_pose_solve_kernel(const GNArgs a) {
  __shared__ Smem s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto in = [&](int k) {
    const size_t elt = k == IN_PVALID || k == IN_PINLIER || k == IN_LVALID || k == IN_LINLIER
                           ? 1 : sizeof(float);
    return static_cast<const char*>(a.in[k]) + (size_t)b * a.bstride[k] * elt;
  };
  Problem p;
  p.P = reinterpret_cast<const float*>(in(IN_P));
  p.obs = reinterpret_cast<const float*>(in(IN_OBS));
  p.sP3 = reinterpret_cast<const float*>(in(IN_SP3));
  p.eP3 = reinterpret_cast<const float*>(in(IN_EP3));
  p.sp = reinterpret_cast<const float*>(in(IN_SP));
  p.ep = reinterpret_cast<const float*>(in(IN_EP));
  p.NDc = reinterpret_cast<const float*>(in(IN_NDC));
  p.sobs = reinterpret_cast<const float*>(in(IN_SOBS));
  p.eobs = reinterpret_cast<const float*>(in(IN_EOBS));
  p.le = reinterpret_cast<const float*>(in(IN_LE));
  p.lsigma2 = reinterpret_cast<const float*>(in(IN_LSIGMA2));
  p.pvalid = reinterpret_cast<const unsigned char*>(in(IN_PVALID));
  p.pinlier = reinterpret_cast<const unsigned char*>(in(IN_PINLIER));
  p.lvalid = reinterpret_cast<const unsigned char*>(in(IN_LVALID));
  p.linlier = reinterpret_cast<const unsigned char*>(in(IN_LINLIER));
  const int np = a.use_points ? a.n_points : 0;
  const int nl = a.use_lines ? a.n_lines : 0;
  const int n = np + nl;

  // the masks and each modality's valid count, once: they hold for the call
  int cnt[2] = {0, 0};
  for (int i = tid; i < n; i += THREADS) {
    const bool v = i < np ? (p.pvalid[i] && p.pinlier[i])
                          : (p.lvalid[i - np] && p.linlier[i - np]);
    s.m[i] = v;
    cnt[i >= np] += v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    cnt[0] += __shfl_xor_sync(FULL, cnt[0], o);
    cnt[1] += __shfl_xor_sync(FULL, cnt[1], o);
  }
  if (lane == 0) {
    s.count[warp][0] = cnt[0];
    s.count[warp][1] = cnt[1];
  }
  const float* dt0 = reinterpret_cast<const float*>(in(IN_DT0));
  if (tid < 16) s.T[tid] = dt0[tid];
  if (tid == 0) s.done = 0;
  __syncthreads();
  if (tid < 2) {
    int v = 0;
    for (int w = 0; w < WARPS; ++w) v += s.count[w][tid];
    s.nvalid[tid] = v;
  }
  __syncthreads();
  // n_sum as the plain sum of the two f32 mask sums
  const float n_sum = (float)s.nvalid[0] + (float)s.nvalid[1];

  unsigned char* done_out = static_cast<unsigned char*>(a.out[OUT_DONE]) + (size_t)b * a.max_iters;
  float err_prev = ERR_PREV0;
  bool good = true;
  for (int trip = 0; trip < a.max_iters; ++trip) {
    const bool done = s.done;
    if (tid == 0) done_out[trip] = done;
    // a frozen carry stays frozen: the early-exit loop has stopped
    if (a.early_exit && done) continue;
    build(s, a, p, np, nl);
    if (tid == 0) {
      const float err = s.G[27] / fmaxf(n_sum, 1.0f);
      const bool stop = fabsf(err - err_prev) < a.min_error_change || err < a.min_error;
      float L[6][6], delta[6];
      bool ok = cholesky6(s.G, L);
      chol_solve6(L, s.G + 21, delta);
      for (int k = 0; k < 6; ++k) ok = ok && isfinite(delta[k]);
      const bool halt = done || stop || !ok;
      float step[6], nstep[6], sq = 0.0f;
      for (int k = 0; k < 6; ++k) {
        step[k] = halt ? 0.0f : delta[k];
        nstep[k] = -step[k];
        sq += step[k] * step[k];
      }
      const bool small = sqrtf(sq) < a.min_error_change;
      // early exit: only a carry not yet done reaches here
      float E[16], T[16];
      exp_se3(nstep, E);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          T[4 * i + j] = E[4 * i] * s.T[j] + E[4 * i + 1] * s.T[4 + j] + E[4 * i + 2] * s.T[8 + j]
                         + E[4 * i + 3] * s.T[12 + j];
      for (int k = 0; k < 16; ++k) s.T[k] = T[k];
      good = good && (ok || stop);
      if (!done) err_prev = err;
      s.done = halt || small;
    }
    __syncthreads();
  }
  build(s, a, p, np, nl);
  if (tid == 0) {
    const float err_final = s.G[27] / fmaxf(n_sum, 1.0f);
    float* cov = static_cast<float*>(a.out[OUT_COV]) + (size_t)b * 36;
    float L[6][6];
    const bool spd = cholesky6(s.G, L);
    for (int j = 0; j < 6; ++j) {
      float e[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, col[6];
      e[j] = 1.0f;
      chol_solve6(L, e, col);
      for (int i = 0; i < 6; ++i)
        cov[6 * i + j] = !good ? e[i] : (spd ? col[i] : __int_as_float(0x7fc00000));
    }
    float* DT = static_cast<float*>(a.out[OUT_DT]) + (size_t)b * 16;
    for (int k = 0; k < 16; ++k) DT[k] = s.T[k];
    static_cast<float*>(a.out[OUT_ERR])[b] = good ? err_final : -1.0f;
    static_cast<unsigned char*>(a.out[OUT_GOOD])[b] = good;
  }
}

// Test entry: masked_median_upper of each of B rows of n (x[b, :], mask[b, :])
// by the kernel's selection.
__global__ void __launch_bounds__(THREADS) gn_select_test_kernel(const float* x,
                                                                 const unsigned char* mask,
                                                                 int n, float* out) {
  __shared__ Smem s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int cnt = 0;
  for (int i = tid; i < n; i += THREADS) {
    s.r[i] = x[(size_t)b * n + i];
    s.m[i] = mask[(size_t)b * n + i] != 0;
    cnt += s.m[i];
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  if (lane == 0) s.count[warp][0] = cnt;
  __syncthreads();
  if (tid == 0) {
    int v = 0;
    for (int w = 0; w < WARPS; ++w) v += s.count[w][0];
    s.nvalid[0] = v;
    s.nvalid[1] = 0;
  }
  __syncthreads();
  select_upper_median(s, n, n, false, s.med);
  if (tid == 0) out[b] = s.med[0];
}

}  // namespace

extern "C" int plslam_gauss_newton(const GNArgs* args, void* stream) {
  if (args->n_points < 0 || args->n_lines < 0 || args->n_points + args->n_lines > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  if (args->batch > 0)
    gn_pose_solve_kernel<<<args->batch, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int plslam_gn_select_test(const float* x, const unsigned char* mask, int batch, int n,
                                     float* out, void* stream) {
  if (n < 0 || n > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (batch > 0)
    gn_select_test_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(x, mask, n, out);
  return (int)cudaGetLastError();
}

extern "C" int plslam_gn_max_rows() { return MAX_ROWS; }
