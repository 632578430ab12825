// The contact solver's per-row kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (edyn_tpu_torch/dynamics/solver_kernels.py).
//
// They replace the Pallas TPU kernels of edyn_tpu/dynamics/pallas_solver.py:
//   edyn_solve_iteration       <- solve_iteration_pallas (_make_vel_kernel)
//   edyn_ngs_iteration         <- ngs_iteration_pallas (_make_ngs_kernel)
//   edyn_restitution_iteration <- restitution_iteration_pallas
//                                 (_make_rest_kernel)
//   edyn_relvel                <- relvel_pallas (_make_relvel_kernel)
//
// Every kernel reads the component-major [C, Rp] row table of pack_rows_t
// and the gathered endpoint deltas g [6, 2Rp] (a-half, then b-half), and
// writes per-row outputs. The gather and the scatter-add stay in PyTorch
// around the kernel.
//
// Bound: memory. The arithmetic is ~100-300 float operations per row, far
// below the card's float32 rate, while each row moves 4 bytes per table
// row it reads plus its impulses and deltas (K1 at Rp = 160,128 with the
// spin/roll block: 88 table rows + 6 + 12 in, 6 + 12 out, about 79 MB, so
// about 24 us at 3.35 TB/s). Design: one thread per contact row; thread j
// reads tbl[c * Rp + j], so a warp reads 32 neighbouring floats of each
// table row and every load and store is coalesced. No shared memory: each
// value is read once.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

// base block row indices (pack_rows_t layout)
enum : int {
  N_ = 0, T1 = 3, T2 = 6,
  JAA_N = 9, JAB_N = 12, TA_N = 15, TB_N = 18,
  JAA_1 = 21, JAB_1 = 24, TA_1 = 27, TB_1 = 30,
  JAA_2 = 33, JAB_2 = 36, TA_2 = 39, TB_2 = 42,
  EM_N = 45, EM_1 = 46, EM_2 = 47, RHS_N = 48, RHS_1 = 49, RHS_2 = 50,
  INV_MA = 51, INV_MB = 52, FRICTION = 53, UPPER_N = 54, VALID = 55,
  RESTITUTION = 56, RA = 57, RB = 60, BASE_DIST = 63, NGS_VALID = 64,
  C_BASE = 65,
};
// spin/roll block, offsets from C_BASE
enum : int {
  SA_N = 0, SB_N = 3, SA_T1 = 6, SB_T1 = 9, SA_T2 = 12, SB_T2 = 15,
  ROLL_T1 = 18, ROLL_T2 = 21, EM_SPIN = 24, EM_ROLL1 = 25, EM_ROLL2 = 26,
  RHS_SPIN = 27, RHS_ROLL1 = 28, RHS_ROLL2 = 29, SPIN_F = 30, ROLL_F = 31,
};

constexpr int THREADS = 256;

struct Row {
  const float* __restrict__ t;
  long long rp;
  long long j;
  __device__ float operator()(int r) const { return t[r * rp + j]; }
  __device__ void vec(int r, float v[3]) const {
    v[0] = t[r * rp + j];
    v[1] = t[(r + 1) * rp + j];
    v[2] = t[(r + 2) * rp + j];
  }
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// relative velocity of a row direction against the gathered deltas
__device__ __forceinline__ float drel(const float d[3], const float ja[3],
                                      const float jb[3], const float va[3],
                                      const float wa[3], const float vb[3],
                                      const float wb[3]) {
  return dot3(d, va) + dot3(ja, wa) - dot3(d, vb) + dot3(jb, wb);
}

__device__ __forceinline__ void load_g(const float* __restrict__ g,
                                       long long rp, long long j, float va[3],
                                       float wa[3], float vb[3],
                                       float wb[3]) {
  const long long w = 2 * rp;
  for (int c = 0; c < 3; ++c) {
    va[c] = g[c * w + j];
    wa[c] = g[(c + 3) * w + j];
    vb[c] = g[c * w + rp + j];
    wb[c] = g[(c + 3) * w + rp + j];
  }
}

// project (i1, i2) onto the circle of radius max_len
__device__ __forceinline__ void circle(float& i1, float& i2, float max_len) {
  float ln = sqrtf(i1 * i1 + i2 * i2);
  float sc = ln > fmaxf(max_len, 1e-12f) ? max_len / fmaxf(ln, 1e-12f) : 1.f;
  i1 = i1 * sc;
  i2 = i2 * sc;
}

__device__ __forceinline__ void store_upd(float* __restrict__ o, long long rp,
                                          long long j, const float ual[3],
                                          const float uaa[3],
                                          const float ubl[3],
                                          const float uba[3]) {
  for (int c = 0; c < 3; ++c) {
    o[c * rp + j] = ual[c];
    o[(c + 3) * rp + j] = uaa[c];
    o[(c + 6) * rp + j] = ubl[c];
    o[(c + 9) * rp + j] = uba[c];
  }
}

__global__ void vel_kernel(const float* __restrict__ tbl,
                           const float* __restrict__ imp,
                           const float* __restrict__ g,
                           float* __restrict__ oimp,
                           float* __restrict__ oupd, int rp_, int with_sr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row T{tbl, rp, j};
  float va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  const float n_imp = imp[j], f1 = imp[rp + j], f2 = imp[2 * rp + j];
  const float s_imp = imp[3 * rp + j], ri1 = imp[4 * rp + j],
              ri2 = imp[5 * rp + j];

  float n[3], t1[3], t2[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(T1, t1);
  T.vec(T2, t2);

  // normal
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  float dlam = (T(RHS_N) - drel(n, ja, jb, va, wa, vb, wb)) * T(EM_N);
  float new_n = fminf(fmaxf(n_imp + dlam, 0.f), T(UPPER_N));
  float dn = new_n - n_imp;

  // friction circle against the updated normal impulse
  T.vec(JAA_1, ja);
  T.vec(JAB_1, jb);
  float d1 = (T(RHS_1) - drel(t1, ja, jb, va, wa, vb, wb)) * T(EM_1);
  T.vec(JAA_2, ja);
  T.vec(JAB_2, jb);
  float d2 = (T(RHS_2) - drel(t2, ja, jb, va, wa, vb, wb)) * T(EM_2);
  float imp1 = f1 + d1, imp2 = f2 + d2;
  circle(imp1, imp2, T(FRICTION) * new_n);

  const bool ok = T(VALID) > 0.5f;
  const float dn_ = ok ? dn : 0.f;
  const float df1_ = ok ? imp1 - f1 : 0.f;
  const float df2_ = ok ? imp2 - f2 : 0.f;

  float ual[3], ubl[3], uaa[3], uba[3];
  const float inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  float tan[3], tbn[3], ta1[3], tb1[3], ta2[3], tb2[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  T.vec(TA_1, ta1);
  T.vec(TB_1, tb1);
  T.vec(TA_2, ta2);
  T.vec(TB_2, tb2);
  for (int c = 0; c < 3; ++c) {
    float lin = n[c] * dn_ + t1[c] * df1_ + t2[c] * df2_;
    ual[c] = inv_ma * lin;
    ubl[c] = -inv_mb * lin;
    uaa[c] = tan[c] * dn_ + ta1[c] * df1_ + ta2[c] * df2_;
    uba[c] = tbn[c] * dn_ + tb1[c] * df1_ + tb2[c] * df2_;
  }

  float s_out = s_imp, r1_out = ri1, r2_out = ri2;
  if (with_sr) {
    const int B = C_BASE;
    float rel_s = dot3(n, wa) - dot3(n, wb);
    float max_s = T(B + SPIN_F) * new_n;
    float new_s = fminf(fmaxf(s_imp + (T(B + RHS_SPIN) - rel_s) *
                                          T(B + EM_SPIN), -max_s), max_s);
    float ds = new_s - s_imp;
    float rt1[3], rt2[3];
    T.vec(B + ROLL_T1, rt1);
    T.vec(B + ROLL_T2, rt2);
    float dr1 = (T(B + RHS_ROLL1) - (dot3(rt1, wa) - dot3(rt1, wb))) *
                T(B + EM_ROLL1);
    float dr2 = (T(B + RHS_ROLL2) - (dot3(rt2, wa) - dot3(rt2, wb))) *
                T(B + EM_ROLL2);
    float r1n = ri1 + dr1, r2n = ri2 + dr2;
    circle(r1n, r2n, T(B + ROLL_F) * new_n);
    const float ds_ = ok ? ds : 0.f;
    const float dr1_ = ok ? r1n - ri1 : 0.f;
    const float dr2_ = ok ? r2n - ri2 : 0.f;
    float san[3], sbn[3], sa1[3], sb1[3], sa2[3], sb2[3];
    T.vec(B + SA_N, san);
    T.vec(B + SB_N, sbn);
    T.vec(B + SA_T1, sa1);
    T.vec(B + SB_T1, sb1);
    T.vec(B + SA_T2, sa2);
    T.vec(B + SB_T2, sb2);
    for (int c = 0; c < 3; ++c) {
      uaa[c] = uaa[c] + san[c] * ds_ + sa1[c] * dr1_ + sa2[c] * dr2_;
      uba[c] = uba[c] + sbn[c] * ds_ + sb1[c] * dr1_ + sb2[c] * dr2_;
    }
    s_out = new_s;
    r1_out = r1n;
    r2_out = r2n;
  }

  oimp[j] = new_n;
  oimp[rp + j] = imp1;
  oimp[2 * rp + j] = imp2;
  oimp[3 * rp + j] = s_out;
  oimp[4 * rp + j] = r1_out;
  oimp[5 * rp + j] = r2_out;
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
}

__global__ void rest_kernel(const float* __restrict__ tbl,
                            const float* __restrict__ dyn,
                            const float* __restrict__ imp,
                            const float* __restrict__ g,
                            float* __restrict__ oimp,
                            float* __restrict__ oupd, int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row T{tbl, rp, j};
  float va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  const float rhs_n = dyn[j];
  const bool active = dyn[rp + j] > 0.5f;
  const float n_i = imp[j], f1 = imp[rp + j], f2 = imp[2 * rp + j];

  float n[3], t1[3], t2[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(T1, t1);
  T.vec(T2, t2);
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  float dlam = (rhs_n - drel(n, ja, jb, va, wa, vb, wb)) * T(EM_N);
  float new_n = fmaxf(n_i + dlam, 0.f);
  float dn = new_n - n_i;
  T.vec(JAA_1, ja);
  T.vec(JAB_1, jb);
  float d1 = -drel(t1, ja, jb, va, wa, vb, wb) * T(EM_1);
  T.vec(JAA_2, ja);
  T.vec(JAB_2, jb);
  float d2 = -drel(t2, ja, jb, va, wa, vb, wb) * T(EM_2);
  float imp1 = f1 + d1, imp2 = f2 + d2;
  circle(imp1, imp2, T(FRICTION) * new_n);

  const float dn_ = active ? dn : 0.f;
  const float df1_ = active ? imp1 - f1 : 0.f;
  const float df2_ = active ? imp2 - f2 : 0.f;
  float ual[3], ubl[3], uaa[3], uba[3];
  const float inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  float tan[3], tbn[3], ta1[3], tb1[3], ta2[3], tb2[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  T.vec(TA_1, ta1);
  T.vec(TB_1, tb1);
  T.vec(TA_2, ta2);
  T.vec(TB_2, tb2);
  for (int c = 0; c < 3; ++c) {
    float lin = n[c] * dn_ + t1[c] * df1_ + t2[c] * df2_;
    ual[c] = inv_ma * lin;
    ubl[c] = -inv_mb * lin;
    uaa[c] = tan[c] * dn_ + ta1[c] * df1_ + ta2[c] * df2_;
    uba[c] = tbn[c] * dn_ + tb1[c] * df1_ + tb2[c] * df2_;
  }
  oimp[j] = new_n;
  oimp[rp + j] = imp1;
  oimp[2 * rp + j] = imp2;
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
}

__global__ void relvel_kernel(const float* __restrict__ tbl,
                              const float* __restrict__ g,
                              float* __restrict__ out, int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row T{tbl, rp, j};
  float va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  float n[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  out[j] = drel(n, ja, jb, va, wa, vb, wb);
}

__global__ void ngs_kernel(const float* __restrict__ tbl,
                           const float* __restrict__ g,
                           float* __restrict__ oupd, float* __restrict__ oerr,
                           int rp_, float rate, float max_corr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row T{tbl, rp, j};
  float dpa[3], daa[3], dpb[3], dab[3];
  load_g(g, rp, j, dpa, daa, dpb, dab);
  float n[3], ra[3], rb[3];
  T.vec(N_, n);
  T.vec(RA, ra);
  T.vec(RB, rb);
  float ca[3] = {daa[1] * ra[2] - daa[2] * ra[1],
                 daa[2] * ra[0] - daa[0] * ra[2],
                 daa[0] * ra[1] - daa[1] * ra[0]};
  float cb[3] = {dab[1] * rb[2] - dab[2] * rb[1],
                 dab[2] * rb[0] - dab[0] * rb[2],
                 dab[0] * rb[1] - dab[1] * rb[0]};
  float corr[3];
  for (int c = 0; c < 3; ++c) corr[c] = dpa[c] + ca[c] - dpb[c] - cb[c];
  float dist = T(BASE_DIST) + dot3(corr, n);
  float error = fminf(fmaxf(-dist, 0.f), max_corr);
  error = T(NGS_VALID) > 0.5f ? error : 0.f;
  float lam = error * rate * T(EM_N);
  const float inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  float tan[3], tbn[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  float ual[3], uaa[3], ubl[3], uba[3];
  for (int c = 0; c < 3; ++c) {
    ual[c] = inv_ma * n[c] * lam;
    uaa[c] = tan[c] * lam;
    ubl[c] = -inv_mb * n[c] * lam;
    uba[c] = tbn[c] * lam;
  }
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
  oerr[j] = error;
}

inline dim3 grid_for(int rp) { return dim3((rp + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

int edyn_solve_iteration(const float* tbl, const float* imp, const float* g,
                         float* oimp, float* oupd, int Rp, int with_sr,
                         void* stream) {
  if (Rp > 0)
    vel_kernel<<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, imp, g, oimp, oupd, Rp, with_sr);
  return (int)cudaGetLastError();
}

int edyn_restitution_iteration(const float* tbl, const float* dyn,
                               const float* imp, const float* g, float* oimp,
                               float* oupd, int Rp, void* stream) {
  if (Rp > 0)
    rest_kernel<<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, dyn, imp, g, oimp, oupd, Rp);
  return (int)cudaGetLastError();
}

int edyn_relvel(const float* tbl, const float* g, float* out, int Rp,
                void* stream) {
  if (Rp > 0)
    relvel_kernel<<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, g, out, Rp);
  return (int)cudaGetLastError();
}

int edyn_ngs_iteration(const float* tbl, const float* g, float* oupd,
                       float* oerr, int Rp, float rate, float max_corr,
                       void* stream) {
  if (Rp > 0)
    ngs_kernel<<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, g, oupd, oerr, Rp, rate, max_corr);
  return (int)cudaGetLastError();
}

}  // extern "C"
