// The contact solver's per-row kernels for Hopper (sm_90a), with a plain C
// interface for ctypes (edyn_tpu_torch/dynamics/solver_kernels.py).
//
// They replace the Pallas TPU kernels of edyn_tpu/dynamics/pallas_solver.py:
//   edyn_solve_iteration_fused       <- solve_iteration_pallas
//     (_make_vel_kernel), with the gather and scatter-add around it
//   edyn_restitution_iteration_fused <- restitution_iteration_pallas
//     (_make_rest_kernel), the same
//   edyn_ngs_iteration_fused         <- ngs_iteration_pallas
//     (_make_ngs_kernel), the same
//   edyn_relvel_fused                <- relvel_pallas
//     (_make_relvel_kernel), with the gather and the pass's glue
// and edyn_segment_sum, which replaces none: it adds the fused kernels'
// update terms per body (see segment_sum_kernel). edyn_solve_iteration,
// edyn_restitution_iteration, edyn_ngs_iteration and edyn_relvel are K1,
// K3a, K2 and K3b without the fusion, as the TPU ran them: against
// gathered endpoint velocities or deltas, with the scatter-add (and K3b's
// glue) left to the caller. The step runs them on the CPU's path only (as
// their plain versions); on the card they are what the fused kernels are
// held to.
//
// Every kernel reads the component-major [C, Rp] row table of pack_rows_t.
// The unfused kernels read the gathered endpoint deltas g [6, 2Rp] (a-half,
// then b-half) and write per-row outputs; the fused ones read the [N, 8]
// body table by index and write their terms where the step's plan says.
//
// Each kernel is a template on the scalar type T with a float and a double
// instantiation: the entry points edyn_* take float tensors, edyn_*_f64
// double ones (the port's float64 mode, which the TPU build never had:
// Pallas on a TPU has no float64). Constants are T(...) and the math goes
// through the overloads below, so no float operation rounds a double.
//
// Bound: memory. The arithmetic is ~100-300 float operations per row, far
// below the card's float32 rate, while each row moves 4 bytes per table
// row it reads plus its impulses and deltas (K1 at Rp = 160,128 with the
// spin/roll block: 88 table rows + 6 + 12 in, 6 + 12 out, about 79 MB, so
// about 24 us at 3.35 TB/s). Design: one thread per contact row; thread j
// reads tbl[c * Rp + j], so a warp reads 32 neighbouring floats of each
// table row and every table load and impulse store is coalesced. No shared
// memory: each value is read once.
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

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fmin_(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double fmin_(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float fmax_(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double fmax_(double a, double b) {
  return fmax(a, b);
}

template <typename T>
struct Row {
  const T* __restrict__ t;
  long long rp;
  long long j;
  __device__ T operator()(int r) const { return t[r * rp + j]; }
  __device__ void vec(int r, T v[3]) const {
    v[0] = t[r * rp + j];
    v[1] = t[(r + 1) * rp + j];
    v[2] = t[(r + 2) * rp + j];
  }
};

template <typename T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// relative velocity of a row direction against the gathered deltas
template <typename T>
__device__ __forceinline__ T drel(const T d[3], const T ja[3], const T jb[3],
                                  const T va[3], const T wa[3],
                                  const T vb[3], const T wb[3]) {
  return dot3(d, va) + dot3(ja, wa) - dot3(d, vb) + dot3(jb, wb);
}

template <typename T>
__device__ __forceinline__ void load_g(const T* __restrict__ g,
                                       long long rp, long long j, T va[3],
                                       T wa[3], T vb[3], T wb[3]) {
  const long long w = 2 * rp;
  for (int c = 0; c < 3; ++c) {
    va[c] = g[c * w + j];
    wa[c] = g[(c + 3) * w + j];
    vb[c] = g[c * w + rp + j];
    wb[c] = g[(c + 3) * w + rp + j];
  }
}

// project (i1, i2) onto the circle of radius max_len
template <typename T>
__device__ __forceinline__ void circle(T& i1, T& i2, T max_len) {
  T ln = sqrt_(i1 * i1 + i2 * i2);
  T sc = ln > fmax_(max_len, T(1e-12)) ? max_len / fmax_(ln, T(1e-12))
                                       : T(1);
  i1 = i1 * sc;
  i2 = i2 * sc;
}

template <typename T>
__device__ __forceinline__ void store_upd(T* __restrict__ o, long long rp,
                                          long long j, const T ual[3],
                                          const T uaa[3], const T ubl[3],
                                          const T uba[3]) {
  for (int c = 0; c < 3; ++c) {
    o[c * rp + j] = ual[c];
    o[(c + 3) * rp + j] = uaa[c];
    o[(c + 6) * rp + j] = ubl[c];
    o[(c + 9) * rp + j] = uba[c];
  }
}

// K1's arithmetic on row j against its endpoint deltas (va, wa, vb, wb):
// writes the row's impulses to oimp and its twelve update terms to ual, uaa
// (body a: linear, angular), ubl, uba (body b). vel_kernel and
// vel_fused_kernel share it, so both round the same way, op by op.
template <typename F>
__device__ __forceinline__ void vel_row(const Row<F>& T,
                                        const F* __restrict__ imp,
                                        F* __restrict__ oimp, long long rp,
                                        long long j, const F va[3],
                                        const F wa[3], const F vb[3],
                                        const F wb[3], int with_sr, F ual[3],
                                        F uaa[3], F ubl[3], F uba[3]) {
  const F n_imp = imp[j], f1 = imp[rp + j], f2 = imp[2 * rp + j];
  const F s_imp = imp[3 * rp + j], ri1 = imp[4 * rp + j],
          ri2 = imp[5 * rp + j];

  F n[3], t1[3], t2[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(T1, t1);
  T.vec(T2, t2);

  // normal
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  F dlam = (T(RHS_N) - drel(n, ja, jb, va, wa, vb, wb)) * T(EM_N);
  F new_n = fmin_(fmax_(n_imp + dlam, F(0)), T(UPPER_N));
  F dn = new_n - n_imp;

  // friction circle against the updated normal impulse
  T.vec(JAA_1, ja);
  T.vec(JAB_1, jb);
  F d1 = (T(RHS_1) - drel(t1, ja, jb, va, wa, vb, wb)) * T(EM_1);
  T.vec(JAA_2, ja);
  T.vec(JAB_2, jb);
  F d2 = (T(RHS_2) - drel(t2, ja, jb, va, wa, vb, wb)) * T(EM_2);
  F imp1 = f1 + d1, imp2 = f2 + d2;
  circle(imp1, imp2, T(FRICTION) * new_n);

  const bool ok = T(VALID) > F(0.5);
  const F dn_ = ok ? dn : F(0);
  const F df1_ = ok ? imp1 - f1 : F(0);
  const F df2_ = ok ? imp2 - f2 : F(0);

  const F inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  F tan[3], tbn[3], ta1[3], tb1[3], ta2[3], tb2[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  T.vec(TA_1, ta1);
  T.vec(TB_1, tb1);
  T.vec(TA_2, ta2);
  T.vec(TB_2, tb2);
  for (int c = 0; c < 3; ++c) {
    F lin = n[c] * dn_ + t1[c] * df1_ + t2[c] * df2_;
    ual[c] = inv_ma * lin;
    ubl[c] = -inv_mb * lin;
    uaa[c] = tan[c] * dn_ + ta1[c] * df1_ + ta2[c] * df2_;
    uba[c] = tbn[c] * dn_ + tb1[c] * df1_ + tb2[c] * df2_;
  }

  F s_out = s_imp, r1_out = ri1, r2_out = ri2;
  if (with_sr) {
    const int B = C_BASE;
    F rel_s = dot3(n, wa) - dot3(n, wb);
    F max_s = T(B + SPIN_F) * new_n;
    F new_s = fmin_(fmax_(s_imp + (T(B + RHS_SPIN) - rel_s) *
                                          T(B + EM_SPIN), -max_s), max_s);
    F ds = new_s - s_imp;
    F rt1[3], rt2[3];
    T.vec(B + ROLL_T1, rt1);
    T.vec(B + ROLL_T2, rt2);
    F dr1 = (T(B + RHS_ROLL1) - (dot3(rt1, wa) - dot3(rt1, wb))) *
                T(B + EM_ROLL1);
    F dr2 = (T(B + RHS_ROLL2) - (dot3(rt2, wa) - dot3(rt2, wb))) *
                T(B + EM_ROLL2);
    F r1n = ri1 + dr1, r2n = ri2 + dr2;
    circle(r1n, r2n, T(B + ROLL_F) * new_n);
    const F ds_ = ok ? ds : F(0);
    const F dr1_ = ok ? r1n - ri1 : F(0);
    const F dr2_ = ok ? r2n - ri2 : F(0);
    F san[3], sbn[3], sa1[3], sb1[3], sa2[3], sb2[3];
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
}

// K3a's arithmetic on row j (dyn: rhs_n | active), as vel_row.
template <typename F>
__device__ __forceinline__ void rest_row(const Row<F>& T,
                                         const F* __restrict__ dyn,
                                         const F* __restrict__ imp,
                                         F* __restrict__ oimp, long long rp,
                                         long long j, const F va[3],
                                         const F wa[3], const F vb[3],
                                         const F wb[3], F ual[3], F uaa[3],
                                         F ubl[3], F uba[3]) {
  const F rhs_n = dyn[j];
  const bool active = dyn[rp + j] > F(0.5);
  const F n_i = imp[j], f1 = imp[rp + j], f2 = imp[2 * rp + j];

  F n[3], t1[3], t2[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(T1, t1);
  T.vec(T2, t2);
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  F dlam = (rhs_n - drel(n, ja, jb, va, wa, vb, wb)) * T(EM_N);
  F new_n = fmax_(n_i + dlam, F(0));
  F dn = new_n - n_i;
  T.vec(JAA_1, ja);
  T.vec(JAB_1, jb);
  F d1 = -drel(t1, ja, jb, va, wa, vb, wb) * T(EM_1);
  T.vec(JAA_2, ja);
  T.vec(JAB_2, jb);
  F d2 = -drel(t2, ja, jb, va, wa, vb, wb) * T(EM_2);
  F imp1 = f1 + d1, imp2 = f2 + d2;
  circle(imp1, imp2, T(FRICTION) * new_n);

  const F dn_ = active ? dn : F(0);
  const F df1_ = active ? imp1 - f1 : F(0);
  const F df2_ = active ? imp2 - f2 : F(0);
  const F inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  F tan[3], tbn[3], ta1[3], tb1[3], ta2[3], tb2[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  T.vec(TA_1, ta1);
  T.vec(TB_1, tb1);
  T.vec(TA_2, ta2);
  T.vec(TB_2, tb2);
  for (int c = 0; c < 3; ++c) {
    F lin = n[c] * dn_ + t1[c] * df1_ + t2[c] * df2_;
    ual[c] = inv_ma * lin;
    ubl[c] = -inv_mb * lin;
    uaa[c] = tan[c] * dn_ + ta1[c] * df1_ + ta2[c] * df2_;
    uba[c] = tbn[c] * dn_ + tb1[c] * df1_ + tb2[c] * df2_;
  }
  oimp[j] = new_n;
  oimp[rp + j] = imp1;
  oimp[2 * rp + j] = imp2;
}

template <typename F>
__global__ void vel_kernel(const F* __restrict__ tbl,
                           const F* __restrict__ imp,
                           const F* __restrict__ g, F* __restrict__ oimp,
                           F* __restrict__ oupd, int rp_, int with_sr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  F ual[3], uaa[3], ubl[3], uba[3];
  vel_row(T, imp, oimp, rp, j, va, wa, vb, wb, with_sr, ual, uaa, ubl, uba);
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
}

template <typename F>
__global__ void rest_kernel(const F* __restrict__ tbl,
                            const F* __restrict__ dyn,
                            const F* __restrict__ imp,
                            const F* __restrict__ g, F* __restrict__ oimp,
                            F* __restrict__ oupd, int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  F ual[3], uaa[3], ubl[3], uba[3];
  rest_row(T, dyn, imp, oimp, rp, j, va, wa, vb, wb, ual, uaa, ubl, uba);
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
}

// ---------------------------------------------------------------------------
// The fused iterations and the segment sum (the card's solver loops)
// ---------------------------------------------------------------------------
//
// vel_fused_kernel, rest_fused_kernel and ngs_fused_kernel (below, beside
// ngs_kernel) replace the same TPU kernels as vel_kernel, rest_kernel and
// ngs_kernel (pallas_solver.py:254/262, :338/342 and :441), with
// the XLA gather and scatter-add that ran around them on the TPU, where
// Mosaic could not lower a gather by index inside the kernel. Here a
// thread loads its row's two endpoint deltas by index from the body table
// d [N, 8] (lin 0:3 | ang 3:6 | two zeros: one 32-byte sector per body in
// float, which sits in L2: 10,005 bodies are 320 KB of a 50 MB L2), runs
// the row's arithmetic (vel_row / rest_row / ngs_row), and writes each of
// its two update terms as one [8] row of a terms buffer at the position the
// step's scatter plan gives it (dynamics/scatter.py), -1 for a term the
// plan leaves out (an invalid row, or a body with zero inverse mass and
// inertia, whose terms are zero). segment_sum_kernel then adds each
// body's run of terms. Bound: memory, as vel_kernel: the table rows, the
// impulses in and out, the endpoint indices and positions, and the terms
// out; the endpoint loads hit L2. The design keeps every table load and
// impulse store coalesced (thread j reads column j) and replaces the
// unfused path's gather, [12, Rp] update and scatter-add (a sort of the
// 2Rp targets every call) with the terms buffer's 32-byte rows.

__device__ __forceinline__ void load_body(const float* __restrict__ d,
                                          long long i, float v[3],
                                          float w[3]) {
  const float4* p = reinterpret_cast<const float4*>(d + 8 * i);
  const float4 x = p[0], y = p[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z;
  w[0] = x.w; w[1] = y.x; w[2] = y.y;
}

__device__ __forceinline__ void load_body(const double* __restrict__ d,
                                          long long i, double v[3],
                                          double w[3]) {
  const double2* p = reinterpret_cast<const double2*>(d + 8 * i);
  const double2 x = p[0], y = p[1], z = p[2];
  v[0] = x.x; v[1] = x.y; v[2] = y.x;
  w[0] = y.y; w[1] = z.x; w[2] = z.y;
}

__device__ __forceinline__ void store_term(float* t, int pos,
                                           const float l[3],
                                           const float a[3]) {
  float4* p = reinterpret_cast<float4*>(t + 8 * (long long)pos);
  p[0] = make_float4(l[0], l[1], l[2], a[0]);
  p[1] = make_float4(a[1], a[2], 0.f, 0.f);
}

__device__ __forceinline__ void store_term(double* t, int pos,
                                           const double l[3],
                                           const double a[3]) {
  double2* p = reinterpret_cast<double2*>(t + 8 * (long long)pos);
  p[0] = make_double2(l[0], l[1]);
  p[1] = make_double2(l[2], a[0]);
  p[2] = make_double2(a[1], a[2]);
  p[3] = make_double2(0.0, 0.0);
}

// the endpoint deltas of row j, and where its two terms go (the a-term to
// terms_a, the b-term to terms_b: one buffer, or two when the plan's
// chain has a hop for each)
template <typename F>
__device__ __forceinline__ void load_ends(const F* __restrict__ d,
                                          const int* __restrict__ ab,
                                          long long rp, long long j,
                                          F va[3], F wa[3], F vb[3],
                                          F wb[3]) {
  load_body(d, ab[j], va, wa);
  load_body(d, ab[rp + j], vb, wb);
}

template <typename F>
__device__ __forceinline__ void store_ends(const int* __restrict__ pos,
                                           F* terms_a, F* terms_b,
                                           long long rp, long long j,
                                           const F ual[3], const F uaa[3],
                                           const F ubl[3], const F uba[3]) {
  const int pa = pos[j], pb = pos[rp + j];
  if (pa >= 0) store_term(terms_a, pa, ual, uaa);
  if (pb >= 0) store_term(terms_b, pb, ubl, uba);
}

template <typename F>
__global__ void vel_fused_kernel(const F* __restrict__ tbl,
                                 const F* __restrict__ imp,
                                 const F* __restrict__ d,
                                 const int* __restrict__ ab,
                                 const int* __restrict__ pos, F* terms_a,
                                 F* terms_b, F* __restrict__ oimp, int rp_,
                                 int with_sr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F va[3], wa[3], vb[3], wb[3];
  load_ends(d, ab, rp, j, va, wa, vb, wb);
  F ual[3], uaa[3], ubl[3], uba[3];
  vel_row(T, imp, oimp, rp, j, va, wa, vb, wb, with_sr, ual, uaa, ubl, uba);
  store_ends(pos, terms_a, terms_b, rp, j, ual, uaa, ubl, uba);
}

template <typename F>
__global__ void rest_fused_kernel(const F* __restrict__ tbl,
                                  const F* __restrict__ dyn,
                                  const F* __restrict__ imp,
                                  const F* __restrict__ d,
                                  const int* __restrict__ ab,
                                  const int* __restrict__ pos, F* terms_a,
                                  F* terms_b, F* __restrict__ oimp,
                                  int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F va[3], wa[3], vb[3], wb[3];
  load_ends(d, ab, rp, j, va, wa, vb, wb);
  F ual[3], uaa[3], ubl[3], uba[3];
  rest_row(T, dyn, imp, oimp, rp, j, va, wa, vb, wb, ual, uaa, ubl, uba);
  store_ends(pos, terms_a, terms_b, rp, j, ual, uaa, ubl, uba);
}

// segment_sum_kernel replaces no TPU kernel: it is the card's scatter-add
// of the solver loops (what XLA's scatter-add did around the Pallas
// kernels), in the order of solver.index_sum, which the step's results
// are held to: for each body, a sum from zero of its live terms (a term is
// live when one of its six components is not zero) in plan order (row
// order, a-halves before b-halves), then x + that sum, written only where
// a term was live. Without x it is one hop of solver.chain_index_sum: the
// running sum ``start`` (where live) and the hop's terms summed from zero,
// then 0 + the sum, 0 where nothing was live. Atomics would add in
// whatever order threads arrive (ROADMAP P8).
//
// Bound: memory (one add per component and term): the terms read once
// (32 bytes each in float), the offsets, x (or start) in and the sums out.
// What held the first design back was latency: eight lanes a body read a
// term together and a ballot on the loaded value decided whether to add
// it, so every term of a run cost one L2 round trip. Design: the plan
// sorts the terms by body, so the terms of SEG_BODIES consecutive bodies
// are one contiguous span, terms[off[b0] : off[b0 + SEG_BODIES]]. A block
// stages that span in shared memory with 16-byte asynchronous copies
// (cp.async), all of a stage's loads in flight at once, in stages of
// SEG_STAGE_BYTES, double-buffered, so a span longer than one stage
// streams while the stage before it is summed; x and the start value load
// meanwhile. Then the eight lanes of a body (lane c holds component c; 6
// and 7 are the zero padding) add its terms of the stage from shared
// memory in plan order, a ballot over the body's six lanes being the live
// test, as the first design did from L2. A warp serves four bodies and
// walks the busiest one's terms; a block serves 16 bodies (of 8, 16, 32
// and 64, the fastest on an H100 at the landed 10k pile's step:
// scripts/torch_kernel_ab.py). There (~12 planned terms a body) a block
// stages ~6 KB in one stage, and ~630 blocks keep the whole span in
// flight at once. What remains is latency: the offsets, then the span
// from device memory, then the sum and the stores, one after the other.
constexpr int SEG_BODIES = 16;
constexpr int SEG_LANES = 8;
constexpr int SEG_THREADS = SEG_BODIES * SEG_LANES;
constexpr int SEG_STAGE_BYTES = 16384;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// copy terms[t0 : t0 + count] ([8] rows) into a stage, 16 bytes a copy
template <typename F>
__device__ __forceinline__ void stage_terms(F* stage,
                                            const F* __restrict__ terms,
                                            int t0, int count) {
  constexpr int PIECES = 8 * sizeof(F) / 16;   // 16-byte pieces a term
  const char* src = reinterpret_cast<const char*>(terms + 8LL * t0);
  char* dst = reinterpret_cast<char*>(stage);
  for (int p = threadIdx.x; p < count * PIECES; p += SEG_THREADS)
    cp_async16(dst + 16 * p, src + 16LL * p);
}

// g += v where v is live: a component of 0:6 not zero in any of the body's
// lanes (body_lanes); without a branch, so an unrolled loop can load the
// next terms while it adds
template <typename F>
__device__ __forceinline__ void add_live(F& g, F v, unsigned body_lanes,
                                         bool& any) {
  const bool live = (__ballot_sync(0xffffffffu, v != F(0)) & body_lanes) != 0;
  g = live ? g + v : g;
  any = any | live;
}

template <typename F>
__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const F* __restrict__ terms, const int* __restrict__ off,
                   const F* start, const F* x, F* out, int n) {
  constexpr int STAGE = SEG_STAGE_BYTES / (8 * (int)sizeof(F));  // terms
  __shared__ __align__(16) F stage[2][STAGE * 8];
  const int lane = threadIdx.x & 31;
  const int c = lane & (SEG_LANES - 1);
  const unsigned body_lanes = 0x3fu << (lane & ~(SEG_LANES - 1));
  const long long b0 = (long long)blockIdx.x * SEG_BODIES;
  const long long b = b0 + threadIdx.x / SEG_LANES;
  const bool has = b < n;
  const int lo = off[b0];
  const int hi = off[min((long long)n, b0 + SEG_BODIES)];
  const int s = has ? off[b] : 0, e = has ? off[b + 1] : 0;
  const int stages = (hi - lo + STAGE - 1) / STAGE;
  if (stages > 0) stage_terms(stage[0], terms, lo, min(STAGE, hi - lo));
  cp_async_commit();
  const long long i = b * SEG_LANES + c;
  const F xv = x != nullptr && has ? x[i] : F(0);
  const F sv = start != nullptr && has ? start[i] : F(0);
  F g = F(0);
  bool any = false;
  add_live(g, sv, body_lanes, any);  // the running sum is a first term
  for (int k = 0; k < stages; ++k) {
    const int t0 = lo + k * STAGE;
    if (k + 1 < stages)
      stage_terms(stage[(k + 1) & 1], terms, t0 + STAGE,
                  min(STAGE, hi - t0 - STAGE));
    cp_async_commit();
    cp_async_wait_one();  // stage k has landed (this thread's copies)
    __syncthreads();      // and every other thread's
    const F* buf = stage[k & 1] + c;
    const int from = max(s, t0);
    const int len = max(0, min(e, t0 + STAGE) - from);
    int most = len;       // the warp walks its busiest body's run
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
#pragma unroll 4
    for (int j = 0; j < most; ++j) {
      const F v = j < len ? buf[8 * (from - t0 + j)] : F(0);
      add_live(g, v, body_lanes, any);
    }
    __syncthreads();      // stage k is read before it is overwritten
  }
  if (!has) return;
  if (x == nullptr)
    out[i] = any ? F(0) + g : F(0);
  else if (any)
    out[i] = xv + g;
  else if (out != x)
    out[i] = xv;
}

template <typename F>
__global__ void relvel_kernel(const F* __restrict__ tbl,
                              const F* __restrict__ g, F* __restrict__ out,
                              int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F va[3], wa[3], vb[3], wb[3];
  load_g(g, rp, j, va, wa, vb, wb);
  F n[3], ja[3], jb[3];
  T.vec(N_, n);
  T.vec(JAA_N, ja);
  T.vec(JAB_N, jb);
  out[j] = drel(n, ja, jb, va, wa, vb, wb);
}

// K3b on the plan: one restitution outer pass's row-wise work in one
// launch, where the unfused pass ran a PyTorch gather of the velocities
// into [6, 2Rp], relvel_kernel and about ten PyTorch ops of glue. Thread j
// loads its row's endpoint velocities by index from the [N, 8] velocity
// table (load_ends, as rest_fused_kernel loads its deltas), computes
// relvel_kernel's r = drel(n, JaA_n, JaB_n, ...) in its order, and writes
// the pass's glue (edyn_tpu/dynamics/solver.py:624-628) in PyTorch's order:
// dyn[0, j] = (-r) * (1 + restitution) and dyn[1, j] = valid & (r < -0.005)
// & (restitution > 0) as 0/1. The pass's early-exit flag takes no memset
// and no atomic: each block ORs its rows' activity (__syncthreads_or), and
// thread 0 of a block with an active row stores the pass's generation
// number gen (new for each pass, from the host) to the persistent int32
// flag. Every writer stores the same value, so the host reads flag == gen
// as any(active). Bound: memory (11 table rows, the two int32 endpoints
// and the two outputs a row; the endpoint loads hit L2, 10,005 bodies being
// 320 KB of the velocity table).
template <typename F>
__global__ void relvel_fused_kernel(const F* __restrict__ tbl,
                                    const F* __restrict__ vel,
                                    const int* __restrict__ ab,
                                    F* __restrict__ dyn, int* flag, int gen,
                                    int rp_) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool active = false;
  if (j < rp) {  // no early return: every thread meets __syncthreads_or
    Row<F> T{tbl, rp, j};
    F va[3], wa[3], vb[3], wb[3];
    load_ends(vel, ab, rp, j, va, wa, vb, wb);
    F n[3], ja[3], jb[3];
    T.vec(N_, n);
    T.vec(JAA_N, ja);
    T.vec(JAB_N, jb);
    const F r = drel(n, ja, jb, va, wa, vb, wb);
    const F e = T(RESTITUTION);
    active = T(VALID) > F(0.5) && r < F(-0.005) && e > F(0);
    dyn[j] = (-r) * (F(1) + e);
    dyn[rp + j] = active ? F(1) : F(0);
  }
  if (__syncthreads_or(active) && threadIdx.x == 0) *flag = gen;
}

// K2's arithmetic on row j against its endpoints' position and rotation
// deltas (dpa, daa, dpb, dab): returns the row's error and writes its twelve
// update terms. ngs_kernel and ngs_fused_kernel share it, as vel_row.
template <typename F>
__device__ __forceinline__ F ngs_row(const Row<F>& T, const F dpa[3],
                                     const F daa[3], const F dpb[3],
                                     const F dab[3], F rate, F max_corr,
                                     F ual[3], F uaa[3], F ubl[3],
                                     F uba[3]) {
  F n[3], ra[3], rb[3];
  T.vec(N_, n);
  T.vec(RA, ra);
  T.vec(RB, rb);
  F ca[3] = {daa[1] * ra[2] - daa[2] * ra[1],
                 daa[2] * ra[0] - daa[0] * ra[2],
                 daa[0] * ra[1] - daa[1] * ra[0]};
  F cb[3] = {dab[1] * rb[2] - dab[2] * rb[1],
                 dab[2] * rb[0] - dab[0] * rb[2],
                 dab[0] * rb[1] - dab[1] * rb[0]};
  F corr[3];
  for (int c = 0; c < 3; ++c) corr[c] = dpa[c] + ca[c] - dpb[c] - cb[c];
  F dist = T(BASE_DIST) + dot3(corr, n);
  F error = fmin_(fmax_(-dist, F(0)), max_corr);
  error = T(NGS_VALID) > F(0.5) ? error : F(0);
  F lam = error * rate * T(EM_N);
  const F inv_ma = T(INV_MA), inv_mb = T(INV_MB);
  F tan[3], tbn[3];
  T.vec(TA_N, tan);
  T.vec(TB_N, tbn);
  for (int c = 0; c < 3; ++c) {
    ual[c] = inv_ma * n[c] * lam;
    uaa[c] = tan[c] * lam;
    ubl[c] = -inv_mb * n[c] * lam;
    uba[c] = tbn[c] * lam;
  }
  return error;
}

template <typename F>
__global__ void ngs_kernel(const F* __restrict__ tbl,
                           const F* __restrict__ g, F* __restrict__ oupd,
                           F* __restrict__ oerr, int rp_, F rate,
                           F max_corr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F dpa[3], daa[3], dpb[3], dab[3];
  load_g(g, rp, j, dpa, daa, dpb, dab);
  F ual[3], uaa[3], ubl[3], uba[3];
  oerr[j] = ngs_row(T, dpa, daa, dpb, dab, rate, max_corr, ual, uaa, ubl,
                    uba);
  store_upd(oupd, rp, j, ual, uaa, ubl, uba);
}

// The fused K2: ngs_kernel with its endpoint gather inside and its terms
// written where the step's plan puts them, as vel_fused_kernel. The body
// table d [N, 8] holds the position deltas (0:3) and the rotation deltas
// (3:6). A soft row (valid, ngs_valid 0) keeps its planned positions and
// writes a zero term there, which segment_sum skips as index_sum does.
template <typename F>
__global__ void ngs_fused_kernel(const F* __restrict__ tbl,
                                 const F* __restrict__ d,
                                 const int* __restrict__ ab,
                                 const int* __restrict__ pos, F* terms_a,
                                 F* terms_b, F* __restrict__ oerr, int rp_,
                                 F rate, F max_corr) {
  const long long rp = rp_;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rp) return;
  Row<F> T{tbl, rp, j};
  F dpa[3], daa[3], dpb[3], dab[3];
  load_ends(d, ab, rp, j, dpa, daa, dpb, dab);
  F ual[3], uaa[3], ubl[3], uba[3];
  oerr[j] = ngs_row(T, dpa, daa, dpb, dab, rate, max_corr, ual, uaa, ubl,
                    uba);
  store_ends(pos, terms_a, terms_b, rp, j, ual, uaa, ubl, uba);
}

inline dim3 grid_for(int rp) { return dim3((rp + THREADS - 1) / THREADS); }

template <typename F>
int solve_iteration(const F* tbl, const F* imp, const F* g, F* oimp,
                    F* oupd, int Rp, int with_sr, void* stream) {
  if (Rp > 0)
    vel_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, imp, g, oimp, oupd, Rp, with_sr);
  return (int)cudaGetLastError();
}

template <typename F>
int restitution_iteration(const F* tbl, const F* dyn, const F* imp,
                          const F* g, F* oimp, F* oupd, int Rp,
                          void* stream) {
  if (Rp > 0)
    rest_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, dyn, imp, g, oimp, oupd, Rp);
  return (int)cudaGetLastError();
}

template <typename F>
int solve_iteration_fused(const F* tbl, const F* imp, const F* d,
                          const int* ab, const int* pos, F* terms_a,
                          F* terms_b, F* oimp, int Rp, int with_sr,
                          void* stream) {
  if (Rp > 0)
    vel_fused_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, imp, d, ab, pos, terms_a, terms_b, oimp, Rp, with_sr);
  return (int)cudaGetLastError();
}

template <typename F>
int restitution_iteration_fused(const F* tbl, const F* dyn, const F* imp,
                                const F* d, const int* ab, const int* pos,
                                F* terms_a, F* terms_b, F* oimp, int Rp,
                                void* stream) {
  if (Rp > 0)
    rest_fused_kernel<F><<<grid_for(Rp), THREADS, 0,
                           (cudaStream_t)stream>>>(
        tbl, dyn, imp, d, ab, pos, terms_a, terms_b, oimp, Rp);
  return (int)cudaGetLastError();
}

template <typename F>
int segment_sum(const F* terms, const int* off, const F* start, const F* x,
                F* out, int n, void* stream) {
  if (n > 0) {
    const dim3 grid((unsigned)((n + SEG_BODIES - 1) / SEG_BODIES));
    segment_sum_kernel<F><<<grid, SEG_THREADS, 0, (cudaStream_t)stream>>>(
        terms, off, start, x, out, n);
  }
  return (int)cudaGetLastError();
}

template <typename F>
int relvel(const F* tbl, const F* g, F* out, int Rp, void* stream) {
  if (Rp > 0)
    relvel_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, g, out, Rp);
  return (int)cudaGetLastError();
}

template <typename F>
int relvel_fused(const F* tbl, const F* vel, const int* ab, F* dyn,
                 int* flag, int gen, int Rp, void* stream) {
  if (Rp > 0)
    relvel_fused_kernel<F><<<grid_for(Rp), THREADS, 0,
                             (cudaStream_t)stream>>>(tbl, vel, ab, dyn, flag,
                                                     gen, Rp);
  return (int)cudaGetLastError();
}

template <typename F>
int ngs_iteration(const F* tbl, const F* g, F* oupd, F* oerr, int Rp,
                  F rate, F max_corr, void* stream) {
  if (Rp > 0)
    ngs_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, g, oupd, oerr, Rp, rate, max_corr);
  return (int)cudaGetLastError();
}

template <typename F>
int ngs_iteration_fused(const F* tbl, const F* d, const int* ab,
                        const int* pos, F* terms_a, F* terms_b, F* oerr,
                        int Rp, F rate, F max_corr, void* stream) {
  if (Rp > 0)
    ngs_fused_kernel<F><<<grid_for(Rp), THREADS, 0, (cudaStream_t)stream>>>(
        tbl, d, ab, pos, terms_a, terms_b, oerr, Rp, rate, max_corr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int edyn_solve_iteration(const float* tbl, const float* imp, const float* g,
                         float* oimp, float* oupd, int Rp, int with_sr,
                         void* stream) {
  return solve_iteration(tbl, imp, g, oimp, oupd, Rp, with_sr, stream);
}

int edyn_restitution_iteration(const float* tbl, const float* dyn,
                               const float* imp, const float* g, float* oimp,
                               float* oupd, int Rp, void* stream) {
  return restitution_iteration(tbl, dyn, imp, g, oimp, oupd, Rp, stream);
}

int edyn_solve_iteration_fused(const float* tbl, const float* imp,
                               const float* d, const int* ab, const int* pos,
                               float* terms_a, float* terms_b, float* oimp,
                               int Rp, int with_sr, void* stream) {
  return solve_iteration_fused(tbl, imp, d, ab, pos, terms_a, terms_b, oimp,
                               Rp, with_sr, stream);
}

int edyn_restitution_iteration_fused(const float* tbl, const float* dyn,
                                     const float* imp, const float* d,
                                     const int* ab, const int* pos,
                                     float* terms_a, float* terms_b,
                                     float* oimp, int Rp, void* stream) {
  return restitution_iteration_fused(tbl, dyn, imp, d, ab, pos, terms_a,
                                     terms_b, oimp, Rp, stream);
}

int edyn_segment_sum(const float* terms, const int* off, const float* start,
                     const float* x, float* out, int n, void* stream) {
  return segment_sum(terms, off, start, x, out, n, stream);
}

int edyn_solve_iteration_fused_f64(const double* tbl, const double* imp,
                                   const double* d, const int* ab,
                                   const int* pos, double* terms_a,
                                   double* terms_b, double* oimp, int Rp,
                                   int with_sr, void* stream) {
  return solve_iteration_fused(tbl, imp, d, ab, pos, terms_a, terms_b, oimp,
                               Rp, with_sr, stream);
}

int edyn_restitution_iteration_fused_f64(const double* tbl,
                                         const double* dyn,
                                         const double* imp, const double* d,
                                         const int* ab, const int* pos,
                                         double* terms_a, double* terms_b,
                                         double* oimp, int Rp,
                                         void* stream) {
  return restitution_iteration_fused(tbl, dyn, imp, d, ab, pos, terms_a,
                                     terms_b, oimp, Rp, stream);
}

int edyn_segment_sum_f64(const double* terms, const int* off,
                         const double* start, const double* x, double* out,
                         int n, void* stream) {
  return segment_sum(terms, off, start, x, out, n, stream);
}

int edyn_relvel(const float* tbl, const float* g, float* out, int Rp,
                void* stream) {
  return relvel(tbl, g, out, Rp, stream);
}

int edyn_relvel_fused(const float* tbl, const float* vel, const int* ab,
                      float* dyn, int* flag, int gen, int Rp, void* stream) {
  return relvel_fused(tbl, vel, ab, dyn, flag, gen, Rp, stream);
}

int edyn_relvel_fused_f64(const double* tbl, const double* vel,
                          const int* ab, double* dyn, int* flag, int gen,
                          int Rp, void* stream) {
  return relvel_fused(tbl, vel, ab, dyn, flag, gen, Rp, stream);
}

int edyn_ngs_iteration(const float* tbl, const float* g, float* oupd,
                       float* oerr, int Rp, float rate, float max_corr,
                       void* stream) {
  return ngs_iteration(tbl, g, oupd, oerr, Rp, rate, max_corr, stream);
}

int edyn_ngs_iteration_fused(const float* tbl, const float* d,
                             const int* ab, const int* pos, float* terms_a,
                             float* terms_b, float* oerr, int Rp, float rate,
                             float max_corr, void* stream) {
  return ngs_iteration_fused(tbl, d, ab, pos, terms_a, terms_b, oerr, Rp,
                             rate, max_corr, stream);
}

int edyn_ngs_iteration_fused_f64(const double* tbl, const double* d,
                                 const int* ab, const int* pos,
                                 double* terms_a, double* terms_b,
                                 double* oerr, int Rp, double rate,
                                 double max_corr, void* stream) {
  return ngs_iteration_fused(tbl, d, ab, pos, terms_a, terms_b, oerr, Rp,
                             rate, max_corr, stream);
}

int edyn_solve_iteration_f64(const double* tbl, const double* imp,
                             const double* g, double* oimp, double* oupd,
                             int Rp, int with_sr, void* stream) {
  return solve_iteration(tbl, imp, g, oimp, oupd, Rp, with_sr, stream);
}

int edyn_restitution_iteration_f64(const double* tbl, const double* dyn,
                                   const double* imp, const double* g,
                                   double* oimp, double* oupd, int Rp,
                                   void* stream) {
  return restitution_iteration(tbl, dyn, imp, g, oimp, oupd, Rp, stream);
}

int edyn_relvel_f64(const double* tbl, const double* g, double* out, int Rp,
                    void* stream) {
  return relvel(tbl, g, out, Rp, stream);
}

int edyn_ngs_iteration_f64(const double* tbl, const double* g, double* oupd,
                           double* oerr, int Rp, double rate,
                           double max_corr, void* stream) {
  return ngs_iteration(tbl, g, oupd, oerr, Rp, rate, max_corr, stream);
}

}  // extern "C"
