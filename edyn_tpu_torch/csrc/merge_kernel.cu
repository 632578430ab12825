// The narrowphase's manifold merge for Hopper (sm_90a), with a plain C
// interface for ctypes (edyn_tpu_torch/collision/kernels/merge_kernel.py).
//
// edyn_merge is merge_fresh_plain (narrowphase's merge_fresh on the CPU:
// manifold.merge_points behind the local normals, the pair poses and the
// frozen-pair rule) as one launch over the M manifold slots. It replaces no
// TPU kernel: the JAX package keeps the merge in XLA. The plain version is
// ~1,850 PyTorch kernels over [M,4,4] and [M,4,4,3] temporaries; here no
// temporary leaves the registers.
//
// Layout: four lanes a slot, lane o owning carried point o and fresh point
// o, so every [M,4,k] field is read and written by a warp as 8 slots'
// contiguous rows. What a lane needs of its slot's other points comes by
// __shfl_sync within the 4-lane group (width 4); the min/argmin and
// argmax over the 4 points are butterflies of (value, index) pairs. Each
// lane gathers its slot's two bodies by index (L2 hits). Every lane takes
// part in every shuffle: lanes past M work on slot M-1 and store nothing.
//
// Parity: every operation rounds as the plain version's op on the card:
// -fmad=false; each torch.sum over a last dimension of 3 adds as PyTorch's
// reduction kernel does at that width (tsum3); a division by a Python
// scalar is a multiply by its reciprocal (PyTorch's div by a CPU scalar);
// torch.linalg.vector_norm over 4 in its order (chip_smoke.sum_orders
// reads both orders off the card); ties of min, argmin
// and max go to the lower index with a NaN first; sinf/cosf/sqrtf with no
// fast math.
//
// Bound: memory. A slot reads its table fields and its fresh points and
// writes a new table (about 880 bytes a slot at float32); the body gathers
// hit L2.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "unified_math.cuh"

namespace {

using unified::V3;
using unified::add;
using unified::cross;
using unified::mk;
using unified::qrotate;
using unified::qrotate_inv;
using unified::sqrt_;
using unified::sub;

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FRESH = 14;  // fresh_points' row: see merge_kernel.py
constexpr int GEOM = 13;   // pivot_a 0:3 | pivot_b 3:6 | local_normal 6:9 |
                           // attachment 9 | distance 10 | friction_scale 11
                           // | restitution_scale 12 (merge_points' geom)

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float fmin_(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double fmin_(double a, double b) {
  return fmin(a, b);
}

template <typename T>
__device__ __forceinline__ T inf_() {
  return T(1) / T(0);
}
template <typename T>
__device__ __forceinline__ bool finite_(T x) {
  return isfinite(x);
}

// torch.sum over a contiguous last dimension of 3 on the card: two threads
// a row, one adding elements 0 and 2 (each to zero first), the other's
// element 1 added last.
template <typename T>
__device__ __forceinline__ T tsum3(T x0, T x1, T x2) {
  return ((T(0) + x0) + (T(0) + x2)) + (T(0) + x1);
}
template <typename T>
__device__ __forceinline__ T sqdist(V3<T> a, V3<T> b) {
  const V3<T> d = sub(a, b);
  return tsum3(d.x * d.x, d.y * d.y, d.z * d.z);
}
template <typename T>
__device__ __forceinline__ T length_sqr(V3<T> a) {
  return tsum3(a.x * a.x, a.y * a.y, a.z * a.z);
}
// torch.minimum: a NaN of either side, else fmin
template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  return a != a ? a : (b != b ? b : fmin_(a, b));
}
// torch.clamp(x, min=lo) with lo > 0
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// the order of torch.min/argmin (less) and torch.max/argmax (greater) on
// the card: a NaN first, then the value, ties to the lower index
template <bool GREATER, typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (a != a) return (b != b) ? ia < ib : true;
  if (b != b) return false;
  if (a == b) return ia < ib;
  return GREATER ? a > b : a < b;
}
// (value, index) of the 4-lane group's first in that order, in every lane
template <bool GREATER, typename T>
__device__ __forceinline__ void group_select(T& v, int& i) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const T ov = __shfl_xor_sync(FULL, v, off, 4);
    const int oi = __shfl_xor_sync(FULL, i, off, 4);
    if (before<GREATER>(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}
template <typename T>
__device__ __forceinline__ T from(int lane, T v) {
  return __shfl_sync(FULL, v, lane, 4);
}
template <typename T>
__device__ __forceinline__ V3<T> from(int lane, V3<T> v) {
  return mk(from(lane, v.x), from(lane, v.y), from(lane, v.z));
}

// manifold._manifold_score: the patch-area proxy of 4 points
template <typename T>
__device__ __forceinline__ T score(V3<T> p0, V3<T> p1, V3<T> p2, V3<T> p3) {
  const T c0 = length_sqr(cross(sub(p0, p1), sub(p0, p2)));
  const T c1 = length_sqr(cross(sub(p0, p2), sub(p0, p3)));
  const T c2 = length_sqr(cross(sub(p0, p3), sub(p0, p1)));
  const T c3 = length_sqr(cross(sub(p1, p2), sub(p2, p3)));
  return ((c0 + c1) + c2) + c3;
}

// math/quat.integrate(q, w, dt) in its op order; half_dt is 0.5 * dt
// computed in double, as Python computes it
template <typename T>
__device__ void integrate(const T q[4], V3<T> w, T dt, T half_dt, T out[4]) {
  const T theta_sq = (length_sqr(w) * dt) * dt;
  const T theta = sqrt_(clamp_min(theta_sq, T(1e-30)));
  const T half = theta * T(0.5);
  const bool small = theta_sq < T(1e-8);
  const T s = small ? half_dt - (theta_sq * dt) * (T(1) / T(48))
                    : (sin_(half) / clamp_min(theta, T(1e-30))) * dt;
  const T c = small ? T(1) - theta_sq * T(0.125) : cos_(half);
  const T p[4] = {w.x * s, w.y * s, w.z * s, c};
  T m[4];
  m[0] = ((p[3] * q[0] + p[0] * q[3]) + p[1] * q[2]) - p[2] * q[1];
  m[1] = ((p[3] * q[1] - p[0] * q[2]) + p[1] * q[3]) + p[2] * q[0];
  m[2] = ((p[3] * q[2] + p[0] * q[1]) - p[1] * q[0]) + p[2] * q[3];
  m[3] = ((p[3] * q[3] - p[0] * q[0]) - p[1] * q[1]) - p[2] * q[2];
  // torch.linalg.vector_norm over 4 on the card: two threads a row, one
  // adding the squares of elements 0 and 2, the other 1 and 3
  const T n = clamp_min(
      sqrt_((m[0] * m[0] + m[2] * m[2]) + (m[1] * m[1] + m[3] * m[3])),
      T(1e-12));
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = m[k] / n;
}

template <typename T>
struct Args {
  // per body [N, ...]
  const T* pos;
  const T* orn;
  const T* angvel;
  const T* com;
  const int* shape_type;
  const int* kind;
  const bool* body_valid;
  // per slot [M]
  const int* body_a;
  const int* body_b;
  const bool* valid;
  const bool* frozen;
  // per carried point [M, 4, ...]
  const bool* point_valid;
  const T* pivot_a;
  const T* pivot_b;
  const T* local_normal;
  const int* attachment;
  const T* distance;
  const int* lifetime;
  const T* normal_impulse;
  const T* friction_impulse;
  const T* spin_impulse;
  const T* roll_impulse;
  const T* friction_scale;
  const T* restitution_scale;
  const T* fresh;  // [M, 4, FRESH]
  // the merged table, the same layout
  bool* o_point_valid;
  T* o_pivot_a;
  T* o_pivot_b;
  T* o_local_normal;
  int* o_attachment;
  T* o_distance;
  int* o_lifetime;
  T* o_normal_impulse;
  T* o_friction_impulse;
  T* o_spin_impulse;
  T* o_roll_impulse;
  T* o_friction_scale;
  T* o_restitution_scale;
};
constexpr int N_IN = 25;
constexpr int N_OUT = 13;

template <typename T>
struct Consts {
  T ndt, half_ndt;  // -dt and 0.5 * -dt: the back-rotation's integrate
  T cache2, merge2, brk, brk2;
  int roll_types;  // bit t set: shape type t rolls
  int kind_dynamic;
};

template <typename T>
struct Body {
  T orn[4];
  V3<T> org, w;
  bool rolling;
};

template <typename T>
__device__ __forceinline__ V3<T> load3(const T* p) {
  return mk(p[0], p[1], p[2]);
}

// WorldState.origin_pos (pos - R com), the rolling tag and the pose of body i
template <typename T>
__device__ __forceinline__ Body<T> load_body(const Args<T>& a, int i,
                                             const Consts<T>& c) {
  Body<T> b;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.orn[k] = a.orn[4 * i + k];
  b.org = sub(load3(a.pos + 3 * i), qrotate(b.orn, load3(a.com + 3 * i)));
  b.w = load3(a.angvel + 3 * i);
  const int st = a.shape_type[i];
  b.rolling = st >= 0 && st < 32 && ((c.roll_types >> st) & 1) &&
              a.kind[i] == c.kind_dynamic && a.body_valid[i];
  return b;
}

// a frozen pair's point p, verbatim
template <typename T>
__device__ __forceinline__ void keep_point(const Args<T>& a, long long p) {
  a.o_point_valid[p] = a.point_valid[p];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.o_pivot_a[3 * p + k] = a.pivot_a[3 * p + k];
    a.o_pivot_b[3 * p + k] = a.pivot_b[3 * p + k];
    a.o_local_normal[3 * p + k] = a.local_normal[3 * p + k];
  }
  a.o_attachment[p] = a.attachment[p];
  a.o_distance[p] = a.distance[p];
  a.o_lifetime[p] = a.lifetime[p];
  a.o_normal_impulse[p] = a.normal_impulse[p];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    a.o_friction_impulse[2 * p + k] = a.friction_impulse[2 * p + k];
    a.o_roll_impulse[2 * p + k] = a.roll_impulse[2 * p + k];
  }
  a.o_spin_impulse[p] = a.spin_impulse[p];
  a.o_friction_scale[p] = a.friction_scale[p];
  a.o_restitution_scale[p] = a.restitution_scale[p];
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    merge_kernel(const Args<T> a, int M, const Consts<T> c) {
  const long long t = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = (t >> 2) < M;
  const long long m = live ? (t >> 2) : (long long)M - 1;
  const int o = (int)(t & 3);
  const long long p = 4 * m + o;  // carried point o, fresh point o
  const T inf = inf_<T>();

  const bool mvalid = a.valid[m];
  const bool fr = a.frozen[m] && mvalid;
  // a warp of frozen slots keeps every field verbatim
  if (__all_sync(FULL, fr || !live)) {
    if (!live) return;
    keep_point(a, p);
    return;
  }

  const Body<T> A = load_body(a, a.body_a[m], c);
  const Body<T> B = load_body(a, a.body_b[m], c);

  // carried point o
  const bool ov = a.point_valid[p];
  T g[GEOM];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g[k] = a.pivot_a[3 * p + k];
    g[3 + k] = a.pivot_b[3 * p + k];
    g[6 + k] = a.local_normal[3 * p + k];
  }
  g[9] = T(a.attachment[p]);
  g[10] = a.distance[p];
  g[11] = a.friction_scale[p];
  g[12] = a.restitution_scale[p];
  T imp[6] = {a.normal_impulse[p],     a.friction_impulse[2 * p],
              a.friction_impulse[2 * p + 1], a.spin_impulse[p],
              a.roll_impulse[2 * p],   a.roll_impulse[2 * p + 1]};
  int life = a.lifetime[p];

  // fresh point o, its normal in the frame it is attached to
  const T* f = a.fresh + FRESH * p;
  T nf[GEOM];
#pragma unroll
  for (int k = 0; k < 6; ++k) nf[k] = f[k];
  const int natt = (int)f[9];
  const V3<T> nrm = load3(f + 6);
  const V3<T> ln = natt == 1   ? qrotate_inv(A.orn, nrm)
                   : natt == 2 ? qrotate_inv(B.orn, nrm)
                               : nrm;
  nf[6] = ln.x;
  nf[7] = ln.y;
  nf[8] = ln.z;
  nf[9] = T(natt);
  nf[10] = f[10];
  nf[11] = f[12];
  nf[12] = f[13];
  const bool nv = f[11] > T(0.5) && mvalid;

  // back-rotated world pivots of the carried point, world pivots of the
  // fresh one (a body that does not roll matches nothing this way)
  const V3<T> opa = mk(g[0], g[1], g[2]), opb = mk(g[3], g[4], g[5]);
  V3<T> pwa = opa, pwb = opb;
  if (A.rolling) {
    T q[4];
    integrate(A.orn, A.w, c.ndt, c.half_ndt, q);
    pwa = add(A.org, qrotate(q, opa));
  }
  if (B.rolling) {
    T q[4];
    integrate(B.orn, B.w, c.ndt, c.half_ndt, q);
    pwb = add(B.org, qrotate(q, opb));
  }
  const V3<T> nwa = add(A.org, qrotate(A.orn, mk(nf[0], nf[1], nf[2])));
  const V3<T> nwb = add(B.org, qrotate(B.orn, mk(nf[3], nf[4], nf[5])));

  // 1. nearest match, carried -> fresh: direct, else rolling
  T d2e[4], d2r[4];
  bool has_direct = false;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const V3<T> npa = from(n, mk(nf[0], nf[1], nf[2]));
    const V3<T> npb = from(n, mk(nf[3], nf[4], nf[5]));
    const V3<T> wa = from(n, nwa), wb = from(n, nwb);
    const int nv_n = from(n, (int)nv);  // every lane shuffles
    const bool pairable = ov && nv_n;
    const T d2 = minimum(sqdist(opa, npa), sqdist(opb, npb));
    d2e[n] = pairable && d2 < c.cache2 ? d2 : inf;
    has_direct |= finite_(d2e[n]);
    T dra = sqdist(pwa, wa), drb = sqdist(pwb, wb);
    dra = pairable && dra < c.cache2 && A.rolling ? dra : inf;
    drb = pairable && drb < c.cache2 && B.rolling ? drb : inf;
    d2r[n] = minimum(minimum(inf, dra), drb);
  }
  T nd2 = has_direct ? d2e[0] : d2r[0];
  int nn = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    d2e[n] = has_direct ? d2e[n] : d2r[n];
    if (n > 0 && before<false>(d2e[n], n, nd2, nn)) {
      nd2 = d2e[n];
      nn = n;
    }
  }
  const bool claims = finite_(nd2);

  // each fresh point keeps its closest claimant
  bool won[4];
  int w_at = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    T cost = claims && nn == n ? d2e[n] : inf;
    int wo = o;
    group_select<false>(cost, wo);
    won[n] = finite_(cost);
    if (nn == n) w_at = wo;
  }
  const bool matched = claims && w_at == o;

  // adopt the nearest fresh point's geometry (the plain version's one-hot
  // sum: a zero's sign becomes +)
#pragma unroll
  for (int k = 0; k < GEOM; ++k) {
    const T v = T(0) + from(nn, nf[k]);
    if (matched) g[k] = v;
  }

  // 2. keep or break the carried point
  bool valid;
  {
    const int att = (int)g[9];
    const V3<T> pA = add(A.org, qrotate(A.orn, mk(g[0], g[1], g[2])));
    const V3<T> pB = add(B.org, qrotate(B.orn, mk(g[3], g[4], g[5])));
    const V3<T> lnv = mk(g[6], g[7], g[8]);
    const V3<T> nw = att == 1   ? qrotate(A.orn, lnv)
                     : att == 2 ? qrotate(B.orn, lnv)
                                : lnv;
    const V3<T> d = sub(pA, pB);
    const T ndist = tsum3(d.x * nw.x, d.y * nw.y, d.z * nw.z);
    const V3<T> tv = sub(d, mk(ndist * nw.x, ndist * nw.y, ndist * nw.z));
    const T tang2 = length_sqr(tv);
    const bool breaking = ndist > c.brk || tang2 > c.brk2;
    valid = ov && (matched || !breaking);
    if (!matched) g[10] = ndist;
    life = valid ? life + 1 : 0;
    if (!valid) {
#pragma unroll
      for (int k = 0; k < 6; ++k) imp[k] = T(0);
    }
  }

  // 3. the fresh points no carried point took, in order: merge into a
  //    similar point, append into the first free slot, or replace the slot
  //    whose replacement scores the largest area, if larger than now
  const int base = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nv_j = from(j, (int)nv);
    const bool want = nv_j && !won[j];
    if (!__any_sync(FULL, want)) continue;
    T pj[GEOM];
#pragma unroll
    for (int k = 0; k < GEOM; ++k) pj[k] = from(j, nf[k]);
    const V3<T> pja = mk(pj[0], pj[1], pj[2]);
    const V3<T> mine = mk(g[0], g[1], g[2]);
    T ds = valid ? sqdist(mine, pja) : inf;
    int sim = o;
    group_select<false>(ds, sim);
    const bool sim_ok = want && ds < c.merge2;
    const unsigned inval =
        (__ballot_sync(FULL, !valid) >> base) & 0xFu;
    const bool has_free = inval != 0u;
    const int free_slot = has_free ? __ffs(inval) - 1 : 0;
    const bool app_ok = want && !sim_ok && has_free;
    const V3<T> P0 = from(0, mine), P1 = from(1, mine), P2 = from(2, mine),
                P3 = from(3, mine);
    const T cur = score(P0, P1, P2, P3);
    T best = score(o == 0 ? pja : P0, o == 1 ? pja : P1, o == 2 ? pja : P2,
                   o == 3 ? pja : P3);
    int rep = o;
    group_select<true>(best, rep);
    const bool rep_ok = want && !sim_ok && !has_free && best > cur;
    const int slot = sim_ok ? sim : (app_ok ? free_slot : rep);
    if ((sim_ok || app_ok || rep_ok) && slot == o) {
#pragma unroll
      for (int k = 0; k < GEOM; ++k) g[k] = pj[k];
      if (!sim_ok) {
#pragma unroll
        for (int k = 0; k < 6; ++k) imp[k] = T(0);
        life = 0;
      }
      valid = true;
    }
  }

  if (!live) return;
  if (fr) {
    keep_point(a, p);
    return;
  }
  a.o_point_valid[p] = valid && mvalid;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.o_pivot_a[3 * p + k] = g[k];
    a.o_pivot_b[3 * p + k] = g[3 + k];
    a.o_local_normal[3 * p + k] = g[6 + k];
  }
  a.o_attachment[p] = (int)g[9];
  a.o_distance[p] = g[10];
  a.o_lifetime[p] = life;
  a.o_normal_impulse[p] = imp[0];
  a.o_friction_impulse[2 * p] = imp[1];
  a.o_friction_impulse[2 * p + 1] = imp[2];
  a.o_spin_impulse[p] = imp[3];
  a.o_roll_impulse[2 * p] = imp[4];
  a.o_roll_impulse[2 * p + 1] = imp[5];
  a.o_friction_scale[p] = g[11];
  a.o_restitution_scale[p] = g[12];
}

template <typename T>
int merge(void* const* in, void* const* out, int M, double dt, double cache2,
          double merge2, double brk, int roll_types, int kind_dynamic,
          void* stream) {
  Args<T> a;
  const void** ip = reinterpret_cast<const void**>(&a);
  for (int i = 0; i < N_IN; ++i) ip[i] = in[i];
  void** op = reinterpret_cast<void**>(&a) + N_IN;
  for (int i = 0; i < N_OUT; ++i) op[i] = out[i];
  Consts<T> c;
  c.ndt = T(-dt);
  c.half_ndt = T(0.5 * -dt);
  c.cache2 = T(cache2);
  c.merge2 = T(merge2);
  c.brk = T(brk);
  c.brk2 = T(brk * brk);
  c.roll_types = roll_types;
  c.kind_dynamic = kind_dynamic;
  const long long threads = 4LL * M;
  const unsigned blocks = (unsigned)((threads + BLOCK - 1) / BLOCK);
  merge_kernel<T><<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      a, M, c);
  return static_cast<int>(cudaGetLastError());
}

static_assert(sizeof(Args<float>) == (N_IN + N_OUT) * sizeof(void*),
              "Args is the pointer arrays in order");
static_assert(sizeof(Args<double>) == (N_IN + N_OUT) * sizeof(void*),
              "Args is the pointer arrays in order");

}  // namespace

// in: N_IN device pointers in Args' order, out: N_OUT; M > 0 slots; dt the
// step's; cache2, merge2, brk the squared caching and merging thresholds
// and the breaking threshold; roll_types a bit per rolling shape type.
extern "C" int edyn_merge(void* const* in, void* const* out, int M, double dt,
                          double cache2, double merge2, double brk,
                          int roll_types, int kind_dynamic, void* stream) {
  return merge<float>(in, out, M, dt, cache2, merge2, brk, roll_types,
                      kind_dynamic, stream);
}

// the same at float64
extern "C" int edyn_merge_f64(void* const* in, void* const* out, int M,
                              double dt, double cache2, double merge2,
                              double brk, int roll_types, int kind_dynamic,
                              void* stream) {
  return merge<double>(in, out, M, dt, cache2, merge2, brk, roll_types,
                       kind_dynamic, stream);
}
