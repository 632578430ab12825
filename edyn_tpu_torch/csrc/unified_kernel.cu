// The UNIFIED convex-convex narrowphase bucket as one kernel for Hopper
// (sm_90a), with a plain C interface for ctypes
// (edyn_tpu_torch/collision/kernels/unified_kernel.py).
//
// Replaces the Pallas TPU kernel collide_support_pallas
// (edyn_tpu/collision/kernels/pallas_unified.py, body _make_kernel). Per
// pair: SAT over the face, centre-delta and cylinder-side axes of both
// sides, the E x E edge crosses and the 2 rim axes, with disc-swept
// supports; a tangent basis aligned to line features; 5 tilted support
// samples per side; the feature-slab reject/clamp; reduce to <= 4 points.
//
// Layout: the side table is the component-major [C, N] table of
// pack_side_table_t (C = 12 + 4V + 4F + 4E rows). The Pallas kernel could
// not gather, so XLA gathered [C, K] columns for it; here each thread reads
// its two bodies' columns from the table itself (the table, ~3.4 MB at 10k
// bodies, stays in L2), which saves writing and reading the two gathered
// [C, K] copies. Output [48, K]: row 12p + f is field f of point p, so the
// stores of a warp are coalesced and the wrapper's [K, 4, 12] is a view.
//
// Bound: operations. Per pair the SAT projects up to 50 axes on 2 x 8
// vertices, and the tilt, line-feature and slab passes project the
// vertices again (~6,000 float operations for a box pair of mixed_pile),
// against ~400 bytes of table, indices and output. Design: one thread per
// pair; the axes are streamed through a running first-index argmax, never
// materialised; world vertices, B's world edges, the 10 tilt candidates
// and reduce-to-4 stay in registers (arrays bounded by the compile-time
// caps VM, EM and fully unrolled; faces are read as they are streamed). No
// shared memory: nothing is shared between pairs.
//
// Parity: the arithmetic follows collide_support_plain operation by
// operation (three-component sums as (a0*b0 + a1*b1) + a2*b2, vertex sums in
// vertex order, first index among equal maxima), and the library is built
// with -fmad=false and without fast math, so both round alike.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// caps of the per-pair register arrays: vertices and edge directions per
// shape (unified_kernel.CAPS); every convex shape of the JAX package's
// scenes and tests fits (box V 8, tetrahedron E 6, octahedron E 6)
constexpr int VMAX = 8, EMAX = 8;
constexpr float BIG = 1e30f;
constexpr float EPS = 1e-12f;
constexpr float TILT = 0.02f;

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 mk(float x, float y, float z) {
  F3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ float dot(F3 a, F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ F3 cross(F3 a, F3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ F3 scale(F3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ F3 add(F3 a, F3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ F3 sub(F3 a, F3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ F3 neg(F3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ F3 sel(bool c, F3 a, F3 b) { return c ? a : b; }
__device__ __forceinline__ float sq(float x) { return x * x; }
__device__ __forceinline__ float maxf(float a, float b) {
  return a > b ? a : b;
}
__device__ __forceinline__ float minf(float a, float b) {
  return a < b ? a : b;
}
__device__ __forceinline__ float length(F3 a) {
  return sqrtf(maxf(dot(a, a), 0.0f));
}
__device__ __forceinline__ F3 normalize_or(F3 a, F3 fb) {
  const float l2 = dot(a, a);
  const float inv = 1.0f / sqrtf(maxf(l2, 1e-9f));
  return l2 > 1e-9f ? scale(a, inv) : fb;
}
__device__ __forceinline__ F3 normalize(F3 a) {
  const float l2 = dot(a, a);
  const float inv = l2 > 1e-9f ? 1.0f / sqrtf(maxf(l2, 1e-9f)) : 0.0f;
  return scale(a, inv);
}
// q = (x, y, z, w): v + 2w (qv x v) + qv x (2 qv x v)
__device__ __forceinline__ F3 qrotate(const float q[4], F3 v) {
  const F3 qv = mk(q[0], q[1], q[2]);
  const F3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q[3])), cross(qv, t));
}
__device__ __forceinline__ F3 qrotate_inv(const float q[4], F3 v) {
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  return qrotate(qc, v);
}
__device__ __forceinline__ void ortho_basis(F3 n, F3& t1, F3& t2) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  t1 = mk(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x);
  t2 = mk(b, sign + n.y * n.y * a, -n.y);
}

// One side of a pair: transform, radius, disc, world vertices.
template <int VM>
struct Side {
  F3 pos;
  float orn[4];
  float radius, disc_r;
  F3 w;          // world disc axis
  F3 vw[VM];     // world vertices
  bool vm[VM];   // vertex mask
};

// Column j of the [C, N] table.
struct Col {
  const float* __restrict__ t;
  long long n, j;
  __device__ __forceinline__ float operator()(int r) const {
    return __ldg(t + r * n + j);
  }
};

template <int VM>
__device__ __forceinline__ void load_side(const Col& c, int V, Side<VM>& S) {
  S.pos = mk(c(0), c(1), c(2));
#pragma unroll
  for (int i = 0; i < 4; ++i) S.orn[i] = c(3 + i);
  S.radius = c(7);
  S.disc_r = c(8);
  S.w = qrotate(S.orn, mk(c(9), c(10), c(11)));
  const int o = 12;
#pragma unroll
  for (int v = 0; v < VM; ++v) {
    if (v < V) {
      const F3 ov = mk(c(o + v), c(o + V + v), c(o + 2 * V + v));
      S.vw[v] = add(qrotate(S.orn, ov), S.pos);
      S.vm[v] = c(o + 3 * V + v) > 0.5f;
    } else {
      S.vw[v] = mk(0.0f, 0.0f, 0.0f);
      S.vm[v] = false;
    }
  }
}

// masked projection of vertex v on d
template <int VM>
__device__ __forceinline__ float vproj(const Side<VM>& S, int v, F3 d) {
  return S.vm[v] ? dot(d, S.vw[v]) : -BIG;
}

template <int VM>
__device__ __forceinline__ float max_proj(const Side<VM>& S, int V, F3 d) {
  float m = vproj(S, 0, d);
#pragma unroll
  for (int v = 1; v < VM; ++v)
    if (v < V) m = maxf(m, vproj(S, v, d));
  return m;
}

// first vertex of largest masked projection
template <int VM>
__device__ __forceinline__ int argmax_vert(const Side<VM>& S, int V, F3 d) {
  float m = vproj(S, 0, d);
  int best = 0;
#pragma unroll
  for (int v = 1; v < VM; ++v) {
    if (v < V) {
      const float p = vproj(S, v, d);
      if (p > m) {
        m = p;
        best = v;
      }
    }
  }
  return best;
}

template <int VM>
__device__ __forceinline__ F3 vert(const Side<VM>& S, int i) {
  F3 r = S.vw[0];
#pragma unroll
  for (int v = 1; v < VM; ++v)
    if (v == i) r = S.vw[v];
  return r;
}

template <int VM>
__device__ __forceinline__ float support_projection(const Side<VM>& S, int V,
                                                    F3 d) {
  const float base = max_proj(S, V, d);
  const float dw = dot(d, S.w);
  const float perp2 = maxf(dot(d, d) - dw * dw, 0.0f);
  return base + S.radius + S.disc_r * sqrtf(perp2);
}

template <int VM>
__device__ __forceinline__ F3 support_point(const Side<VM>& S, int V, F3 d) {
  const F3 base = vert(S, argmax_vert(S, V, d));
  const float dw = dot(d, S.w);
  const F3 perp = sub(d, scale(S.w, dw));
  const float plen = length(perp);
  const F3 disc = scale(perp, S.disc_r / maxf(plen, EPS));
  return add(add(base, scale(d, S.radius)), disc);
}

__device__ __forceinline__ F3 closest_on_circle(F3 c, F3 w, float r, F3 x) {
  const F3 u = sub(x, c);
  const F3 perp = sub(u, scale(w, dot(u, w)));
  F3 t1, t2;
  ortho_basis(w, t1, t2);
  return add(c, scale(normalize_or(perp, t1), r));
}

__device__ __forceinline__ F3 closest_on_segment(F3 q0, F3 q1, F3 x) {
  const F3 d = sub(q1, q0);
  const float dd = dot(d, d);
  const float t =
      minf(maxf(dot(sub(x, q0), d) / maxf(dd, EPS), 0.0f), 1.0f);
  return add(q0, scale(d, t));
}

// rim candidate axis of side C against side D (pallas_unified._rim_axes)
template <int VM>
__device__ __forceinline__ F3 rim_axis(const Side<VM>& C, const Side<VM>& D, int V, F3 seed,
                       bool& ok) {
  const F3 cC = vert(C, argmax_vert(C, V, neg(seed)));
  const float rC = C.disc_r;
  const bool d_is_disc = D.disc_r > 1e-9f;
  const F3 cD = vert(D, argmax_vert(D, V, seed));
  // the two highest-projection vertices of D along seed
  const int i0 = argmax_vert(D, V, seed);
  float m2 = i0 == 0 ? -BIG : vproj(D, 0, seed);
  int i1 = 0;
#pragma unroll
  for (int v = 1; v < VM; ++v) {
    if (v < V) {
      const float p = v == i0 ? -BIG : vproj(D, v, seed);
      if (p > m2) {
        m2 = p;
        i1 = v;
      }
    }
  }
  const F3 q0 = vert(D, i0);
  const F3 q1 = m2 > -1e29f ? vert(D, i1) : q0;

  F3 p = closest_on_circle(cC, C.w, rC, cD);
  F3 q = p;
  for (int it = 0; it < 8; ++it) {
    q = d_is_disc ? closest_on_circle(cD, D.w, D.disc_r, p)
                  : closest_on_segment(q0, q1, p);
    p = closest_on_circle(cC, C.w, rC, q);
  }
  const F3 ax = sub(p, q);
  ok = (C.disc_r > 1e-9f) && (length(ax) > 1e-7f);
  return normalize_or(ax, seed);
}

// direction of the supporting feature along d when it is a line (2 verts)
template <int VM>
__device__ __forceinline__ F3 line_feature_dir(const Side<VM>& S, int V, F3 d,
                                               bool& line) {
  const float thr = max_proj(S, V, d) - 1e-3f;
  bool feat[VM];
#pragma unroll
  for (int v = 0; v < VM; ++v)
    feat[v] = v < V && vproj(S, v, d) >= thr && S.vm[v];
  float cnt = feat[0] ? 1.0f : 0.0f;
  F3 acc = scale(S.vw[0], cnt);
#pragma unroll
  for (int v = 1; v < VM; ++v) {
    if (v < V) {
      const float f = feat[v] ? 1.0f : 0.0f;
      cnt = cnt + f;
      acc = add(acc, scale(S.vw[v], f));
    }
  }
  const float div = maxf(cnt, 1.0f);
  const F3 cen = mk(acc.x / div, acc.y / div, acc.z / div);
  F3 best = feat[0] ? sub(S.vw[0], cen) : mk(0.0f, 0.0f, 0.0f);
  float bd = dot(best, best);
#pragma unroll
  for (int v = 1; v < VM; ++v) {
    if (v < V) {
      const F3 df = feat[v] ? sub(S.vw[v], cen) : mk(0.0f, 0.0f, 0.0f);
      const float d2 = dot(df, df);
      if (d2 > bd) {
        bd = d2;
        best = df;
      }
    }
  }
  line = cnt == 2.0f;
  return best;
}

template <int VM>
__device__ __forceinline__ bool flat_feature(const Side<VM>& S, int V, F3 d) {
  const float thr = max_proj(S, V, d) - 1e-3f;
  float cnt = vproj(S, 0, d) >= thr ? 1.0f : 0.0f;
#pragma unroll
  for (int v = 1; v < VM; ++v)
    if (v < V) cnt = cnt + (vproj(S, v, d) >= thr ? 1.0f : 0.0f);
  const bool cap = (S.disc_r > 1e-9f) && (fabsf(dot(d, S.w)) > 0.99f);
  return (S.radius < 1e-9f) && ((cnt >= 2.0f) || cap);
}

// extent [lo, hi] along t of the supporting feature along d
template <int VM>
__device__ __forceinline__ void feature_slab(const Side<VM>& S, int V, F3 d,
                                             F3 t, float& lo, float& hi) {
  const float thr = max_proj(S, V, d) - 1e-3f;
  lo = BIG;
  hi = -BIG;
#pragma unroll
  for (int v = 0; v < VM; ++v) {
    if (v < V) {
      const bool feat = vproj(S, v, d) >= thr;
      const float vt = dot(t, S.vw[v]);
      lo = minf(lo, feat ? vt : BIG);
      hi = maxf(hi, feat ? vt : -BIG);
    }
  }
  const float off = S.radius * dot(d, t);
  const float dw = dot(d, S.w);
  const F3 perp = sub(d, scale(S.w, dw));
  const float plen = length(perp);
  const bool cap = fabsf(dw) > 0.99f;
  const F3 tw = sub(t, scale(S.w, dot(t, S.w)));
  const float disc_span = S.disc_r * length(tw);
  const float rim_off = S.disc_r * dot(perp, t) / maxf(plen, EPS);
  lo = lo + off + (cap ? -disc_span : rim_off);
  hi = hi + off + (cap ? disc_span : rim_off);
}

// Running first-index argmax over the candidate axes.
struct Best {
  bool any;
  float sep, plane_a, plane_b;
  F3 n;
};

template <int VM>
__device__ __forceinline__ void consider(const Side<VM>& A,
                                         const Side<VM>& B, int V, F3 delta,
                                         F3 axis, bool mask, Best& b) {
  const float sgn = dot(axis, delta) >= 0.0f ? 1.0f : -1.0f;
  axis = scale(axis, sgn);
  const float pa = -support_projection(A, V, neg(axis));
  const float pb = support_projection(B, V, axis);
  const float sep = mask ? pa - pb : -BIG;
  if (!b.any || sep > b.sep) {
    b.any = true;
    b.sep = sep;
    b.n = axis;
    b.plane_a = pa;
    b.plane_b = pb;
  }
}

template <int VM, int EM>
__global__ void __launch_bounds__(THREADS)
    unified_kernel(const float* __restrict__ tbl, long long N,
                   const long long* __restrict__ ka,
                   const long long* __restrict__ kb, int K, int V, int F,
                   int E, float threshold, int rim, float* __restrict__ out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const Col ca{tbl, N, ka[k]};
  const Col cb{tbl, N, kb[k]};
  Side<VM> A, B;
  load_side(ca, V, A);
  load_side(cb, V, B);
  const int of = 12 + 4 * V;          // face rows
  const int oe = of + 4 * F;          // edge rows

  const F3 delta = sub(A.pos, B.pos);
  const F3 ydef = mk(0.0f, 1.0f, 0.0f);
  const F3 seed = normalize_or(delta, ydef);

  // --- SAT over the streamed candidate axes, in the TPU kernel's order ---
  Best best;
  best.any = false;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const Side<VM>& S = s == 0 ? A : B;
    const Col& c = s == 0 ? ca : cb;
    const F3 other = s == 0 ? B.pos : A.pos;
    for (int f = 0; f < F; ++f) {
      const F3 fw = qrotate(S.orn, mk(c(of + f), c(of + F + f),
                                      c(of + 2 * F + f)));
      consider(A, B, V, delta, fw, c(of + 3 * F + f) > 0.5f, best);
    }
    const F3 d = sub(other, S.pos);
    consider(A, B, V, delta, normalize_or(d, ydef), true, best);
    const F3 perp = sub(d, scale(S.w, dot(d, S.w)));
    const float plen = length(perp);
    const F3 side_n = scale(perp, 1.0f / maxf(plen, EPS));
    consider(A, B, V, delta, side_n, (S.disc_r > 1e-9f) && (plen > 1e-9f),
             best);
  }
  F3 ewB[EM];
  bool emB[EM];
#pragma unroll
  for (int j = 0; j < EM; ++j) {
    if (j < E) {
      ewB[j] = qrotate(B.orn, mk(cb(oe + j), cb(oe + E + j),
                                 cb(oe + 2 * E + j)));
      emB[j] = cb(oe + 3 * E + j) > 0.5f;
    } else {
      ewB[j] = mk(0.0f, 0.0f, 0.0f);
      emB[j] = false;
    }
  }
  for (int i = 0; i < E; ++i) {
    const F3 ea = qrotate(A.orn, mk(ca(oe + i), ca(oe + E + i),
                                    ca(oe + 2 * E + i)));
    const bool ema = ca(oe + 3 * E + i) > 0.5f;
#pragma unroll
    for (int j = 0; j < EM; ++j) {
      if (j < E) {
        F3 cr = cross(ea, ewB[j]);
        const float crl = length(cr);
        cr = scale(cr, 1.0f / maxf(crl, EPS));
        consider(A, B, V, delta, cr, ema && emB[j] && (crl > 1e-6f), best);
      }
    }
  }
  if (rim) {
    bool ok_a, ok_b;
    const F3 ra = rim_axis(A, B, V, seed, ok_a);
    const F3 rb = rim_axis(B, A, V, seed, ok_b);
    consider(A, B, V, delta, ra, ok_a, best);
    consider(A, B, V, delta, rb, ok_b, best);
  }
  const F3 n = best.n;
  const float best_sep = best.sep;
  const float plane_a = best.plane_a;
  const float plane_b = best.plane_b;

  // --- tangent basis aligned to line features ---
  const F3 nn = neg(n);
  bool lineA, lineB;
  const F3 eA = line_feature_dir(A, V, nn, lineA);
  const F3 eB = line_feature_dir(B, V, n, lineB);
  const F3 e = sel(lineB, eB, eA);
  const F3 e_t = sub(e, scale(n, dot(e, n)));
  const bool use_line = (lineA || lineB) && (length(e_t) > 1e-6f);
  F3 t1d, t2d;
  ortho_basis(n, t1d, t2d);
  const F3 e_tn = normalize_or(e_t, t1d);
  const F3 t1 = sel(use_line, e_tn, t1d);
  const F3 t2 = sel(use_line, cross(n, t1), t2d);

  // --- patch sampling: 5 tilted directions per side -> 10 candidates ---
  F3 on_a[10], on_b[10];
  float depth[10];
  bool valid[10];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    F3 tilt = mk(0.0f, 0.0f, 0.0f);
    float sg = 0.0f;
    if (i == 1 || i == 2) tilt = t1;
    if (i == 3 || i == 4) tilt = t2;
    sg = (i == 1 || i == 3) ? 1.0f : -1.0f;
    F3 da = nn, db = n;
    if (i > 0) {
      const F3 tt = scale(tilt, TILT);
      da = sg > 0.0f ? add(nn, tt) : sub(nn, tt);
      db = sg > 0.0f ? add(n, tt) : sub(n, tt);
    }
    const F3 pa = support_point(A, V, normalize(da));
    const F3 pb = support_point(B, V, normalize(db));
    const float dep_a = dot(pa, n) - plane_b;
    const float dep_b = plane_a - dot(pb, n);
    on_a[i] = pa;
    on_b[i] = sub(pa, scale(n, dep_a));
    depth[i] = dep_a;
    on_a[5 + i] = add(pb, scale(n, dep_b));
    on_b[5 + i] = pb;
    depth[5 + i] = dep_b;
  }
#pragma unroll
  for (int i = 0; i < 10; ++i)
    valid[i] = (depth[i] < threshold) && (best_sep < threshold);

  // --- feature-slab containment / clamp ---
  const bool both_flat = flat_feature(A, V, nn) && flat_feature(B, V, n);
  F3 shift[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) shift[i] = mk(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const F3 t = r == 0 ? t1 : t2;
    float lo_a, hi_a, lo_b, hi_b;
    feature_slab(A, V, nn, t, lo_a, hi_a);
    feature_slab(B, V, n, t, lo_b, hi_b);
    const float lo = maxf(lo_a, lo_b);
    const float hi = maxf(minf(hi_a, hi_b), lo);
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float proj = dot(on_a[i], t);
      const bool inside = (proj >= lo - 5e-3f) && (proj <= hi + 5e-3f);
      valid[i] = valid[i] && (inside || both_flat);
      const float clipped = minf(maxf(proj, lo), hi);
      const float dmove = both_flat ? clipped - proj : 0.0f;
      shift[i] = add(shift[i], scale(t, dmove));
    }
  }
  float sel_depth[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    on_a[i] = add(on_a[i], shift[i]);
    on_b[i] = add(on_b[i], shift[i]);
    const F3 s = shift[i];
    const bool shifted = (s.x * s.x + s.y * s.y + s.z * s.z) > EPS;
    sel_depth[i] = depth[i] + (shifted ? 1e-5f : 0.0f);
  }

  // --- reduce to <= 4 (insertion heuristic) ---
  int i0 = 0;
  float m0 = valid[0] ? sel_depth[0] : BIG;
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    const float d0 = valid[i] ? sel_depth[i] : BIG;
    if (d0 < m0) {
      m0 = d0;
      i0 = i;
    }
  }
  F3 p0 = on_a[0];
#pragma unroll
  for (int i = 1; i < 10; ++i)
    if (i == i0) p0 = on_a[i];
  const bool v0 = m0 < BIG * 0.5f;
  unsigned taken = 1u << i0;

  float dist0[10];
#pragma unroll
  for (int i = 0; i < 10; ++i)
    dist0[i] = sq(on_a[i].x - p0.x) + sq(on_a[i].y - p0.y) +
               sq(on_a[i].z - p0.z);
  int i1 = 0;
  float m1 = -BIG;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float c1 = (valid[i] && !((taken >> i) & 1u)) ? dist0[i] : -BIG;
    if (i == 0 || c1 > m1) {
      m1 = c1;
      i1 = i;
    }
  }
  F3 p1 = on_a[0];
#pragma unroll
  for (int i = 1; i < 10; ++i)
    if (i == i1) p1 = on_a[i];
  const bool v1 = v0 && (m1 > 0.0f);
  taken |= 1u << i1;

  const F3 e01 = sub(p1, p0);
  int i2 = 0;
  float m2 = -BIG;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const F3 crs = cross(sub(on_a[i], p0), e01);
    const float area = dot(crs, crs);
    const float c2 = (valid[i] && !((taken >> i) & 1u)) ? area : -BIG;
    if (i == 0 || c2 > m2) {
      m2 = c2;
      i2 = i;
    }
  }
  F3 p2 = on_a[0];
#pragma unroll
  for (int i = 1; i < 10; ++i)
    if (i == i2) p2 = on_a[i];
  const bool v2 = v1 && (m2 > EPS);
  taken |= 1u << i2;

  int i3 = 0;
  float m3 = -BIG;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const F3 a = on_a[i];
    const float d_all = dist0[i] + sq(a.x - p1.x) + sq(a.y - p1.y) +
                        sq(a.z - p1.z) + sq(a.x - p2.x) + sq(a.y - p2.y) +
                        sq(a.z - p2.z);
    const float c3 = (valid[i] && !((taken >> i) & 1u)) ? d_all : -BIG;
    if (i == 0 || c3 > m3) {
      m3 = c3;
      i3 = i;
    }
  }
  const bool v3 = v2 && (m3 > 0.0f);

  // --- output: per point 12 rows of [48, K] ---
  const int pick[4] = {i0, i1, i2, i3};
  const bool pv[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    F3 pa_w = on_a[0], pb_w = on_b[0];
    float dd = depth[0];
#pragma unroll
    for (int i = 1; i < 10; ++i) {
      if (i == pick[p]) {
        pa_w = on_a[i];
        pb_w = on_b[i];
        dd = depth[i];
      }
    }
    const bool vv = pv[p] && (dd < threshold);
    const F3 piv_a = qrotate_inv(A.orn, sub(pa_w, A.pos));
    const F3 piv_b = qrotate_inv(B.orn, sub(pb_w, B.pos));
    const float row[12] = {piv_a.x, piv_a.y, piv_a.z, piv_b.x, piv_b.y,
                           piv_b.z, n.x,     n.y,     n.z,     0.0f,
                           dd,      vv ? 1.0f : 0.0f};
#pragma unroll
    for (int f = 0; f < 12; ++f)
      out[(long long)(12 * p + f) * K + k] = row[f];
  }
}

}  // namespace

// tbl [C, N] float32 side table; ka, kb [K] int64 body indices; out [48, K].
// V <= VMAX and E <= EMAX (the caller checks); faces are streamed from the
// table and need no cap.
extern "C" int edyn_collide_support(const float* tbl, int N,
                                    const long long* ka, const long long* kb,
                                    int K, int V, int F, int E,
                                    float threshold, int rim, float* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V > VMAX || E > EMAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (K + THREADS - 1) / THREADS;
  unified_kernel<VMAX, EMAX><<<blocks, THREADS, 0, s>>>(
      tbl, N, ka, kb, K, V, F, E, threshold, rim, out);
  return static_cast<int>(cudaGetLastError());
}
