// The UNIFIED convex-convex narrowphase bucket (K4) for Hopper (sm_90a), with
// a plain C interface for ctypes (edyn_tpu_torch/collision/kernels/
// unified_kernel.py).
//
// Replaces the Pallas TPU kernel collide_support_pallas
// (edyn_tpu/collision/kernels/pallas_unified.py, body _make_kernel). Per
// pair: SAT over the face, centre-delta and cylinder-side axes of both
// sides, the edge crosses and the 2 rim axes, with disc-swept supports; a
// tangent basis aligned to line features; 5 tilted support samples per
// side; the feature-slab reject/clamp; reduce to <= 4 points.
//
// Three entry points, six kernels (the wrapper calls them in turn):
// 1. edyn_unified_features. features_kernel, one thread per body: rotates
//    the body's vertices, face normals, edge directions and disc axis into
//    world space ONCE, and writes them to a body-major table with 16-byte
//    rows (header: pos | radius, orn, world disc axis | disc_r, real counts
//    V F E | class code; then one float4 (x, y, z, mask) per vertex, face
//    and edge), the body's class code, and a flag for each code present. A
//    real count is the index of the last unmasked feature + 1, so every
//    feature beyond it is masked. class_ids_kernel (one block) numbers the
//    codes present in code order (the first MAX_SIDE - 1 apart, the rest
//    share the last number).
// 2. edyn_unified_pair_order, a stable counting sort of the pairs by class
//    (class number of A, then of B), so the pairs of one class (the same
//    real widths and disc flags on each side) share warps: pair_bins_kernel
//    (each pair's bin, and each warp chunk's count per bin),
//    bin_offsets_kernel (one block: the counts' exclusive scan, bin-major)
//    and pair_place_kernel (each chunk places its pairs in order).
// 3. edyn_collide_support. unified_kernel, one thread per pair, in class
//    order: it reads pair perm[k], loads the two rows as float4s, loops
//    over vertices, faces and edges only up to each side's real count,
//    solves a rim axis only for a side with a disc, and writes its 48
//    outputs to row perm[k] of [K, 48], which is then in table order.
//
// Bound: operations (~5,700 a pair of the landed mixed_pile, counted on
// the plain version with each side at its own real widths and without the
// world rotations; ~17,000 at the table's padded widths, rotations
// included) against ~240 bytes a pair of rows, indices and output. What
// the design does about it: no work on masked lanes (the
// first version ran every pair at the padded widths), no per-pair rotation
// of features, warps of one class (uniform loop bounds), and a register
// budget for 4 blocks of 128 threads per SM: the world vertices of both
// sides are held in registers during the SAT only; the later passes reload
// one side at a time from its row (in L1).
//
// Exactness: skipping a masked candidate changes no result. A masked axis
// has separation -BIG, and the running first-index argmax takes a later
// axis only when it is strictly larger; the centre-delta axis of A, never
// masked, comes before every skipped axis except A's masked faces, whose
// -BIG it beats. A masked vertex projects to -BIG and is never the first
// maximum; it adds 0 to the feature sums and BIG/-BIG to the slab min/max,
// which leave them as they are (the sums up to the sign of a zero, which no
// later division or comparison sees). The arithmetic otherwise follows
// collide_support_plain operation by operation (unified_math.cuh), built
// with -fmad=false and without fast math.
//
// Scalar type: every kernel that touches floats is a template on T, with a
// float instantiation (edyn_unified_features, edyn_collide_support) and a
// double one (the *_f64 entries, the port's float64 mode; the TPU kernel
// never had one, Pallas on a TPU has no float64). At double a row's lanes
// are 8 bytes, a lane group 32 bytes loaded as two 16-byte halves, the
// header's counts int64 bits (Quad<double> in unified_math.cuh), and the
// pre-pass's shared tile twice the bytes. The pair order reads integers
// only and serves both.

#include <cuda_runtime.h>

#include "unified_math.cuh"

using namespace unified;

namespace {

constexpr int THREADS = 128;
// cap of the per-side vertex registers (unified_kernel.VMAX): every convex
// shape of the JAX package's scenes and tests fits (box V 8)
constexpr int VMAX = 8;
constexpr int HDR = 4;  // float4s of a row's header
constexpr int NCODES = 1 << 13;  // class codes of a body
constexpr int MAX_SIDE = 32;     // side classes told apart
constexpr int MAX_BINS = MAX_SIDE * MAX_SIDE;
constexpr int SORT_WARPS = 8;    // warps per block of the counting sort
constexpr int WARP_PAIRS = 128;  // pairs of one warp in the counting sort
constexpr int CHUNK = SORT_WARPS * WARP_PAIRS;  // pairs of one block
constexpr int PRE_WARPS = 4;     // warps per block of the pre-pass

// ---------------------------------------------------------------------------
// 1. per-body pre-pass
// ---------------------------------------------------------------------------

// A block takes 32 bodies: it stages their [C, 32] columns in shared memory
// (coalesced 128-byte row reads; a row pitch of 33 floats keeps the later
// column reads free of bank conflicts), then each warp writes the rows of
// 8 bodies, lane l rotating feature l (vertices, then faces, then edges)
// and storing its float4, so a row is written by contiguous 16-byte
// stores. The real counts are warp maxima of the unmasked indices.
template <typename T>
__global__ void __launch_bounds__(32 * PRE_WARPS)
    features_kernel(const T* __restrict__ tbl, int N, int V, int F,
                    int E, Q4<T>* __restrict__ feat,
                    int* __restrict__ code, int* __restrict__ present) {
  extern __shared__ __align__(16) unsigned char tile_raw[];
  T* tile = reinterpret_cast<T*>(tile_raw);  // [C][33]
  __shared__ int codes[32];
  const int C = 12 + 4 * (V + F + E);
  const int j0 = blockIdx.x * 32;
#pragma unroll 8
  for (int i = threadIdx.x; i < C * 32; i += 32 * PRE_WARPS) {
    const int r = i >> 5, b = i & 31;
    tile[r * 33 + b] = j0 + b < N ? __ldg(tbl + (long long)r * N + j0 + b)
                                  : T(0.0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < 32; b += PRE_WARPS) {
    const int j = j0 + b;
    if (j >= N) break;  // the whole warp
    const auto c = [&](int r) { return tile[r * 33 + b]; };
    const V3<T> pos = mk(c(0), c(1), c(2));
    const T q[4] = {c(3), c(4), c(5), c(6)};
    const T disc_r = c(8);
    Q4<T>* row = feat + (long long)j * (HDR + V + F + E);
    const int ov = 12, of = ov + 4 * V, oe = of + 4 * F;
    int lv = -1, lf = -1, le = -1;  // last unmasked index seen by this lane
    for (int f = lane; f < V + F + E; f += 32) {
      V3<T> x;
      bool m;
      if (f < V) {
        x = world_point(q, pos, mk(c(ov + f), c(ov + V + f),
                                   c(ov + 2 * V + f)));
        m = c(ov + 3 * V + f) > T(0.5);
        if (m) lv = f;
      } else if (f < V + F) {
        const int i = f - V;
        x = world_dir(q, mk(c(of + i), c(of + F + i), c(of + 2 * F + i)));
        m = c(of + 3 * F + i) > T(0.5);
        if (m) lf = i;
      } else {
        const int i = f - V - F;
        x = world_dir(q, mk(c(oe + i), c(oe + E + i), c(oe + 2 * E + i)));
        m = c(oe + 3 * E + i) > T(0.5);
        if (m) le = i;
      }
      row[HDR + f] = Quad<T>::make(x.x, x.y, x.z, m ? T(1.0) : T(0.0));
    }
    const int nv = max(__reduce_max_sync(0xffffffffu, lv) + 1, 1);
    const int nf = __reduce_max_sync(0xffffffffu, lf) + 1;
    const int ne = __reduce_max_sync(0xffffffffu, le) + 1;
    if (lane == 0) {
      const V3<T> w = world_dir(q, mk(c(9), c(10), c(11)));
      const int cd = min(nv, 15) | (min(nf, 15) << 4) | (min(ne, 15) << 8) |
                     ((disc_r > T(1e-9) ? 1 : 0) << 12);
      row[0] = Quad<T>::make(pos.x, pos.y, pos.z, c(7));
      row[1] = Quad<T>::make(q[0], q[1], q[2], q[3]);
      row[2] = Quad<T>::make(w.x, w.y, w.z, disc_r);
      row[3] = Quad<T>::make(Quad<T>::from_int(nv), Quad<T>::from_int(nf),
                           Quad<T>::from_int(ne), Quad<T>::from_int(cd));
      code[j] = cd;
      codes[b] = cd;
    }
  }
  // one flag store per distinct code of the block, none once it is set
  // (stores to one address from every block would serialise in L2)
  __syncthreads();
  if (threadIdx.x < 32) {
    const int cd = j0 + lane < N ? codes[lane] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, cd);
    if (cd >= 0 && lane == __ffs(peers) - 1 && __ldcg(present + cd) == 0)
      present[cd] = 1;
  }
}

// the class number of each code present (the count of codes present before
// it, clamped at MAX_SIDE - 1), and how many there are (at most MAX_SIDE)
// in ids[NCODES]; warp w numbers codes [256 w, 256 w + 256) by ballots
__global__ void __launch_bounds__(1024)
    class_ids_kernel(const int* __restrict__ present, int* __restrict__ ids) {
  constexpr int PER = NCODES / 1024;  // ballots per warp
  __shared__ int wsum[32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int before[PER];
  int run = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const unsigned bal =
        __ballot_sync(0xffffffffu, present[(w * PER + r) * 32 + lane] != 0);
    before[r] = run + __popc(bal & below);
    run += __popc(bal);
  }
  if (lane == 0) wsum[w] = run;
  __syncthreads();
  if (w == 0) {  // exclusive scan of the 32 warp totals
    const int v = wsum[lane];
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    wsum[lane] = incl - v;
    if (lane == 31) ids[NCODES] = min(incl, MAX_SIDE);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r)
    ids[(w * PER + r) * 32 + lane] = min(wsum[w] + before[r], MAX_SIDE - 1);
}

// ---------------------------------------------------------------------------
// 2. stable counting sort of the pairs by class
// ---------------------------------------------------------------------------

// count of each bin in a warp's WARP_PAIRS pairs, pair k0 + 32 step + lane
// holding bin b[step] (-1 past K): hist[bin] += its count
__device__ __forceinline__ void warp_hist(const int (&b)[WARP_PAIRS / 32],
                                          int lane, int* hist) {
#pragma unroll
  for (int step = 0; step < WARP_PAIRS / 32; ++step) {
    const unsigned peers = __match_any_sync(0xffffffffu, b[step]);
    if (b[step] >= 0 && lane == __ffs(peers) - 1)
      hist[b[step]] += __popc(peers);
    __syncwarp();
  }
}

// bin of each pair (class number of A x classes + that of B), and the
// count per bin of each chunk of CHUNK pairs (one block a chunk), bin-major
__global__ void __launch_bounds__(32 * SORT_WARPS)
    pair_bins_kernel(const int* __restrict__ code,
                     const int* __restrict__ ids,
                     const long long* __restrict__ ka,
                     const long long* __restrict__ kb, int K, int nchunks,
                     int* __restrict__ bins, int* __restrict__ counts) {
  __shared__ int hist[SORT_WARPS][MAX_BINS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = ids[NCODES], nb = D * D;
  for (int b = lane; b < nb; b += 32) hist[w][b] = 0;
  const int k0 = blockIdx.x * CHUNK + w * WARP_PAIRS;
  int bin[WARP_PAIRS / 32];
#pragma unroll
  for (int step = 0; step < WARP_PAIRS / 32; ++step) {
    const int k = k0 + step * 32 + lane;
    bin[step] = -1;
    if (k < K) {
      bin[step] = ids[code[ka[k]]] * D + ids[code[kb[k]]];
      bins[k] = bin[step];
    }
  }
  __syncwarp();
  warp_hist(bin, lane, hist[w]);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += 32 * SORT_WARPS) {
    int n = 0;
#pragma unroll
    for (int v = 0; v < SORT_WARPS; ++v) n += hist[v][b];
    counts[(long long)b * nchunks + blockIdx.x] = n;
  }
}

// exclusive scan of the counts, in place (one block): the first position
// of each (bin, chunk)
__global__ void __launch_bounds__(1024)
    bin_offsets_kernel(const int* __restrict__ ids, int nchunks,
                       int* __restrict__ counts) {
  __shared__ int wsum[32];
  __shared__ int carry;
  const int D = ids[NCODES];
  const int L = D * D * nchunks;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) carry = 0;
  for (int base = 0; base < L; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < L ? counts[i] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    if (w == 0) {
      const int s = wsum[lane];
      int si = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, si, off);
        if (lane >= off) si += u;
      }
      wsum[lane] = si - s;
    }
    __syncthreads();
    if (i < L) counts[i] = carry + wsum[w] + incl - v;
    __syncthreads();
    if (threadIdx.x == 1023) carry += wsum[w] + incl;
    __syncthreads();
  }
}

// each chunk writes its pairs' indices at their bins' positions, in order:
// warp w of the block starts after the block's earlier warps
__global__ void __launch_bounds__(32 * SORT_WARPS)
    pair_place_kernel(const int* __restrict__ ids,
                      const int* __restrict__ bins,
                      const int* __restrict__ offsets, int K, int nchunks,
                      long long* __restrict__ perm) {
  __shared__ int hist[SORT_WARPS][MAX_BINS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = ids[NCODES], nb = D * D;
  for (int b = lane; b < nb; b += 32) hist[w][b] = 0;
  const int k0 = blockIdx.x * CHUNK + w * WARP_PAIRS;
  int bin[WARP_PAIRS / 32];
#pragma unroll
  for (int step = 0; step < WARP_PAIRS / 32; ++step) {
    const int k = k0 + step * 32 + lane;
    bin[step] = k < K ? bins[k] : -1;
  }
  __syncwarp();
  warp_hist(bin, lane, hist[w]);
  __syncthreads();
  // each warp's first position per bin, in place of the counts: the
  // chunk's offset plus the counts of the block's earlier warps
  for (int b = threadIdx.x; b < nb; b += 32 * SORT_WARPS) {
    int run = offsets[(long long)b * nchunks + blockIdx.x];
#pragma unroll
    for (int v = 0; v < SORT_WARPS; ++v) {
      const int n = hist[v][b];
      hist[v][b] = run;
      run += n;
    }
  }
  __syncthreads();
  int* base = hist[w];
#pragma unroll
  for (int step = 0; step < WARP_PAIRS / 32; ++step) {
    const int b = bin[step];
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0) perm[base[b] + __popc(peers & ((1u << lane) - 1u))] =
        k0 + step * 32 + lane;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) base[b] += __popc(peers);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// 3. per-pair kernel
// ---------------------------------------------------------------------------

// One side of a pair: its row and header.
template <typename T>
struct Side {
  const Q4<T>* row;
  V3<T> pos;
  T orn[4];
  T radius, disc_r;
  V3<T> w;            // world disc axis
  int nv, nf, ne;  // real counts
  unsigned vm;     // mask bits of vertices 0..nv-1
};

// World vertices of a side, in registers (indexed by unrolled loops only).
template <typename T>
struct Verts {
  V3<T> v[VMAX];
};

template <typename T>
__device__ __forceinline__ Side<T> load_side(const Q4<T>* feat, long long body,
                                          int rs4) {
  Side<T> S;
  S.row = feat + body * rs4;
  const Q4<T> h0 = Quad<T>::ldg(S.row), h1 = Quad<T>::ldg(S.row + 1),
               h2 = Quad<T>::ldg(S.row + 2), h3 = Quad<T>::ldg(S.row + 3);
  S.pos = mk(h0.x, h0.y, h0.z);
  S.radius = h0.w;
  S.orn[0] = h1.x;
  S.orn[1] = h1.y;
  S.orn[2] = h1.z;
  S.orn[3] = h1.w;
  S.w = mk(h2.x, h2.y, h2.z);
  S.disc_r = h2.w;
  S.nv = Quad<T>::to_int(h3.x);
  S.nf = Quad<T>::to_int(h3.y);
  S.ne = Quad<T>::to_int(h3.z);
  S.vm = 0u;
  return S;
}

// the side's vertices from its row into registers, and their mask bits
template <typename T, bool RELOAD>
__device__ __forceinline__ void load_verts(Side<T>& S, Verts<T>& X) {
  unsigned vm = 0u;
#pragma unroll
  for (int v = 0; v < VMAX; ++v) {
    if (v < S.nv) {
      const Q4<T> q =
          RELOAD ? Quad<T>::ld_nc(S.row + HDR + v) : Quad<T>::ldg(S.row + HDR + v);
      X.v[v] = mk(q.x, q.y, q.z);
      if (q.w > T(0.5)) vm |= 1u << v;
    } else {
      X.v[v] = mk(T(0.0), T(0.0), T(0.0));
    }
  }
  S.vm = vm;
}

// a side's header and vertices loaded again from its row, for one of the
// passes after the SAT (nothing of a side stays live between passes)
template <typename T>
__device__ __forceinline__ void reload_side(const Q4<T>* row, Side<T>& S,
                                            Verts<T>& X) {
  S.row = row;
  const Q4<T> h0 = Quad<T>::ld_nc(row), h2 = Quad<T>::ld_nc(row + 2), h3 = Quad<T>::ld_nc(row + 3);
  S.pos = mk(h0.x, h0.y, h0.z);
  S.radius = h0.w;
  S.w = mk(h2.x, h2.y, h2.z);
  S.disc_r = h2.w;
  S.nv = Quad<T>::to_int(h3.x);
  load_verts<T, true>(S, X);
}

// masked projection of vertex v on d
template <typename T>
__device__ __forceinline__ T vproj(const Side<T>& S, const Verts<T>& X, int v,
                                       V3<T> d) {
  return ((S.vm >> v) & 1u) ? dot(d, X.v[v]) : -kbig<T>();
}

template <typename T>
__device__ __forceinline__ T max_proj(const Side<T>& S, const Verts<T>& X,
                                          V3<T> d) {
  T m = vproj(S, X, 0, d);
#pragma unroll
  for (int v = 1; v < VMAX; ++v)
    if (v < S.nv) m = maxf(m, vproj(S, X, v, d));
  return m;
}

// first vertex of largest masked projection: its index, and the vertex,
// carried through the scan (an index-equality select over the array would
// let the compiler turn the register array into an indexed local array)
template <typename T>
__device__ __forceinline__ V3<T> deepest(const Side<T>& S, const Verts<T>& X, V3<T> d,
                                      int* index = nullptr) {
  T m = vproj(S, X, 0, d);
  V3<T> r = X.v[0];
  int best = 0;
#pragma unroll
  for (int v = 1; v < VMAX; ++v) {
    if (v < S.nv) {
      const T p = vproj(S, X, v, d);
      if (p > m) {
        m = p;
        best = v;
        r = X.v[v];
      }
    }
  }
  if (index) *index = best;
  return r;
}

template <typename T>
__device__ __forceinline__ T support_projection(const Side<T>& S,
                                                    const Verts<T>& X, V3<T> d) {
  const T base = max_proj(S, X, d);
  const T dw = dot(d, S.w);
  const T perp2 = maxf(dot(d, d) - dw * dw, T(0.0));
  return base + S.radius + S.disc_r * sqrt_(perp2);
}

template <typename T>
__device__ __forceinline__ V3<T> support_point(const Side<T>& S, const Verts<T>& X,
                                            V3<T> d) {
  const V3<T> base = deepest(S, X, d);
  const T dw = dot(d, S.w);
  const V3<T> perp = sub(d, scale(S.w, dw));
  const T plen = length(perp);
  const V3<T> disc = scale(perp, S.disc_r / maxf(plen, keps<T>()));
  return add(add(base, scale(d, S.radius)), disc);
}

template <typename T>
__device__ __forceinline__ V3<T> closest_on_circle(V3<T> c, V3<T> w, T r, V3<T> x) {
  const V3<T> u = sub(x, c);
  const V3<T> perp = sub(u, scale(w, dot(u, w)));
  V3<T> t1, t2;
  ortho_basis(w, t1, t2);
  return add(c, scale(normalize_or(perp, t1), r));
}

template <typename T>
__device__ __forceinline__ V3<T> closest_on_segment(V3<T> q0, V3<T> q1, V3<T> x) {
  const V3<T> d = sub(q1, q0);
  const T dd = dot(d, d);
  const T t =
      minf(maxf(dot(sub(x, q0), d) / maxf(dd, keps<T>()), T(0.0)), T(1.0));
  return add(q0, scale(d, t));
}

// rim candidate axis of side C (which has a disc) against side D
// (pallas_unified._rim_axes)
template <typename T>
__device__ __forceinline__ V3<T> rim_axis(const Side<T>& C, const Verts<T>& XC,
                                       const Side<T>& D, const Verts<T>& XD,
                                       V3<T> seed, bool& ok) {
  const V3<T> cC = deepest(C, XC, neg(seed));
  const T rC = C.disc_r;
  const bool d_is_disc = D.disc_r > T(1e-9);
  int i0;
  const V3<T> cD = deepest(D, XD, seed, &i0);
  // the two highest-projection vertices of D along seed
  T m2 = i0 == 0 ? -kbig<T>() : vproj(D, XD, 0, seed);
  V3<T> q1 = XD.v[0];
#pragma unroll
  for (int v = 1; v < VMAX; ++v) {
    if (v < D.nv) {
      const T p = v == i0 ? -kbig<T>() : vproj(D, XD, v, seed);
      if (p > m2) {
        m2 = p;
        q1 = XD.v[v];
      }
    }
  }
  const V3<T> q0 = cD;
  if (!(m2 > -T(1e29))) q1 = q0;

  V3<T> p = closest_on_circle(cC, C.w, rC, cD);
  V3<T> q = p;
  for (int it = 0; it < 8; ++it) {
    q = d_is_disc ? closest_on_circle(cD, D.w, D.disc_r, p)
                  : closest_on_segment(q0, q1, p);
    p = closest_on_circle(cC, C.w, rC, q);
  }
  const V3<T> ax = sub(p, q);
  ok = length(ax) > T(1e-7);
  return normalize_or(ax, seed);
}

// direction of the supporting feature along d when it is a line (2 verts)
template <typename T>
__device__ __forceinline__ V3<T> line_feature_dir(const Side<T>& S, const Verts<T>& X,
                                               V3<T> d, bool& line) {
  const T thr = max_proj(S, X, d) - T(1e-3);
  bool feat[VMAX];
#pragma unroll
  for (int v = 0; v < VMAX; ++v)
    feat[v] = v < S.nv && ((S.vm >> v) & 1u) && vproj(S, X, v, d) >= thr;
  T cnt = feat[0] ? T(1.0) : T(0.0);
  V3<T> acc = scale(X.v[0], cnt);
#pragma unroll
  for (int v = 1; v < VMAX; ++v) {
    if (v < S.nv) {
      const T f = feat[v] ? T(1.0) : T(0.0);
      cnt = cnt + f;
      acc = add(acc, scale(X.v[v], f));
    }
  }
  const T div = maxf(cnt, T(1.0));
  const V3<T> cen = mk(acc.x / div, acc.y / div, acc.z / div);
  V3<T> best = feat[0] ? sub(X.v[0], cen) : mk(T(0.0), T(0.0), T(0.0));
  T bd = dot(best, best);
#pragma unroll
  for (int v = 1; v < VMAX; ++v) {
    if (v < S.nv) {
      const V3<T> df = feat[v] ? sub(X.v[v], cen) : mk(T(0.0), T(0.0), T(0.0));
      const T d2 = dot(df, df);
      if (d2 > bd) {
        bd = d2;
        best = df;
      }
    }
  }
  line = cnt == T(2.0);
  return best;
}

template <typename T>
__device__ __forceinline__ bool flat_feature(const Side<T>& S, const Verts<T>& X,
                                             V3<T> d) {
  const T thr = max_proj(S, X, d) - T(1e-3);
  T cnt = vproj(S, X, 0, d) >= thr ? T(1.0) : T(0.0);
#pragma unroll
  for (int v = 1; v < VMAX; ++v)
    if (v < S.nv) cnt = cnt + (vproj(S, X, v, d) >= thr ? T(1.0) : T(0.0));
  const bool cap = (S.disc_r > T(1e-9)) && (fabs_(dot(d, S.w)) > T(0.99));
  return (S.radius < T(1e-9)) && ((cnt >= T(2.0)) || cap);
}

// extent [lo, hi] along t of the supporting feature along d
template <typename T>
__device__ __forceinline__ void feature_slab(const Side<T>& S, const Verts<T>& X,
                                             V3<T> d, V3<T> t, T& lo,
                                             T& hi) {
  const T thr = max_proj(S, X, d) - T(1e-3);
  lo = kbig<T>();
  hi = -kbig<T>();
#pragma unroll
  for (int v = 0; v < VMAX; ++v) {
    if (v < S.nv) {
      const bool feat = vproj(S, X, v, d) >= thr;
      const T vt = dot(t, X.v[v]);
      lo = minf(lo, feat ? vt : kbig<T>());
      hi = maxf(hi, feat ? vt : -kbig<T>());
    }
  }
  const T off = S.radius * dot(d, t);
  const T dw = dot(d, S.w);
  const V3<T> perp = sub(d, scale(S.w, dw));
  const T plen = length(perp);
  const bool cap = fabs_(dw) > T(0.99);
  const V3<T> tw = sub(t, scale(S.w, dot(t, S.w)));
  const T disc_span = S.disc_r * length(tw);
  const T rim_off = S.disc_r * dot(perp, t) / maxf(plen, keps<T>());
  lo = lo + off + (cap ? -disc_span : rim_off);
  hi = hi + off + (cap ? disc_span : rim_off);
}

// Running first-index argmax over the unmasked candidate axes.
template <typename T>
struct Best {
  bool any;
  T sep, plane_a, plane_b;
  V3<T> n;
};

template <typename T>
__device__ __forceinline__ void consider(const Side<T>& A, const Verts<T>& XA,
                                         const Side<T>& B, const Verts<T>& XB,
                                         V3<T> delta, V3<T> axis, Best<T>& b) {
  const T sgn = dot(axis, delta) >= T(0.0) ? T(1.0) : -T(1.0);
  axis = scale(axis, sgn);
  const T pa = -support_projection(A, XA, neg(axis));
  const T pb = support_projection(B, XB, axis);
  const T sep = pa - pb;
  if (!b.any || sep > b.sep) {
    b.any = true;
    b.sep = sep;
    b.n = axis;
    b.plane_a = pa;
    b.plane_b = pb;
  }
}

__device__ __forceinline__ V3<float> xyz(float4 q) {
  return mk(q.x, q.y, q.z);
}
__device__ __forceinline__ V3<double> xyz(double4x q) {
  return mk(q.x, q.y, q.z);
}

// the face, centre-delta and cylinder-side axes of side S (A or B)
template <typename T>
__device__ __forceinline__ void side_axes(const Side<T>& A, const Verts<T>& XA,
                                          const Side<T>& B, const Verts<T>& XB,
                                          const Side<T>& S, V3<T> other, V3<T> delta,
                                          int of, Best<T>& best) {
  const V3<T> ydef = mk(T(0.0), T(1.0), T(0.0));
  for (int f = 0; f < S.nf; ++f) {
    const Q4<T> fq = Quad<T>::ldg(S.row + of + f);
    if (fq.w > T(0.5)) consider(A, XA, B, XB, delta, xyz(fq), best);
  }
  const V3<T> d = sub(other, S.pos);
  consider(A, XA, B, XB, delta, normalize_or(d, ydef), best);
  if (S.disc_r > T(1e-9)) {
    const V3<T> perp = sub(d, scale(S.w, dot(d, S.w)));
    const T plen = length(perp);
    if (plen > T(1e-9))
      consider(A, XA, B, XB, delta, scale(perp, T(1.0) / maxf(plen, keps<T>())),
               best);
  }
}

// the 5 tilted support samples of side A (candidates 0-4) or B (5-9): the
// support point pt and its depth against the other side's plane (the
// images on the other side follow from these two, see on_sides)
template <typename T, bool IS_A>
__device__ __forceinline__ void side_samples(const Side<T>& S, const Verts<T>& X,
                                             V3<T> base, V3<T> n, V3<T> t1, V3<T> t2,
                                             T plane, V3<T> (&pt)[10],
                                             T (&depth)[10]) {
  constexpr int o = IS_A ? 0 : 5;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    V3<T> tilt = mk(T(0.0), T(0.0), T(0.0));
    if (i == 1 || i == 2) tilt = t1;
    if (i == 3 || i == 4) tilt = t2;
    const T sg = (i == 1 || i == 3) ? T(1.0) : -T(1.0);
    V3<T> d = base;
    if (i > 0) {
      const V3<T> tt = scale(tilt, ktilt<T>());
      d = sg > T(0.0) ? add(base, tt) : sub(base, tt);
    }
    const V3<T> p = support_point(S, X, normalize(d));
    pt[o + i] = p;
    depth[o + i] = IS_A ? dot(p, n) - plane : plane - dot(p, n);
  }
}

// candidate i's point on A and on B before the slab shift: a sample of A
// and its image on B's plane, or the image on A's plane of a sample of B
template <typename T>
__device__ __forceinline__ void on_sides(int i, V3<T> p, T dep, V3<T> n,
                                         V3<T>& on_a, V3<T>& on_b) {
  if (i < 5) {
    on_a = p;
    on_b = sub(p, scale(n, dep));
  } else {
    on_a = add(p, scale(n, dep));
    on_b = p;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
    unified_kernel(const Q4<T>* __restrict__ feat, int V, int F, int E,
                   const long long* __restrict__ ka,
                   const long long* __restrict__ kb,
                   const long long* __restrict__ perm, int K,
                   T threshold, int rim, Q4<T>* __restrict__ out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const long long pi = perm[k];
  const int rs4 = HDR + V + F + E;
  const int of = HDR + V, oe = HDR + V + F;  // face, edge float4s
  const Q4<T>* rowA = feat + ka[pi] * rs4;
  const Q4<T>* rowB = feat + kb[pi] * rs4;

  // --- SAT over the unmasked candidate axes, in the TPU kernel's order ---
  Best<T> best;
  {
    Side<T> A = load_side<T>(feat, ka[pi], rs4);
    Side<T> B = load_side<T>(feat, kb[pi], rs4);
    const V3<T> delta = sub(A.pos, B.pos);
    const V3<T> seed = normalize_or(delta, mk(T(0.0), T(1.0), T(0.0)));
    Verts<T> XA, XB;
    load_verts<T, false>(A, XA);
    load_verts<T, false>(B, XB);
    best.any = false;
    side_axes(A, XA, B, XB, A, B.pos, delta, of, best);
    side_axes(A, XA, B, XB, B, A.pos, delta, of, best);
    for (int i = 0; i < A.ne; ++i) {
      const Q4<T> qa = Quad<T>::ldg(A.row + oe + i);
      if (!(qa.w > T(0.5))) continue;
      const V3<T> ea = xyz(qa);
      for (int j = 0; j < B.ne; ++j) {
        const Q4<T> qb = Quad<T>::ldg(B.row + oe + j);
        V3<T> cr = cross(ea, xyz(qb));
        const T crl = length(cr);
        cr = scale(cr, T(1.0) / maxf(crl, keps<T>()));
        if ((qb.w > T(0.5)) && (crl > T(1e-6)))
          consider(A, XA, B, XB, delta, cr, best);
      }
    }
    if (rim) {
      bool ok;
      if (A.disc_r > T(1e-9)) {
        const V3<T> ra = rim_axis(A, XA, B, XB, seed, ok);
        if (ok) consider(A, XA, B, XB, delta, ra, best);
      }
      if (B.disc_r > T(1e-9)) {
        const V3<T> rb = rim_axis(B, XB, A, XA, seed, ok);
        if (ok) consider(A, XA, B, XB, delta, rb, best);
      }
    }
  }
  const V3<T> n = best.n;
  const T best_sep = best.sep;
  const V3<T> nn = neg(n);

  // --- tangent basis aligned to line features ---
  bool lineA, lineB;
  V3<T> eA, eB;
  {
    Side<T> S;
    Verts<T> X;
    reload_side(rowA, S, X);
    eA = line_feature_dir(S, X, nn, lineA);
  }
  {
    Side<T> S;
    Verts<T> X;
    reload_side(rowB, S, X);
    eB = line_feature_dir(S, X, n, lineB);
  }
  const V3<T> e = sel(lineB, eB, eA);
  const V3<T> e_t = sub(e, scale(n, dot(e, n)));
  const bool use_line = (lineA || lineB) && (length(e_t) > T(1e-6));
  V3<T> t1d, t2d;
  ortho_basis(n, t1d, t2d);
  const V3<T> e_tn = normalize_or(e_t, t1d);
  const V3<T> t1 = sel(use_line, e_tn, t1d);
  const V3<T> t2 = sel(use_line, cross(n, t1), t2d);

  // --- patch sampling (5 tilted directions per side -> 10 candidates),
  //     flat features and feature slabs, one side at a time ---
  V3<T> pt[10];
  T depth[10];
  bool flat_a, flat_b;
  T lo_a[2], hi_a[2], lo_b[2], hi_b[2];
  {
    Side<T> S;
    Verts<T> X;
    reload_side(rowA, S, X);
    side_samples<T, true>(S, X, nn, n, t1, t2, best.plane_b, pt, depth);
    flat_a = flat_feature(S, X, nn);
    feature_slab(S, X, nn, t1, lo_a[0], hi_a[0]);
    feature_slab(S, X, nn, t2, lo_a[1], hi_a[1]);
  }
  {
    Side<T> S;
    Verts<T> X;
    reload_side(rowB, S, X);
    side_samples<T, false>(S, X, n, n, t1, t2, best.plane_a, pt, depth);
    flat_b = flat_feature(S, X, n);
    feature_slab(S, X, n, t1, lo_b[0], hi_b[0]);
    feature_slab(S, X, n, t2, lo_b[1], hi_b[1]);
  }
  const bool both_flat = flat_a && flat_b;

  // --- feature-slab containment / clamp ---
  T lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = maxf(lo_a[r], lo_b[r]);
    hi[r] = maxf(minf(hi_a[r], hi_b[r]), lo[r]);
  }
  V3<T> on_a[10], on_b[10];
  unsigned valid = 0u, shifted = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    on_sides(i, pt[i], depth[i], n, on_a[i], on_b[i]);
    bool ok = (depth[i] < threshold) && (best_sep < threshold);
    V3<T> shift = mk(T(0.0), T(0.0), T(0.0));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const V3<T> t = r == 0 ? t1 : t2;
      const T proj = dot(on_a[i], t);
      const bool inside = (proj >= lo[r] - T(5e-3)) && (proj <= hi[r] + T(5e-3));
      ok = ok && (inside || both_flat);
      const T clipped = minf(maxf(proj, lo[r]), hi[r]);
      const T dmove = both_flat ? clipped - proj : T(0.0);
      shift = add(shift, scale(t, dmove));
    }
    if (ok) valid |= 1u << i;
    on_a[i] = add(on_a[i], shift);
    on_b[i] = add(on_b[i], shift);
    if ((shift.x * shift.x + shift.y * shift.y + shift.z * shift.z) > keps<T>())
      shifted |= 1u << i;
  }
  // selection depth: shifted candidates rank 1e-5 deeper
  const auto sel_depth = [&](int i) {
    return depth[i] + (((shifted >> i) & 1u) ? T(1e-5) : T(0.0));
  };

  // --- reduce to <= 4 (insertion heuristic); each scan carries its
  //     pick's point on A, point on B and depth ---
  int i0 = 0;
  T m0 = (valid & 1u) ? sel_depth(0) : kbig<T>();
  V3<T> p0 = on_a[0], b0 = on_b[0];
  T dd0 = depth[0];
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    const T d0 = ((valid >> i) & 1u) ? sel_depth(i) : kbig<T>();
    if (d0 < m0) {
      m0 = d0;
      i0 = i;
      p0 = on_a[i];
      b0 = on_b[i];
      dd0 = depth[i];
    }
  }
  const bool v0 = m0 < kbig<T>() * T(0.5);
  unsigned taken = 1u << i0;

  T dist0[10];
#pragma unroll
  for (int i = 0; i < 10; ++i)
    dist0[i] = sq(on_a[i].x - p0.x) + sq(on_a[i].y - p0.y) +
               sq(on_a[i].z - p0.z);
  int i1 = 0;
  T m1 = -kbig<T>();
  V3<T> p1 = on_a[0], b1 = on_b[0];
  T dd1 = depth[0];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const T c1 = (((valid & ~taken) >> i) & 1u) ? dist0[i] : -kbig<T>();
    if (i == 0 || c1 > m1) {
      m1 = c1;
      i1 = i;
      p1 = on_a[i];
      b1 = on_b[i];
      dd1 = depth[i];
    }
  }
  const bool v1 = v0 && (m1 > T(0.0));
  taken |= 1u << i1;

  const V3<T> e01 = sub(p1, p0);
  int i2 = 0;
  T m2 = -kbig<T>();
  V3<T> p2 = on_a[0], b2 = on_b[0];
  T dd2 = depth[0];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const V3<T> crs = cross(sub(on_a[i], p0), e01);
    const T area = dot(crs, crs);
    const T c2 = (((valid & ~taken) >> i) & 1u) ? area : -kbig<T>();
    if (i == 0 || c2 > m2) {
      m2 = c2;
      i2 = i;
      p2 = on_a[i];
      b2 = on_b[i];
      dd2 = depth[i];
    }
  }
  const bool v2 = v1 && (m2 > keps<T>());
  taken |= 1u << i2;

  T m3 = -kbig<T>();
  V3<T> p3 = on_a[0], b3 = on_b[0];
  T dd3 = depth[0];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const V3<T> a = on_a[i];
    const T d_all = dist0[i] + sq(a.x - p1.x) + sq(a.y - p1.y) +
                        sq(a.z - p1.z) + sq(a.x - p2.x) + sq(a.y - p2.y) +
                        sq(a.z - p2.z);
    const T c3 = (((valid & ~taken) >> i) & 1u) ? d_all : -kbig<T>();
    if (i == 0 || c3 > m3) {
      m3 = c3;
      p3 = on_a[i];
      b3 = on_b[i];
      dd3 = depth[i];
    }
  }
  const bool v3 = v2 && (m3 > T(0.0));

  // --- output: row pi of [K, 48], 12 floats (3 float4s) per point ---
  const Q4<T> pa4 = Quad<T>::ld_nc(rowA), qa4 = Quad<T>::ld_nc(rowA + 1);
  const Q4<T> pb4 = Quad<T>::ld_nc(rowB), qb4 = Quad<T>::ld_nc(rowB + 1);
  const V3<T> posA = xyz(pa4), posB = xyz(pb4);
  const T ornA[4] = {qa4.x, qa4.y, qa4.z, qa4.w};
  const T ornB[4] = {qb4.x, qb4.y, qb4.z, qb4.w};
  Q4<T>* o = out + pi * 12;
  const auto write = [&](int p, V3<T> pa_w, V3<T> pb_w, T dd, bool pv) {
    const bool vv = pv && (dd < threshold);
    const V3<T> piv_a = qrotate_inv(ornA, sub(pa_w, posA));
    const V3<T> piv_b = qrotate_inv(ornB, sub(pb_w, posB));
    o[3 * p] = Quad<T>::make(piv_a.x, piv_a.y, piv_a.z, piv_b.x);
    o[3 * p + 1] = Quad<T>::make(piv_b.y, piv_b.z, n.x, n.y);
    o[3 * p + 2] = Quad<T>::make(n.z, T(0.0), dd, vv ? T(1.0) : T(0.0));
  };
  write(0, p0, b0, dd0, v0);
  write(1, p1, b1, dd1, v1);
  write(2, p2, b2, dd2, v2);
  write(3, p3, b3, dd3, v3);
}

template <typename T>
int unified_features(const T* tbl, int N, int V, int F, int E, T* feat,
                     int* code, int* present, int* ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V > VMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(present, 0, NCODES * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the staged [C][33] tile, sized by the scalar type (84 rows: ~11 KB at
  // float, ~22 KB at double)
  const size_t tile = sizeof(T) * 33 * (12 + 4 * (V + F + E));
  if (tile > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0)
    features_kernel<T><<<(N + 31) / 32, 32 * PRE_WARPS, tile, s>>>(
        tbl, N, V, F, E, reinterpret_cast<Q4<T>*>(feat), code, present);
  class_ids_kernel<<<1, 1024, 0, s>>>(present, ids);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int collide_support(const T* feat, int V, int F, int E, const long long* ka,
                    const long long* kb, const long long* perm, int K,
                    T threshold, int rim, T* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V > VMAX) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  unified_kernel<T><<<(K + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      reinterpret_cast<const Q4<T>*>(feat), V, F, E, ka, kb, perm, K,
      threshold, rim, reinterpret_cast<Q4<T>*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tbl [C, N] side table of widths (V, F, E); feat [N, 4 (4 + V + F + E)]
// body-major world features; code [N] int32 class codes; present [NCODES]
// int32 scratch; ids [NCODES + 1] int32 class numbers. float32 tables here,
// float64 in edyn_unified_features_f64.
extern "C" int edyn_unified_features(const float* tbl, int N, int V, int F,
                                     int E, float* feat, int* code,
                                     int* present, int* ids, void* stream) {
  return unified_features(tbl, N, V, F, E, feat, code, present, ids, stream);
}

extern "C" int edyn_unified_features_f64(const double* tbl, int N, int V,
                                         int F, int E, double* feat,
                                         int* code, int* present, int* ids,
                                         void* stream) {
  return unified_features(tbl, N, V, F, E, feat, code, present, ids, stream);
}

// code, ids from edyn_unified_features; ka, kb [K] int64 body indices;
// bins [K] int32 and counts [MAX_BINS * ceil(K / CHUNK)] int32 scratch
// (CHUNK = 1,024);
// perm [K] int64: the pairs stably sorted by class. Integers only: one
// entry point for both scalar types.
extern "C" int edyn_unified_pair_order(const int* code, const int* ids,
                                       const long long* ka,
                                       const long long* kb, int K, int* bins,
                                       int* counts, long long* perm,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0) return 0;
  const int nchunks = (K + CHUNK - 1) / CHUNK;
  pair_bins_kernel<<<nchunks, 32 * SORT_WARPS, 0, s>>>(code, ids, ka, kb, K,
                                                       nchunks, bins, counts);
  bin_offsets_kernel<<<1, 1024, 0, s>>>(ids, nchunks, counts);
  pair_place_kernel<<<nchunks, 32 * SORT_WARPS, 0, s>>>(ids, bins, counts,
                                                        K, nchunks, perm);
  return static_cast<int>(cudaGetLastError());
}

// feat from edyn_unified_features; ka, kb [K] int64; perm [K] int64 (pairs
// in class order); out [K, 48] of the features' scalar type.
extern "C" int edyn_collide_support(const float* feat, int V, int F, int E,
                                    const long long* ka, const long long* kb,
                                    const long long* perm, int K,
                                    float threshold, int rim, float* out,
                                    void* stream) {
  return collide_support(feat, V, F, E, ka, kb, perm, K, threshold, rim, out,
                         stream);
}

extern "C" int edyn_collide_support_f64(const double* feat, int V, int F,
                                        int E, const long long* ka,
                                        const long long* kb,
                                        const long long* perm, int K,
                                        double threshold, int rim,
                                        double* out, void* stream) {
  return collide_support(feat, V, F, E, ka, kb, perm, K, threshold, rim, out,
                         stream);
}
