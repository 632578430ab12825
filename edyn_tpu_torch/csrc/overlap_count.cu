// Dense AABB-overlap pair count (K5) for Hopper (sm_90a), with a plain C
// interface for ctypes (edyn_tpu_torch/ops/overlap_count.py).
//
// Replaces the Pallas TPU kernel count_overlaps
// (edyn_tpu/ops/overlap_count.py, body _kernel): the number of pairs i < j
// of valid AABBs that overlap on all three axes (touching counts), without
// materialising the [N, N] mask. The TPU kernel walks its (i, j) tile grid
// in order and keeps the count in SMEM across grid steps; here each block
// takes one tile pair of the upper triangle, reduces its own count and adds
// it once to a 64-bit total with an atomic.
//
// Input: aabb_min, aabb_max [N, 3] and valid [N] bool, as the state holds
// them. The kernel is a template on the boxes' scalar type: a float entry
// (edyn_count_overlaps) and a double one (edyn_count_overlaps_f64, the
// port's float64 mode); the staged tiles hold the same type (32 KB of
// shared memory a block at double).
//
// Bound: operations (6 compares, the validity test and the count per
// candidate pair, N(N-1)/2 pairs, against 25 bytes a box). The first version
// read 7 shared-memory scalars per test, which capped it at one test per
// shared-memory load. The design:
// - register tiling: a thread holds R = 4 i-boxes, and reads each j-box of
//   the shared tile once for its R tests, as two 16-byte loads (min xyz
//   with the validity flag, max xyz): 0.5 loads a test;
// - a branch-free inner loop (predicates combined with &): the j-box's
//   validity is tested once for the R tests, an i-box's once at the end
//   (its count is kept only if it is valid), i < j only on diagonal tiles,
//   and the ragged last tile once, at staging (its missing boxes are
//   flagged invalid);
// - a 1-D grid over the nb(nb + 1)/2 upper tiles only.
// Validity stays a flag: every extent, also +-inf and +-1e30, is compared
// as the plain version compares it.

#include <cuda_runtime.h>

namespace {

// a staged box: min xyz with the validity flag, or max xyz
template <typename T>
struct Box4;
template <>
struct Box4<float> {
  using type = float4;
};
struct __align__(16) double4x {
  double x, y, z, w;
};
template <>
struct Box4<double> {
  using type = double4x;
};
template <typename T>
using B4 = typename Box4<T>::type;

template <typename T>
__device__ __forceinline__ B4<T> box4(T x, T y, T z, T w) {
  B4<T> r;
  r.x = x;
  r.y = y;
  r.z = z;
  r.w = w;
  return r;
}

constexpr int THREADS = 128;
constexpr int R = 4;                 // i-boxes per thread
constexpr int TILE = THREADS * R;    // boxes per i-tile and per j-tile

// i-box q of a thread is box t + q * THREADS of the i-tile
template <typename T, bool DIAG>
__device__ __forceinline__ void count_tile(const B4<T>* jmin,
                                           const B4<T>* jmax,
                                           const T (&lo)[R][3],
                                           const T (&hi)[R][3], int t,
                                           unsigned (&cnt)[R]) {
#pragma unroll 4
  for (int u = 0; u < TILE; ++u) {
    const B4<T> bl = jmin[u];
    const B4<T> bh = jmax[u];
    const bool vj = bl.w != T(0);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      bool o = vj & (lo[q][0] <= bh.x) & (hi[q][0] >= bl.x) &
               (lo[q][1] <= bh.y) & (hi[q][1] >= bl.y) &
               (lo[q][2] <= bh.z) & (hi[q][2] >= bl.z);
      if (DIAG) o = o & (t + q * THREADS < u);
      cnt[q] += o ? 1u : 0u;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    overlap_kernel(const T* __restrict__ amin, const T* __restrict__ amax,
                   const bool* __restrict__ valid, int n,
                   unsigned long long* __restrict__ total) {
  // block b -> tile pair (ti, tj), ti <= tj, rows of the triangle tj:
  // b = tj (tj + 1) / 2 + ti
  const long long b = blockIdx.x;
  long long r = (long long)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > b) --r;
  while ((r + 1) * (r + 2) / 2 <= b) ++r;
  const int tj = (int)r;
  const int ti = (int)(b - r * (r + 1) / 2);

  __shared__ B4<T> jmin[TILE], jmax[TILE];
  __shared__ unsigned int warp_sum[THREADS / 32];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int u = t + q * THREADS;
    const int g = tj * TILE + u;
    if (g < n) {
      const T* a = amin + (long long)g * 3;
      const T* c = amax + (long long)g * 3;
      jmin[u] = box4(a[0], a[1], a[2], valid[g] ? T(1) : T(0));
      jmax[u] = box4(c[0], c[1], c[2], T(0));
    } else {
      jmin[u] = box4(T(0), T(0), T(0), T(0));
      jmax[u] = box4(T(0), T(0), T(0), T(0));
    }
  }
  T lo[R][3], hi[R][3];
  bool vi[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int g = ti * TILE + t + q * THREADS;
    vi[q] = g < n && valid[g];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[q][c] = g < n ? amin[(long long)g * 3 + c] : T(0);
      hi[q][c] = g < n ? amax[(long long)g * 3 + c] : T(0);
    }
  }
  __syncthreads();

  unsigned cnt[R];
#pragma unroll
  for (int q = 0; q < R; ++q) cnt[q] = 0u;
  if (ti == tj)
    count_tile<T, true>(jmin, jmax, lo, hi, t, cnt);
  else
    count_tile<T, false>(jmin, jmax, lo, hi, t, cnt);
  unsigned count = 0u;
#pragma unroll
  for (int q = 0; q < R; ++q) count += vi[q] ? cnt[q] : 0u;

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((t & 31) == 0) warp_sum[t >> 5] = count;
  __syncthreads();
  if (t == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sum[w];
    if (s) atomicAdd(total, s);
  }
}

template <typename T>
int count_overlaps(const T* amin, const T* amax, const bool* valid, int n,
                   unsigned long long* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(*total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nb = (n + TILE - 1) / TILE;
  if (nb == 0) return 0;
  overlap_kernel<T><<<(unsigned)(nb * (nb + 1) / 2), THREADS, 0, s>>>(
      amin, amax, valid, n, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// amin, amax [n, 3] float32, valid [n] bool; total: one int64 on the
// device, set to the count.
extern "C" int edyn_count_overlaps(const float* amin, const float* amax,
                                   const bool* valid, int n,
                                   unsigned long long* total, void* stream) {
  return count_overlaps(amin, amax, valid, n, total, stream);
}

// the same at float64
extern "C" int edyn_count_overlaps_f64(const double* amin,
                                       const double* amax, const bool* valid,
                                       int n, unsigned long long* total,
                                       void* stream) {
  return count_overlaps(amin, amax, valid, n, total, stream);
}
