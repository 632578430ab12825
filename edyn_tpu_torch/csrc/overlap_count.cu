// Dense AABB-overlap pair count for Hopper (sm_90a), with a plain C
// interface for ctypes (edyn_tpu_torch/ops/overlap_count.py).
//
// Replaces the Pallas TPU kernel count_overlaps
// (edyn_tpu/ops/overlap_count.py, body _kernel): the number of pairs i < j
// of valid AABBs that overlap on all three axes, without materialising the
// [N, N] mask. The TPU kernel walks its (i, j) tile grid in order and keeps
// the count in SMEM across grid steps; here the blocks of the upper-triangle
// tiles run in parallel, each reduces its own count and adds it once to a
// 64-bit total with an atomic.
//
// Input: aabb_min, aabb_max [N, 3] float32 and valid [N] bool, as the
// state holds them (the TPU kernel packed them into [N, 8] rows first).
// Block (i, j) with j >= i: 256 threads, thread t holds box i*256 + t in
// registers, the j-tile's 256 boxes are staged in shared memory, and each
// thread tests its box against all 256. Tiles below the diagonal return at
// once.
//
// Bound: operations. Each candidate pair costs ~8 compares and logic ops,
// N(N-1)/2 pairs, against 25 bytes read per box (each box is read by
// ~N/256 blocks, from L2 after the first).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

__global__ void __launch_bounds__(TILE)
    overlap_kernel(const float* __restrict__ amin,
                   const float* __restrict__ amax,
                   const bool* __restrict__ valid, int n,
                   unsigned long long* __restrict__ total) {
  const int ti = blockIdx.y, tj = blockIdx.x;
  if (tj < ti) return;
  __shared__ float bj[7][TILE];
  __shared__ unsigned int warp_sum[TILE / 32];
  const int t = threadIdx.x;
  const int gi = ti * TILE + t;
  const int gjt = tj * TILE + t;
  // stage the j-tile (component-major: conflict-free reads below)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bj[c][t] = gjt < n ? amin[(long long)gjt * 3 + c] : 0.0f;
    bj[3 + c][t] = gjt < n ? amax[(long long)gjt * 3 + c] : 0.0f;
  }
  bj[6][t] = gjt < n && valid[gjt] ? 1.0f : 0.0f;
  float a[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = gi < n ? amin[(long long)gi * 3 + c] : 0.0f;
    a[3 + c] = gi < n ? amax[(long long)gi * 3 + c] : 0.0f;
  }
  const bool ok_i = gi < n && valid[gi];
  __syncthreads();

  unsigned int count = 0;
  if (ok_i) {
    for (int u = 0; u < TILE; ++u) {
      const int gj = tj * TILE + u;
      const bool o = gi < gj && gj < n && bj[6][u] > 0.5f &&
                     a[0] <= bj[3][u] && a[3] >= bj[0][u] &&
                     a[1] <= bj[4][u] && a[4] >= bj[1][u] &&
                     a[2] <= bj[5][u] && a[5] >= bj[2][u];
      count += o ? 1u : 0u;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((t & 31) == 0) warp_sum[t >> 5] = count;
  __syncthreads();
  if (t == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < TILE / 32; ++w) s += warp_sum[w];
    if (s) atomicAdd(total, s);
  }
}

}  // namespace

// amin, amax [n, 3] float32, valid [n] bool; total: one int64 on the
// device, set to the count.
extern "C" int edyn_count_overlaps(const float* amin, const float* amax,
                                   const bool* valid, int n,
                                   unsigned long long* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(*total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + TILE - 1) / TILE;
  if (nb == 0) return 0;
  dim3 grid(nb, nb);
  overlap_kernel<<<grid, TILE, 0, s>>>(amin, amax, valid, n, total);
  return static_cast<int>(cudaGetLastError());
}
