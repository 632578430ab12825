// Float3 arithmetic of the UNIFIED narrowphase kernels (unified_kernel.cu):
// the per-body pre-pass and the per-pair kernel share these functions, so a
// world-space feature written by the pre-pass has the bits the per-pair code
// of collide_support_plain derives. Every sum runs in the plain version's
// order ((a0*b0 + a1*b1) + a2*b2); the library is built with -fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace unified {

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

// World space of an object-space vertex and of an object-space direction
// (collide_support_plain's _world).
__device__ __forceinline__ F3 world_point(const float q[4], F3 pos, F3 v) {
  return add(qrotate(q, v), pos);
}
__device__ __forceinline__ F3 world_dir(const float q[4], F3 v) {
  return qrotate(q, v);
}

}  // namespace unified
