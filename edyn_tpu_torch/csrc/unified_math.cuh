// Vector arithmetic of the UNIFIED narrowphase kernels (unified_kernel.cu):
// the per-body pre-pass and the per-pair kernel share these functions, so a
// world-space feature written by the pre-pass has the bits the per-pair code
// of collide_support_plain derives. Every sum runs in the plain version's
// order ((a0*b0 + a1*b1) + a2*b2); the library is built with -fmad=false.
//
// Everything is a template on the scalar type T (float or double): the
// constants are T(...) and sqrt_/fabs_ pick the function of T, so no float
// operation rounds a double.
#pragma once

#include <cuda_runtime.h>

namespace unified {

template <typename T>
__device__ __forceinline__ T kbig() {
  return T(1e30);
}
template <typename T>
__device__ __forceinline__ T keps() {
  return T(1e-12);
}
template <typename T>
__device__ __forceinline__ T ktilt() {
  return T(0.02);
}

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_(double x) { return fabs(x); }

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> mk(T x, T y, T z) {
  V3<T> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
template <typename T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
template <typename T>
__device__ __forceinline__ V3<T> scale(V3<T> a, T s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
template <typename T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
template <typename T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <typename T>
__device__ __forceinline__ V3<T> neg(V3<T> a) {
  return mk(-a.x, -a.y, -a.z);
}
template <typename T>
__device__ __forceinline__ V3<T> sel(bool c, V3<T> a, V3<T> b) {
  return c ? a : b;
}
template <typename T>
__device__ __forceinline__ T sq(T x) {
  return x * x;
}
template <typename T>
__device__ __forceinline__ T maxf(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T minf(T a, T b) {
  return a < b ? a : b;
}
template <typename T>
__device__ __forceinline__ T length(V3<T> a) {
  return sqrt_(maxf(dot(a, a), T(0)));
}
template <typename T>
__device__ __forceinline__ V3<T> normalize_or(V3<T> a, V3<T> fb) {
  const T l2 = dot(a, a);
  const T inv = T(1) / sqrt_(maxf(l2, T(1e-9)));
  return l2 > T(1e-9) ? scale(a, inv) : fb;
}
template <typename T>
__device__ __forceinline__ V3<T> normalize(V3<T> a) {
  const T l2 = dot(a, a);
  const T inv = l2 > T(1e-9) ? T(1) / sqrt_(maxf(l2, T(1e-9))) : T(0);
  return scale(a, inv);
}
// q = (x, y, z, w): v + 2w (qv x v) + qv x (2 qv x v)
template <typename T>
__device__ __forceinline__ V3<T> qrotate(const T q[4], V3<T> v) {
  const V3<T> qv = mk(q[0], q[1], q[2]);
  const V3<T> t = scale(cross(qv, v), T(2));
  return add(add(v, scale(t, q[3])), cross(qv, t));
}
template <typename T>
__device__ __forceinline__ V3<T> qrotate_inv(const T q[4], V3<T> v) {
  const T qc[4] = {-q[0], -q[1], -q[2], q[3]};
  return qrotate(qc, v);
}
template <typename T>
__device__ __forceinline__ void ortho_basis(V3<T> n, V3<T>& t1, V3<T>& t2) {
  const T sign = n.z >= T(0) ? T(1) : T(-1);
  const T a = T(-1) / (sign + n.z);
  const T b = n.x * n.y * a;
  t1 = mk(T(1) + sign * n.x * n.x * a, sign * b, -sign * n.x);
  t2 = mk(b, sign + n.y * n.y * a, -n.y);
}

// World space of an object-space vertex and of an object-space direction
// (collide_support_plain's _world).
template <typename T>
__device__ __forceinline__ V3<T> world_point(const T q[4], V3<T> pos,
                                             V3<T> v) {
  return add(qrotate(q, v), pos);
}
template <typename T>
__device__ __forceinline__ V3<T> world_dir(const T q[4], V3<T> v) {
  return qrotate(q, v);
}

// A feature-table lane group: 4 scalars, 16 bytes at float (float4), 32 at
// double (two 16-byte double2 halves; double4's alignment differs between
// CUDA versions). ldg reads through the read-only cache; ld_nc is a
// non-caching, non-mergeable load (the post-SAT passes reload a side's
// vertices instead of keeping both sides' in registers). The header's
// counts and class code are integers in these lanes: int32 bits in a float
// lane, int64 bits in a double lane, so each stays exact.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  using type = float4;
  static __device__ __forceinline__ float4 make(float x, float y, float z,
                                                float w) {
    return make_float4(x, y, z, w);
  }
  static __device__ __forceinline__ float4 ldg(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float4 ld_nc(const float4* p) {
    float4 r;
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                 : "l"(p));
    return r;
  }
  static __device__ __forceinline__ float from_int(int v) {
    return __int_as_float(v);
  }
  static __device__ __forceinline__ int to_int(float v) {
    return __float_as_int(v);
  }
};

struct __align__(16) double4x {
  double x, y, z, w;
};

template <>
struct Quad<double> {
  using type = double4x;
  static __device__ __forceinline__ double4x make(double x, double y,
                                                  double z, double w) {
    double4x r;
    r.x = x;
    r.y = y;
    r.z = z;
    r.w = w;
    return r;
  }
  static __device__ __forceinline__ double4x ldg(const double4x* p) {
    const double2* h = reinterpret_cast<const double2*>(p);
    const double2 a = __ldg(h), b = __ldg(h + 1);
    return make(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ double4x ld_nc(const double4x* p) {
    const double2* h = reinterpret_cast<const double2*>(p);
    double4x r;
    asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
                 : "=d"(r.x), "=d"(r.y)
                 : "l"(h));
    asm volatile("ld.global.nc.v2.f64 {%0, %1}, [%2];"
                 : "=d"(r.z), "=d"(r.w)
                 : "l"(h + 1));
    return r;
  }
  static __device__ __forceinline__ double from_int(int v) {
    return __longlong_as_double(static_cast<long long>(v));
  }
  static __device__ __forceinline__ int to_int(double v) {
    return static_cast<int>(__double_as_longlong(v));
  }
};

template <typename T>
using Q4 = typename Quad<T>::type;

}  // namespace unified
