// Camera projection for the CUDA kernels, written once as a template.
//
// project<MODEL>(params, u, v, w, x, y) maps a camera-frame point to pixel
// coordinates with the formulas of colmap_tpu_torch/sensor/models.py
// (img_from_cam with check_cheirality=False). T is float or Dual<N>: on a
// forward-mode dual type with one direction per input (3 for the point,
// P for the parameters) the same code yields the exact derivatives
// d(x, y)/d(u, v, w, params), as jax.jacfwd / torch.func.jacfwd do.
//
// Models implemented: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL,
// OPENCV (ids 0-4). ModelInfo<MODEL> gives each model's parameter count
// and the positions of its focal lengths, principal point and extra params.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace ctt {

template <int N>
struct Dual {
  float v;
  float d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.f;
  }
};

__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.v * b.d[i] + b.v * a.d[i];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  const float inv = 1.f / b.v;
  r.v = a.v * inv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v += b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) { return b + a; }
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) { return b * a; }

// Distortion in the normalized plane: (u, v) -> (du, dv); e = extra params.
template <int MODEL, typename T>
__device__ __forceinline__ void distortion(const T* e, const T& u, const T& v, T& du, T& dv) {
  if constexpr (MODEL == 2) {  // SIMPLE_RADIAL: k
    T radial = e[0] * (u * u + v * v);
    du = u * radial;
    dv = v * radial;
  } else if constexpr (MODEL == 3) {  // RADIAL: k1, k2
    T r2 = u * u + v * v;
    T radial = e[0] * r2 + e[1] * r2 * r2;
    du = u * radial;
    dv = v * radial;
  } else if constexpr (MODEL == 4) {  // OPENCV: k1, k2, p1, p2
    T u2 = u * u, v2 = v * v, uv = u * v;
    T r2 = u2 + v2;
    T radial = e[0] * r2 + e[1] * r2 * r2;
    du = u * radial + 2.f * e[2] * uv + e[3] * (r2 + 2.f * u2);
    dv = v * radial + 2.f * e[3] * uv + e[2] * (r2 + 2.f * v2);
  } else {  // SIMPLE_PINHOLE, PINHOLE
    du = T(0.f);
    dv = T(0.f);
  }
}

template <int MODEL>
struct ModelInfo;
template <> struct ModelInfo<0> { static constexpr int P = 3, FX = 0, FY = 0, CX = 1, CY = 2, EXTRA = 3; };
template <> struct ModelInfo<1> { static constexpr int P = 4, FX = 0, FY = 1, CX = 2, CY = 3, EXTRA = 4; };
template <> struct ModelInfo<2> { static constexpr int P = 4, FX = 0, FY = 0, CX = 1, CY = 2, EXTRA = 3; };
template <> struct ModelInfo<3> { static constexpr int P = 5, FX = 0, FY = 0, CX = 1, CY = 2, EXTRA = 3; };
template <> struct ModelInfo<4> { static constexpr int P = 8, FX = 0, FY = 1, CX = 2, CY = 3, EXTRA = 4; };

// Pixel coordinates of camera-frame point (u, v, w); no cheirality test.
template <int MODEL, typename T>
__device__ __forceinline__ void project(const T* p, const T& u, const T& v, const T& w, T& x, T& y) {
  using M = ModelInfo<MODEL>;
  const T sw = fabsf(val(w)) < FLT_EPSILON ? T(1.f) : w;
  const T un = u / sw, vn = v / sw;
  T du, dv;
  distortion<MODEL, T>(p + M::EXTRA, un, vn, du, dv);
  x = p[M::FX] * (un + du) + p[M::CX];
  y = p[M::FY] * (vn + dv) + p[M::CY];
}

}  // namespace ctt
