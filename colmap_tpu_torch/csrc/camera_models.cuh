// Camera projection for the CUDA kernels, written once as a template.
//
// project<MODEL>(params, u, v, w, x, y) maps a camera-frame point to pixel
// coordinates with the formulas of colmap_tpu_torch/sensor/models.py
// (img_from_cam with check_cheirality=False). T is float or Dual<N>: on a
// forward-mode dual type with one direction per input (3 for the point,
// P for the parameters) the same code yields the exact derivatives
// d(x, y)/d(u, v, w, params), as jax.jacfwd / torch.func.jacfwd do.
//
// unproject<MODEL>(params, x, y, u, v) is the inverse map to the z = 1
// plane (cam_from_img): principal point and focal lengths, then, for models
// with distortion, _newton_undistort's 25 trust-region Newton steps on
// x + d(x) = x0, whose 2x2 Jacobian comes from distortion<MODEL> evaluated
// on Dual<2>, so the distortion is written once for both directions.
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

// Pixel (x, y) -> (u, v) on the z = 1 plane; no validity test (always
// valid for models 0-4).
template <int MODEL>
__device__ __forceinline__ void unproject(const float* p, float x, float y, float& u, float& v) {
  using M = ModelInfo<MODEL>;
  const float u0 = (x - p[M::CX]) / p[M::FX];
  const float v0 = (y - p[M::CY]) / p[M::FY];
  u = u0;
  v = v0;
  if constexpr (M::P > M::EXTRA) {
    constexpr int NE = M::P - M::EXTRA;
    Dual<2> e[NE];
    for (int i = 0; i < NE; ++i) e[i] = Dual<2>(p[M::EXTRA + i]);
    for (int it = 0; it < 25; ++it) {
      Dual<2> U(u), V(v), du, dv;
      U.d[0] = 1.f;
      V.d[1] = 1.f;
      distortion<MODEL, Dual<2>>(e, U, V, du, dv);
      const Dual<2> ru = U + du, rv = V + dv;
      const float a = ru.d[0], b = ru.d[1], c = rv.d[0], d = rv.d[1];
      const float e0 = ru.v - u0, e1 = rv.v - v0;
      const float det = a * d - b * c;
      const float inv_det = fabsf(det) > 1e-30f ? 1.f / det : 0.f;
      const float dx0 = inv_det * (d * e0 - b * e1);
      const float dx1 = inv_det * (-c * e0 + a * e1);
      // Trust region: the step is at most max(0.1 |x|, 0.1).
      const float step = sqrtf(dx0 * dx0 + dx1 * dx1);
      const float max_step = fmaxf(sqrtf(u * u + v * v) * 0.1f, 0.1f);
      const float scale = fminf(1.f, max_step / fmaxf(step, 1e-30f));
      u -= dx0 * scale;
      v -= dx1 * scale;
    }
  }
}

}  // namespace ctt
