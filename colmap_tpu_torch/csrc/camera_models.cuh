// Camera models for the CUDA kernels, written once as templates.
//
// The 18 models of colmap_tpu_torch/sensor/models.py, with its formulas:
//
// project<MODEL>(params, u, v, w, x, y) maps a camera-frame point to pixel
// coordinates (img_from_cam; the values do not depend on the cheirality
// test) and returns img_from_cam's validity with check_cheirality=True. T is
// float or Dual<N>: on a forward-mode dual type with one direction per input
// (3 for the point, P for the parameters) the same code yields the exact
// derivatives d(x, y)/d(u, v, w, params), as jax.jacfwd / torch.func.jacfwd
// do. Branches follow the plain version's torch.where: the branch is chosen
// on the value and only the chosen branch's derivative is kept.
//
// unproject<MODEL>(params, x, y, u, v) is the inverse map to the z = 1 plane
// (cam_from_img) and returns its validity: principal point and focal
// lengths, then the closed forms where the plain version has them (FOV,
// the division models, EUCM, EQUIRECTANGULAR), else _newton_undistort's 25
// trust-region Newton steps on x + d(x) = x0, whose 2x2 Jacobian comes from
// distortion<MODEL> evaluated on Dual<2>, so the distortion is written once
// for both directions; the fisheye models then leave the theta plane
// (_normal_from_fisheye).
//
// ray<MODEL>(params, x, y, r) gives the unit bearing (cam_ray_from_img):
// EQUIRECTANGULAR's closed form, else the z = 1 lift normalized.
//
// ModelInfo<MODEL> gives each model's parameter count, the positions of its
// focal lengths, principal point and extra params, and its kind.
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

// a.v = f(x.v), a.d = f'(x.v) x.d
template <int N>
__device__ __forceinline__ Dual<N> chain(const Dual<N>& x, float fv, float dfdx) {
  Dual<N> r;
  r.v = fv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = dfdx * x.d[i];
  return r;
}

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
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
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
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) { return a + (-b); }
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) { return (-b) + a; }
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
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  const float v = a / b.v;
  return chain(b, v, -v / b.v);
}

// Elementary functions on float and on Dual<N>.
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float datan(float x) { return atanf(x); }
__device__ __forceinline__ float dtan(float x) { return tanf(x); }
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
// max(x, lo) as torch.clamp(min=lo): the derivative passes where x >= lo.
__device__ __forceinline__ float dclamp_min(float x, float lo) { return fmaxf(x, lo); }

template <int N>
__device__ __forceinline__ Dual<N> dsqrt(const Dual<N>& x) {
  const float s = sqrtf(x.v);
  return chain(x, s, 0.5f / s);
}
template <int N>
__device__ __forceinline__ Dual<N> datan(const Dual<N>& x) {
  return chain(x, atanf(x.v), 1.f / (1.f + x.v * x.v));
}
template <int N>
__device__ __forceinline__ Dual<N> dtan(const Dual<N>& x) {
  const float t = tanf(x.v);
  return chain(x, t, 1.f + t * t);
}
template <int N>
__device__ __forceinline__ Dual<N> datan2(const Dual<N>& y, const Dual<N>& x) {
  Dual<N> r;
  r.v = atan2f(y.v, x.v);
  const float inv = 1.f / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) * inv;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dclamp_min(const Dual<N>& x, float lo) {
  return x.v >= lo ? x : Dual<N>(lo);
}

template <typename T>
__device__ __forceinline__ T sel(bool c, const T& a, const T& b) {
  return c ? a : b;
}

// Model kinds: the generic perspective / fisheye path (distortion in the
// normalized or theta plane), and the models with their own projection.
enum ModelKind { kGeneric = 0, kFov = 1, kDivision = 2, kEucm = 3, kEquirect = 4 };

template <int MODEL>
struct ModelInfo;
// P: parameter count; FX, FY, CX, CY: positions; EXTRA: first extra param;
// FISHEYE: distortion in the equidistant theta plane.
#define CTT_MODEL(ID, P_, FX_, FY_, CX_, CY_, EXTRA_, FISHEYE_, KIND_)                   \
  template <>                                                                           \
  struct ModelInfo<ID> {                                                                \
    static constexpr int P = P_, FX = FX_, FY = FY_, CX = CX_, CY = CY_, EXTRA = EXTRA_; \
    static constexpr bool FISHEYE = FISHEYE_;                                           \
    static constexpr int KIND = KIND_;                                                  \
  };
CTT_MODEL(0, 3, 0, 0, 1, 2, 3, false, kGeneric)     // SIMPLE_PINHOLE
CTT_MODEL(1, 4, 0, 1, 2, 3, 4, false, kGeneric)     // PINHOLE
CTT_MODEL(2, 4, 0, 0, 1, 2, 3, false, kGeneric)     // SIMPLE_RADIAL: k
CTT_MODEL(3, 5, 0, 0, 1, 2, 3, false, kGeneric)     // RADIAL: k1, k2
CTT_MODEL(4, 8, 0, 1, 2, 3, 4, false, kGeneric)     // OPENCV: k1, k2, p1, p2
CTT_MODEL(5, 8, 0, 1, 2, 3, 4, true, kGeneric)      // OPENCV_FISHEYE: k1-k4
CTT_MODEL(6, 12, 0, 1, 2, 3, 4, false, kGeneric)    // FULL_OPENCV: k1, k2, p1, p2, k3-k6
CTT_MODEL(7, 5, 0, 1, 2, 3, 4, false, kFov)         // FOV: omega
CTT_MODEL(8, 4, 0, 0, 1, 2, 3, true, kGeneric)      // SIMPLE_RADIAL_FISHEYE: k
CTT_MODEL(9, 5, 0, 0, 1, 2, 3, true, kGeneric)      // RADIAL_FISHEYE: k1, k2
CTT_MODEL(10, 12, 0, 1, 2, 3, 4, true, kGeneric)    // THIN_PRISM_FISHEYE
CTT_MODEL(11, 16, 0, 1, 2, 3, 4, true, kGeneric)    // RAD_TAN_THIN_PRISM_FISHEYE
CTT_MODEL(12, 4, 0, 0, 1, 2, 3, false, kDivision)   // SIMPLE_DIVISION: k
CTT_MODEL(13, 5, 0, 1, 2, 3, 4, false, kDivision)   // DIVISION: k
CTT_MODEL(14, 3, 0, 0, 1, 2, 3, true, kGeneric)     // SIMPLE_FISHEYE
CTT_MODEL(15, 4, 0, 1, 2, 3, 4, true, kGeneric)     // FISHEYE
CTT_MODEL(16, 6, 0, 1, 2, 3, 4, false, kEucm)       // EUCM: alpha, beta
CTT_MODEL(17, 2, 0, 0, 0, 0, 2, false, kEquirect)   // EQUIRECTANGULAR: width, height
#undef CTT_MODEL

constexpr float kPiModel = 3.14159265358979f;

// Distortion in the normalized (or theta) plane: (u, v) -> (du, dv); e =
// extra params (models.py _dist_*).
template <int MODEL, typename T>
__device__ __forceinline__ void distortion(const T* e, const T& u, const T& v, T& du, T& dv) {
  if constexpr (MODEL == 2 || MODEL == 8) {  // SIMPLE_RADIAL(_FISHEYE): k
    T radial = e[0] * (u * u + v * v);
    du = u * radial;
    dv = v * radial;
  } else if constexpr (MODEL == 3 || MODEL == 9) {  // RADIAL(_FISHEYE): k1, k2
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
  } else if constexpr (MODEL == 5) {  // OPENCV_FISHEYE: k1 t^2 + ... + k4 t^8
    T t2 = u * u + v * v;
    T radial = t2 * (e[0] + t2 * (e[1] + t2 * (e[2] + t2 * e[3])));
    du = u * radial;
    dv = v * radial;
  } else if constexpr (MODEL == 6) {  // FULL_OPENCV: k1, k2, p1, p2, k3, k4, k5, k6
    T u2 = u * u, v2 = v * v, uv = u * v;
    T r2 = u2 + v2;
    T r4 = r2 * r2;
    T r6 = r4 * r2;
    T radial = (1.f + e[0] * r2 + e[1] * r4 + e[4] * r6) / (1.f + e[5] * r2 + e[6] * r4 + e[7] * r6) -
               1.f;
    du = u * radial + 2.f * e[2] * uv + e[3] * (r2 + 2.f * u2);
    dv = v * radial + 2.f * e[3] * uv + e[2] * (r2 + 2.f * v2);
  } else if constexpr (MODEL == 7) {  // FOV with the reference's Taylor fallbacks
    const T& omega = e[0];
    constexpr float eps = 1e-4f;
    T r2 = u * u + v * v;
    T omega2 = omega * omega;
    T tan_half = dtan(omega * 0.5f);
    T r = dsqrt(dclamp_min(r2, 1e-30f));
    const bool small_omega = val(omega2) < eps;
    T safe_omega = sel(small_omega, T(1.f), omega);
    T factor;
    if (small_omega) {
      factor = (omega2 * r2) / 3.f - omega2 / 12.f + 1.f;
    } else if (val(r2) < eps) {
      factor = (-2.f * tan_half * (4.f * r2 * tan_half * tan_half - 3.f)) / (3.f * safe_omega);
    } else {
      factor = datan(r * 2.f * tan_half) / (r * safe_omega);
    }
    du = u * (factor - 1.f);
    dv = v * (factor - 1.f);
  } else if constexpr (MODEL == 10) {  // THIN_PRISM_FISHEYE: k1, k2, p1, p2, k3, k4, sx1, sy1
    T u2 = u * u, v2 = v * v, uv = u * v;
    T r2 = u2 + v2;
    T r4 = r2 * r2;
    T radial = e[0] * r2 + e[1] * r4 + e[4] * r4 * r2 + e[5] * r4 * r4;
    du = u * radial + 2.f * e[2] * uv + e[3] * (r2 + 2.f * u2) + e[6] * r2;
    dv = v * radial + 2.f * e[3] * uv + e[2] * (r2 + 2.f * v2) + e[7] * r2;
  } else if constexpr (MODEL == 11) {  // RAD_TAN_THIN_PRISM_FISHEYE: 6 radial, 2 tang., 4 prism
    T t2 = u * u + v * v;
    T th_radial = T(1.f);
    T tp = T(1.f);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      tp = tp * t2;
      th_radial = th_radial + e[i] * tp;
    }
    T x = th_radial * u;
    T y = th_radial * v;
    T x2 = x * x, y2 = y * y, xy = x * y;
    T r2 = x2 + y2;
    T r4 = r2 * r2;
    T dx_tang = 2.f * e[7] * xy + e[6] * (r2 + 2.f * x2);
    T dy_tang = 2.f * e[6] * xy + e[7] * (r2 + 2.f * y2);
    T dx_tp = e[8] * r2 + e[9] * r4;
    T dy_tp = e[10] * r2 + e[11] * r4;
    du = x + dx_tang + dx_tp - u;
    dv = y + dy_tang + dy_tp - v;
  } else {  // SIMPLE_PINHOLE, PINHOLE, SIMPLE_FISHEYE, FISHEYE
    du = T(0.f);
    dv = T(0.f);
  }
}

// (u, v) -> (u, v) atan(r) / r, the equidistant fisheye forward map.
template <typename T>
__device__ __forceinline__ void fisheye_from_normal(T& u, T& v) {
  T r = dsqrt(u * u + v * v);
  if (val(r) > 1e-12f) {
    T scale = datan(r) / dclamp_min(r, 1e-30f);
    u = u * scale;
    v = v * scale;
  }
}

// Its inverse: (u, v) sin(theta) / (theta cos(theta)).
__device__ __forceinline__ void normal_from_fisheye(float& u, float& v) {
  const float theta = sqrtf(u * u + v * v);
  const float theta_cos = theta * cosf(theta);
  const float scale = theta_cos > 1e-12f ? sinf(theta) / theta_cos : 1.f;
  u *= scale;
  v *= scale;
}

// Pixel coordinates of camera-frame point (u, v, w); returns img_from_cam's
// validity with check_cheirality=True.
template <int MODEL, typename T>
__device__ __forceinline__ bool project(const T* p, const T& u, const T& v, const T& w, T& x,
                                        T& y) {
  using M = ModelInfo<MODEL>;
  constexpr float eps = FLT_EPSILON;
  if constexpr (M::KIND == kEquirect) {
    T horizontal = dsqrt(u * u + w * w);
    T theta = datan2(u, w);
    T phi = datan2(-v, horizontal);
    x = (theta / (2.f * kPiModel) + 0.5f) * p[0];
    y = (0.5f - phi / kPiModel) * p[1];
    return val(horizontal) + fabsf(val(v)) >= eps;
  } else if constexpr (M::KIND == kEucm) {
    const T& alpha = p[4];
    const T& beta = p[5];
    T rho2 = beta * (u * u + v * v) + w * w;
    T rho = dsqrt(dclamp_min(rho2, 0.f));
    T den = alpha * rho + (1.f - alpha) * w;
    T safe_den = sel(fabsf(val(den)) < eps, T(1.f), den);
    x = p[M::FX] * u / safe_den + p[M::CX];
    y = p[M::FY] * v / safe_den + p[M::CY];
    return val(w) >= eps && val(rho2) >= 0.f && val(den) >= eps;
  } else if constexpr (M::KIND == kDivision) {
    const T& k = p[M::EXTRA];
    T rho = dsqrt(u * u + v * v);
    T rho2k4 = 4.f * rho * rho * k;
    T disc_sq = w * w - rho2k4;
    T disc = dsqrt(dclamp_min(disc_sq, 0.f));
    // w + disc, for w < 0 as (disc^2 - w^2) / (disc - w): the same value
    // without float32's cancellation behind the camera (the division models
    // have no cheirality test, so those points count).
    const bool real = val(disc_sq) >= 0.f;
    T denom = val(w) >= 0.f ? w + disc : sel(real, -rho2k4, -(w * w)) / (disc - w);
    const bool small = fabsf(val(denom)) < eps;
    T r = 2.f / sel(small, T(1.f), denom);
    x = p[M::FX] * r * u + p[M::CX];
    y = p[M::FY] * r * v + p[M::CY];
    return val(disc_sq) >= 0.f && !small;
  } else {  // the generic perspective / fisheye path (FOV included)
    const T sw = fabsf(val(w)) < eps ? T(1.f) : w;
    T un = u / sw, vn = v / sw;
    if constexpr (M::FISHEYE) fisheye_from_normal(un, vn);
    T du, dv;
    distortion<MODEL, T>(p + M::EXTRA, un, vn, du, dv);
    x = p[M::FX] * (un + du) + p[M::CX];
    y = p[M::FY] * (vn + dv) + p[M::CY];
    return val(w) >= eps;
  }
}

// _newton_undistort: 25 trust-region Newton steps on x + d(x) = (u0, v0).
template <int MODEL>
__device__ __forceinline__ void newton_undistort(const float* e_in, float u0, float v0, float& u,
                                                 float& v) {
  constexpr int NE = ModelInfo<MODEL>::P - ModelInfo<MODEL>::EXTRA;
  Dual<2> e[NE];
  for (int i = 0; i < NE; ++i) e[i] = Dual<2>(e_in[i]);
  u = u0;
  v = v0;
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

// Pixel (x, y) -> (u, v) on the z = 1 plane; returns cam_from_img's validity.
template <int MODEL>
__device__ __forceinline__ bool unproject(const float* p, float x, float y, float& u, float& v) {
  using M = ModelInfo<MODEL>;
  constexpr float eps = FLT_EPSILON;
  if constexpr (M::KIND == kEquirect) {
    const float theta = 2.f * kPiModel * (x / p[0] - 0.5f);
    const float phi = kPiModel * (0.5f - y / p[1]);
    const float cos_phi = cosf(phi);
    const float rx = cos_phi * sinf(theta), ry = -sinf(phi), rz = cos_phi * cosf(theta);
    const float safe_rz = fabsf(rz) < eps ? 1.f : rz;
    u = rx / safe_rz;
    v = ry / safe_rz;
    return rz > eps;
  } else {
    const float uu = (x - p[M::CX]) / p[M::FX];
    const float vv = (y - p[M::CY]) / p[M::FY];
    if constexpr (M::KIND == kEucm) {
      const float alpha = p[4], beta = p[5];
      const float r2 = uu * uu + vv * vv;
      const float gamma = 1.f - alpha;
      const float radicand = 1.f - (alpha - gamma) * beta * r2;
      const float helper_den = alpha * sqrtf(fmaxf(radicand, 0.f)) + gamma;
      const float helper = (1.f - alpha * alpha * beta * r2) / (helper_den < eps ? 1.f : helper_den);
      const float safe = fabsf(helper) < eps ? 1.f : helper;
      u = uu / safe;
      v = vv / safe;
      return radicand >= 0.f && helper_den >= eps && helper >= eps;
    } else if constexpr (M::KIND == kDivision) {
      const float denom = 1.f + p[M::EXTRA] * (uu * uu + vv * vv);
      const bool ok = fabsf(denom) >= eps;
      u = uu / (ok ? denom : 1.f);
      v = vv / (ok ? denom : 1.f);
      return ok;
    } else if constexpr (M::KIND == kFov) {  // _undist_fov's closed form
      const float omega = p[M::EXTRA];
      constexpr float feps = 1e-4f;
      const float r2 = uu * uu + vv * vv;
      const float omega2 = omega * omega;
      const float tan_half = tanf(omega * 0.5f);
      const float r = sqrtf(fmaxf(r2, 1e-30f));
      const float safe_tan = fabsf(tan_half) < 1e-30f ? 1.f : tan_half;
      float factor;
      if (omega2 < feps) {
        factor = (omega2 * r2) / 3.f - omega2 / 12.f + 1.f;
      } else if (r2 < feps) {
        factor = (omega * (omega2 * r2 + 3.f)) / (6.f * safe_tan);
      } else {
        factor = tanf(r * omega) / (r * 2.f * safe_tan);
      }
      u = uu * factor;
      v = vv * factor;
      return true;
    } else {
      u = uu;
      v = vv;
      if constexpr (M::P > M::EXTRA) newton_undistort<MODEL>(p + M::EXTRA, uu, vv, u, v);
      if constexpr (M::FISHEYE) normal_from_fisheye(u, v);
      return true;
    }
  }
}

// Pixel (x, y) -> unit bearing r; returns cam_ray_from_img's validity.
template <int MODEL>
__device__ __forceinline__ bool ray(const float* p, float x, float y, float* r) {
  if constexpr (ModelInfo<MODEL>::KIND == kEquirect) {
    const float theta = 2.f * kPiModel * (x / p[0] - 0.5f);
    const float phi = kPiModel * (0.5f - y / p[1]);
    const float cos_phi = cosf(phi);
    r[0] = cos_phi * sinf(theta);
    r[1] = -sinf(phi);
    r[2] = cos_phi * cosf(theta);
    return true;
  } else {
    float u, v;
    const bool ok = unproject<MODEL>(p, x, y, u, v);
    const float inv = rsqrtf(u * u + v * v + 1.f);
    r[0] = u * inv;
    r[1] = v * inv;
    r[2] = inv;
    return ok;
  }
}

// The C entries dispatch a runtime model id to the template instantiations
// with CTT_FOR_EACH_MODEL(CASE), CASE(M) expanding to `case M: ...`.
#define CTT_FOR_EACH_MODEL(CASE) \
  CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) \
  CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16) CASE(17)

}  // namespace ctt
