// Device functions shared by the PatchMatch kernels K17-K20
// (colmap_tpu/mvs/patch_match.py).
//
// The cameras of a problem come as one float64 vector, loaded into shared
// memory by every block: K_ref (9), K_ref^-1 (9), then per source view
// R (9), t (3), K (9), K^-1 (9), P = K R K_ref^-1 (9) and b = K t (3), with
// x_src = R x_ref + t. A pixel's ray is K_ref^-1 (x, y, 1) at integer pixel
// coordinates, as colmap_tpu's _pixel_rays. All views share the
// reference's H x W.
//
// photo_cost is _per_view_costs for one (pixel, view, plane): the
// (2R+1)^2 window taps walked in colmap_tpu's order, each tap's ray
// intersected with the plane, projected into the source and sampled
// bilinearly (_bilinear's clamps), six weighted moments kept in registers.
// The intersection and projection are one homography: the plane
// n . X = c with c = d (n . r_p) maps the reference pixel (x, y) to
// q = P (x, y, 1) + b (n . r) / c in the source, the projected point
// divided by the tap's depth along its ray, t = c / (n . r). At the window's
// centre (n . r) / c = 1 / d. The homography is set up once per (pixel,
// plane, view) in float64 about an integer origin near the centre's
// source pixel, so that a tap's float32 arithmetic carries only its
// offset from that origin: at f = 3840 px a source coordinate of 3000
// held in float32 is 2.4e-4 px coarse, the offset 1e-7 px. The moments are
// taken about the reference's centre pixel and the source's value near the
// centre tap: NCC does not change under a shift, and float32 keeps more
// digits of the variances. colmap_tpu streams the
// taps in chunks through lax.scan to bound HBM; here nothing of the window
// reaches memory. geom_error is _geom_consistency_cost for one (pixel,
// view), in float64.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ctt {
namespace pm {

constexpr int kMaxViews = 32;
constexpr int kMaxTaps = 256;
constexpr int kViewDoubles = 42;  // R (9), t (3), K (9), K^-1 (9), P (9), b (3)
constexpr int kCamDoubles = 18 + kViewDoubles * kMaxViews;
constexpr float kNoChange = 0.99999f;
constexpr float kChange = (float)(1.0 - 0.99999);
constexpr float kUniform = 0.5f;
constexpr int kThreads = 256;

__device__ __forceinline__ float3 f3(float x, float y, float z) { return make_float3(x, y, z); }
__device__ __forceinline__ float3 add(float3 a, float3 b) { return f3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ float3 scale(float3 a, float s) { return f3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(float3 a, float3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ const double* kref(const double* cams) { return cams; }
__device__ __forceinline__ const double* view(const double* cams, int s) {
  return cams + 18 + kViewDoubles * s;
}

// float64 vectors.
struct D3 {
  double x, y, z;
};
__device__ __forceinline__ D3 d3(double x, double y, double z) { return D3{x, y, z}; }
__device__ __forceinline__ D3 dadd(D3 a, D3 b) { return d3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ D3 dsub(D3 a, D3 b) { return d3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ D3 dscale(D3 a, double s) { return d3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ double ddot(D3 a, D3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ D3 d3f(float3 v) { return d3(v.x, v.y, v.z); }
// M v and M^T v for a row-major 3 x 3 M.
__device__ __forceinline__ D3 dmv(const double* M, D3 v) {
  return d3(M[0] * v.x + M[1] * v.y + M[2] * v.z, M[3] * v.x + M[4] * v.y + M[5] * v.z,
            M[6] * v.x + M[7] * v.y + M[8] * v.z);
}
__device__ __forceinline__ D3 dmtv(const double* M, D3 v) {
  return d3(M[0] * v.x + M[3] * v.y + M[6] * v.z, M[1] * v.x + M[4] * v.y + M[7] * v.z,
            M[2] * v.x + M[5] * v.y + M[8] * v.z);
}
// A view's translation, and a pixel's ray K_ref^-1 (x, y, 1).
__device__ __forceinline__ D3 dt(const double* V) { return d3(V[9], V[10], V[11]); }
__device__ __forceinline__ D3 dray(const double* cams, double x, double y) {
  return dmv(cams + 9, d3(x, y, 1.0));
}
// colmap_tpu's jnp.where(|z| < 1e-8, 1e-8, z).
__device__ __forceinline__ double safe_den(double z) { return fabs(z) < 1e-8 ? 1e-8 : z; }

// Depth along ray of the plane through d0 r0 with normal n (_plane_depth_at).
__device__ __forceinline__ float plane_depth(float d0, float3 n, D3 r0, D3 ray) {
  return (float)((double)d0 * ddot(d3f(n), r0) / safe_den(ddot(d3f(n), ray)));
}

__device__ __forceinline__ float3 load3(const float* a, int p) {
  return f3(a[3 * p], a[3 * p + 1], a[3 * p + 2]);
}
__device__ __forceinline__ void store3(float* a, int p, float3 v) {
  a[3 * p] = v.x;
  a[3 * p + 1] = v.y;
  a[3 * p + 2] = v.z;
}

// Copy n values into shared memory; every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void to_shared(T* dst, const T* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

struct Window {
  int R, step;
  float inv_2sc2;   // 1 / (2 sigma_color^2)
  const float* taps;  // spatial weights, in shared memory
};

// A plane (d, n) at pixel (x, y): with c = d (n . r_p), m = K_ref^-T n / c,
// so that (n . r) / c = m . (x', y', 1) for the ray r of pixel (x', y').
// At the pixel itself that is 1 / d; a tap adds dx m.x + dy m.y.
struct Plane {
  double inv_d, mx, my, c;
};

__device__ __forceinline__ Plane plane_at(const double* cams, int y, int x, float d, float3 n) {
  const D3 nd = d3f(n);
  const double c = (double)d * ddot(nd, dray(cams, x, y));
  const double ic = c != 0.0 ? 1.0 / c : 0.0;
  const D3 m = dscale(dmtv(cams + 9, nd), ic);  // K_ref^-T n / c
  return Plane{1.0 / (double)d, m.x, m.y, c};
}

// 1 - clipped NCC of the plane at pixel (y, x) in source view s, or 2 when
// under half of the window's weight lands in bounds.
//
// A tap (dx, dy) maps to q = q0 + dx g0 + dy g1 with q0 = P (x, y, 1) +
// b / d and g = P's column + b m (the projected point over t). The origin
// (u, v) is the centre's source pixel rounded; e = (q.x - u q.z, q.y - v
// q.z, q.z) then gives the tap's source pixel as (u, v) + (e.x, e.y) / e.z
// with small float32 offsets. The tap is in front of the source where
// t q.z > 0, t's sign that of (n . r) / c (of c where |n . r| < 1e-8, as
// colmap_tpu's safe denominator).
__device__ __forceinline__ float photo_cost(const double* cams, const Window& win,
                                            const float* __restrict__ ref,
                                            const float* __restrict__ src, int H, int W, int s,
                                            int y, int x, const Plane& pl) {
  const double* V = view(cams, s);
  const double* P = V + 30;
  const D3 b = d3(V[39], V[40], V[41]);
  const D3 q0 = dadd(dmv(P, d3(x, y, 1.0)), dscale(b, pl.inv_d));
  const D3 g0 = dadd(d3(P[0], P[3], P[6]), dscale(b, pl.mx));
  const D3 g1 = dadd(d3(P[1], P[4], P[7]), dscale(b, pl.my));
  double u = 0.0, v = 0.0;
  if (q0.z != 0.0) {
    u = fmin(fmax(rint(q0.x / q0.z), -16777216.0), 16777216.0);
    v = fmin(fmax(rint(q0.y / q0.z), -16777216.0), 16777216.0);
    if (u != u) u = 0.0;
    if (v != v) v = 0.0;
  }
  const float3 e0 = f3((float)(q0.x - u * q0.z), (float)(q0.y - v * q0.z), (float)q0.z);
  const float3 e1 = f3((float)(g0.x - u * g0.z), (float)(g0.y - v * g0.z), (float)g0.z);
  const float3 e2 = f3((float)(g1.x - u * g1.z), (float)(g1.y - v * g1.z), (float)g1.z);
  const int iu = (int)u, iv = (int)v;
  const float lo_x = (float)(-u), hi_x = (float)(W - 1 - u);
  const float lo_y = (float)(-v), hi_y = (float)(H - 1 - v);
  const float inv_d = (float)pl.inv_d, mx = (float)pl.mx, my = (float)pl.my;
  const float c = (float)pl.c;
  const float rc = ref[(size_t)y * W + x];
  float sc = rc;  // the source's moments about its value at the centre tap
  {
    const float iz = 1.f / e0.z;
    const float ox = e0.x * iz, oy = e0.y * iz;
    if (ox >= lo_x && ox <= hi_x && oy >= lo_y && oy <= hi_y)
      sc = src[(size_t)min(max(iv + (int)floorf(oy), 0), H - 2) * W +
               min(max(iu + (int)floorf(ox), 0), W - 2)];
  }
  float sw = 0.f, swr = 0.f, sws = 0.f, swrr = 0.f, swss = 0.f, swrs = 0.f, wsum = 0.f;
  int k = 0;
  for (int dy = -win.R; dy <= win.R; dy += win.step) {
    const int yy = min(max(y + dy, 0), H - 1);
    for (int dx = -win.R; dx <= win.R; dx += win.step, ++k) {
      const int xx = min(max(x + dx, 0), W - 1);
      const float rv = ref[(size_t)yy * W + xx] - rc;
      const float w = win.taps[k] * expf(-(rv * rv) * win.inv_2sc2);
      wsum += w;
      const float fdx = (float)dx, fdy = (float)dy;
      const float ez = e0.z + fdx * e1.z + fdy * e2.z;
      const float den = inv_d + fdx * mx + fdy * my;  // (n . r) / c
      const bool t_pos = fabsf(c * den) < 1e-8f ? c > 0.f : den > 0.f;
      if (ez == 0.f || (ez > 0.f) != t_pos) continue;
      const float iz = 1.f / ez;
      const float ox = (e0.x + fdx * e1.x + fdy * e2.x) * iz;
      const float oy = (e0.y + fdx * e1.y + fdy * e2.y) * iz;
      if (!(ox >= lo_x && ox <= hi_x && oy >= lo_y && oy <= hi_y)) continue;
      // _bilinear: corner clipped to [0, H-2] x [0, W-2], fractions to [0, 1].
      const int x0 = min(max(iu + (int)floorf(ox), 0), W - 2);
      const int y0 = min(max(iv + (int)floorf(oy), 0), H - 2);
      const float fx = fminf(fmaxf((float)(iu - x0) + ox, 0.f), 1.f);
      const float fy = fminf(fmaxf((float)(iv - y0) + oy, 0.f), 1.f);
      const float* r = src + (size_t)y0 * W + x0;
      const float sv = r[0] * (1.f - fy) * (1.f - fx) + r[1] * (1.f - fy) * fx +
                       r[W] * fy * (1.f - fx) + r[W + 1] * fy * fx - sc;
      sw += w;
      swr += w * rv;
      sws += w * sv;
      swrr += w * rv * rv;
      swss += w * sv * sv;
      swrs += w * rv * sv;
    }
  }
  const float sw_safe = sw + 1e-8f;
  const float mu_r = swr / sw_safe, mu_s = sws / sw_safe;
  const float var_r = fmaxf(swrr / sw_safe - mu_r * mu_r, 0.f);
  const float var_s = fmaxf(swss / sw_safe - mu_s * mu_s, 0.f);
  const float cov = swrs / sw_safe - mu_r * mu_s;
  const float ncc = cov / sqrtf(fmaxf(var_r * var_s, 1e-10f));
  return sw / (wsum + 1e-8f) > 0.5f ? 1.f - fminf(fmaxf(ncc, -1.f), 1.f) : 2.f;
}

// Forward-backward reprojection error of pixel (y, x) at depth d through
// source view s's depth map; +inf where the round trip leaves the image or
// a depth is not positive. In float64: at f = 3840 px the round trip's
// float32 rounding alone was 1e-3 px.
__device__ __forceinline__ float geom_error(const double* cams, const float* __restrict__ dmap,
                                            int H, int W, int s, int y, int x, float d) {
  const double* V = view(cams, s);
  const D3 ps = dmv(V + 12, dadd(dmv(V, dscale(dray(cams, x, y), d)), dt(V)));
  const double z = safe_den(ps.z);
  const double sx = ps.x / z, sy = ps.y / z;
  if (!(sx >= 0.0 && sx <= W - 1 && sy >= 0.0 && sy <= H - 1 && ps.z > 0.0)) return INFINITY;
  const int y0 = min(max((int)floor(sy), 0), H - 2);
  const int x0 = min(max((int)floor(sx), 0), W - 2);
  const double fy = fmin(fmax(sy - y0, 0.0), 1.0), fx = fmin(fmax(sx - x0, 0.0), 1.0);
  const float* m = dmap + (size_t)y0 * W + x0;
  const double ds = m[0] * (1.0 - fy) * (1.0 - fx) + m[1] * (1.0 - fy) * fx +
                    m[W] * fy * (1.0 - fx) + m[W + 1] * fy * fx;
  if (!(ds > 0.0)) return INFINITY;
  const D3 back = dmtv(V, dsub(dscale(dmv(V + 21, d3(sx, sy, 1.0)), ds), dt(V)));  // R^T (X - t)
  const D3 pb = dmv(kref(cams), back);
  if (!(pb.z > 0.0)) return INFINITY;
  const double ex = pb.x / pb.z - x, ey = pb.y / pb.z - y;
  return (float)sqrt(ex * ex + ey * ey);
}

struct Geom {
  const float* depths;  // (S, H, W) source depth maps, or null
  float weight, max_cost;
};

// The full per-view cost: photometric, plus the clamped geometric term.
__device__ __forceinline__ float view_cost(const double* cams, const Window& win, const Geom& g,
                                           const float* __restrict__ ref,
                                           const float* __restrict__ src, int H, int W, int s,
                                           int y, int x, float d, const Plane& pl) {
  const size_t HW = (size_t)H * W;
  float c = photo_cost(cams, win, ref, src + s * HW, H, W, s, y, x, pl);
  if (g.depths != nullptr)
    c += g.weight * fminf(geom_error(cams, g.depths + s * HW, H, W, s, y, x, d), g.max_cost);
  return c;
}

}  // namespace pm
}  // namespace ctt
