// K19 pm_view_weights: per-view weights of the view selection, and the
// consistency filter.
//
// Replaces colmap_tpu/mvs/patch_match.py _view_weights (l.415) with
// _viewing_angles (l.349), _tri_prob (l.365), _inc_prob (l.375) and
// _resolution_prob (l.381): w_s = sel_prob_s * tri * inc * res, normalized
// over the views, uniform 1 / S where their total is <= 1e-6 (l.429). The
// resolution prior projects the window's four corners, each on the pixel's
// plane, into the source and compares the quad's shoelace area with the
// reference's (2R)^2.
//
// Its second mode replaces _consistency_filter (l.528): a view is
// consistent where its triangulation angle is at least the filter's, the
// plane faces it, its selection probability reaches the probability of
// filter_min_ncc (or, without view selection, its cost is at most
// 1 - filter_min_ncc) and, with source depths, its geometric error (K17's
// geom_error) is at most filter_geom_consistency_max_cost. Pixels with
// fewer than filter_min_num_consistent consistent views get depth and
// normal 0 and an empty mask.
//
// One thread per pixel walks the S views; the weights wait in registers
// (S <= 32) for their total. The viewing angles and the corners' footprint
// are taken in float64: the triangulation prior divides 1 - cos by
// 1 - cos(1 degree) = 1.5e-4, which float32's cosines leave with about four
// digits. Bound on the card: bytes. A pixel reads its plane (16 bytes) and
// S selection probabilities and writes S weights, against about 160
// operations a view.
#include <cuda_runtime.h>

#include "pm_common.cuh"

namespace ctt {
namespace pm {

// cos(triangulation angle) and cos(incident angle) of X (normal n) in view s.
__device__ __forceinline__ void angles64(const double* cams, int s, D3 X, double inv_norm_X, D3 n,
                                         double* cos_tri, double* cos_inc) {
  const double* V = view(cams, s);
  const D3 SX = dsub(dscale(dmtv(V, dt(V)), -1.0), X);  // C - X, C = -R^T t
  const double inv_norm_SX = 1.0 / sqrt(fmax(ddot(SX, SX), 1e-12));
  *cos_inc = ddot(SX, n) * inv_norm_SX;
  *cos_tri = -ddot(SX, X) * inv_norm_X * inv_norm_SX;
}

__global__ void __launch_bounds__(kThreads)
view_weights_kernel(int S, int H, int W, int R, double cos_min, double inv_2inc2,
                    const double* __restrict__ cams_g, const float* __restrict__ depth,
                    const float* __restrict__ normal, const float* __restrict__ sel_prob,
                    float* __restrict__ out) {
  __shared__ double cams[kCamDoubles];
  to_shared(cams, cams_g, 18 + kViewDoubles * S);
  __syncthreads();
  const size_t HW = (size_t)H * W;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int y = (int)(p / W), x = (int)(p % W);
  const D3 r0 = dray(cams, x, y);
  const double d = depth[p];
  const D3 n = d3(normal[3 * p], normal[3 * p + 1], normal[3 * p + 2]);
  const D3 X = dscale(r0, d);
  const double inv_norm_X = 1.0 / sqrt(fmax(ddot(X, X), 1e-12));
  // The window's corners (dy, dx) = (-R, -R), (R, -R), (R, R), (-R, R) on the plane.
  D3 corner[4];
  for (int c = 0; c < 4; ++c) {
    const double dy = (c == 0 || c == 3) ? -R : R;
    const double dx = c < 2 ? -R : R;
    const D3 r = dray(cams, x + dx, y + dy);
    corner[c] = dscale(r, d * ddot(n, r0) / safe_den(ddot(n, r)));
  }
  const double ref_area = 4.0 * R * R;
  float w[kMaxViews];
  float total = 0.f;
  for (int s = 0; s < S; ++s) {
    double cos_tri, cos_inc;
    angles64(cams, s, X, inv_norm_X, n, &cos_tri, &cos_inc);
    const double scaled = 1.0 - (1.0 - cos_tri) / (1.0 - cos_min);
    const double tri = cos_tri > cos_min ? fmin(fmax(1.0 - scaled * scaled, 0.0), 1.0) : 1.0;
    const double xi = 1.0 - fmax(0.0, cos_inc);
    const double inc = exp(-(xi * xi) * inv_2inc2);
    const double* V = view(cams, s);
    double px[4], py[4];
    for (int c = 0; c < 4; ++c) {
      const D3 ps = dmv(V + 12, dadd(dmv(V, corner[c]), dt(V)));
      const double z = safe_den(ps.z);
      px[c] = ps.x / z;
      py[c] = ps.y / z;
    }
    double area = 0.0;
    for (int c = 0; c < 4; ++c) area += px[c] * py[(c + 1) & 3] - px[(c + 1) & 3] * py[c];
    const double src_area = 0.5 * fabs(area);
    const double ratio = fmin(src_area / ref_area, ref_area / fmax(src_area, 1e-8));
    w[s] = (float)(sel_prob[s * HW + p] * tri * inc * fmin(fmax(ratio, 0.0), 1.0));
    total += w[s];
  }
  for (int s = 0; s < S; ++s)
    out[s * HW + p] = total > 1e-6f ? w[s] / fmaxf(total, 1e-6f) : 1.f / (float)S;
}

__global__ void __launch_bounds__(kThreads)
consistency_filter_kernel(int S, int H, int W, int view_selection, double cos_min,
                          float threshold, float geom_max, int min_num,
                          const double* __restrict__ cams_g, const float* __restrict__ src_depths,
                          const float* __restrict__ depth, const float* __restrict__ normal,
                          const float* __restrict__ cost_all, const float* __restrict__ sel_prob,
                          float* __restrict__ depth_f, float* __restrict__ normal_f,
                          unsigned char* __restrict__ mask) {
  __shared__ double cams[kCamDoubles];
  to_shared(cams, cams_g, 18 + kViewDoubles * S);
  __syncthreads();
  const size_t HW = (size_t)H * W;
  const size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const int y = (int)(p / W), x = (int)(p % W);
  const float d = depth[p];
  const float3 n = load3(normal, (int)p);
  const D3 X = dscale(dray(cams, x, y), d);
  const double inv_norm_X = 1.0 / sqrt(fmax(ddot(X, X), 1e-12));
  unsigned consistent = 0u;
  int count = 0;
  for (int s = 0; s < S; ++s) {
    double cos_tri, cos_inc;
    angles64(cams, s, X, inv_norm_X, d3(n.x, n.y, n.z), &cos_tri, &cos_inc);
    bool ok = cos_tri <= cos_min && cos_inc > 0.0;
    ok = ok && (view_selection ? sel_prob[s * HW + p] >= threshold
                               : cost_all[s * HW + p] <= threshold);
    if (ok && src_depths != nullptr)
      ok = geom_error(cams, src_depths + s * HW, H, W, s, y, x, d) <= geom_max;
    if (ok) {
      consistent |= 1u << s;
      ++count;
    }
  }
  const bool keep = count >= min_num;
  for (int s = 0; s < S; ++s) mask[s * HW + p] = keep && ((consistent >> s) & 1u);
  depth_f[p] = keep ? d : 0.f;
  store3(normal_f, (int)p, keep ? n : f3(0.f, 0.f, 0.f));
}

}  // namespace pm
}  // namespace ctt

extern "C" int pm_view_weights_f32(int S, int H, int W, int R, double cos_min, double inv_2inc2,
                                   const double* cams, const float* depth, const float* normal,
                                   const float* sel_prob, float* out, void* stream) {
  using namespace ctt::pm;
  const size_t n = (size_t)H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  view_weights_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      S, H, W, R, cos_min, inv_2inc2, cams, depth, normal, sel_prob, out);
  return (int)cudaGetLastError();
}

extern "C" int pm_consistency_filter_f32(int S, int H, int W, int view_selection, double cos_min,
                                         float threshold, float geom_max, int min_num,
                                         const double* cams, const float* src_depths,
                                         const float* depth, const float* normal,
                                         const float* cost_all, const float* sel_prob,
                                         float* depth_f, float* normal_f, unsigned char* mask,
                                         void* stream) {
  using namespace ctt::pm;
  const size_t n = (size_t)H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  consistency_filter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      S, H, W, view_selection, cos_min, threshold, geom_max, min_num, cams, src_depths, depth,
      normal, cost_all, sel_prob, depth_f, normal_f, mask);
  return (int)cudaGetLastError();
}
