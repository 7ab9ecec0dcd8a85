// K22 global_positioning: one IRLS round of global positioning.
//
// Replaces colmap_tpu/estimators/global_positioning.py _irls_solve
// (l.47-181): convex IRLS on the projected bearing residuals
// r = (I − d dᵀ)(X_p − c_i) with a Huber weight, the points eliminated by
// their 3x3 Schur blocks, a scale anchor (one observation's parallel
// component pinned to 1 with weight μ = anchor_weight · mean(obs_w)) and
// the anchor camera's centre held fixed. Three entries, float32:
//   (a) setup: per observation r, its Huber weight times obs_w (l.70-74),
//       w P r and the Huber cost term; per point over its track Hpp =
//       Σ w (I − d dᵀ) (+ μ a aᵀ at the anchor point), the relative ridge
//       eps_rel · tr / 3 (l.86-88), its inverse, g_x = −Σ w P r (− μ a
//       r_anchor) and y0 = Hpp⁻¹ g_x; per camera over its observations the
//       block Hcc = Σ w (I − d dᵀ), g_c = Σ w P r, the Jacobi diagonal
//       diag_c = Σ w (1 − d²) (l.135-139), the anchor terms at the anchor
//       camera, and the CG right-hand side b = (g_c − Hcp y0) · mask; the
//       cost Σ huber · obs_w;
//   (b) Schur matvec (Hcc − Hcp Hpp⁻¹ Hpc) x with x masked at the anchor
//       camera (l.96, 125-131): a point-side gather over each track, then a
//       camera-side gather over each camera's observations;
//   (c) back-substitution dx = Hpp⁻¹ (g_x − Hpc x) (l.167) and the update
//       of centres and points.
//
// Layout: observations stay in the caller's order; two CSR lists built
// once per solve on the card give each point's and each camera's
// observations. A thread walks one track (3-30 observations); a block of
// 256 threads walks one camera's list (thousands) and reduces in a fixed
// tree. No float atomics.
//
// Bound on the card: bytes. A matvec reads per observation its direction,
// weight and ids and two gathered 3-vectors (about 40 B) twice, once from
// each side; the arithmetic is a few dozen operations per observation.
#include <cuda_runtime.h>
#include <math.h>

#include "global_common.cuh"

namespace ctt {
namespace gp {

using gsfm::kBlock;

struct Obs {
  const float* dirs;      // (O, 3)
  const int* cam;         // (O,)
  const int* point;       // (O,)
  const float* obs_w;     // (O,)
  const int* pt_offsets;  // (P + 1,)
  const int* pt_obs;      // (O,) observation ids by point
  const int* cam_offsets; // (C + 1,)
  const int* cam_obs;     // (O,) observation ids by camera
};

struct Anchor {
  int cam, point;
  float ax, ay, az, mu;
};

__device__ __forceinline__ float3 ld3(const float* p, long long i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ void st3(float* p, long long i, float3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// (I − d dᵀ) v, as proj_apply: v − d (d · v).
__device__ __forceinline__ float3 proj(float3 d, float3 v) {
  const float s = d.x * v.x + d.y * v.y + d.z * v.z;
  return make_float3(v.x - d.x * s, v.y - d.y * s, v.z - d.z * s);
}

// μ a aᵀ v.
__device__ __forceinline__ float3 anchor_q(const Anchor& a, float3 v) {
  const float s = a.mu * (a.ax * v.x + a.ay * v.y + a.az * v.z);
  return make_float3(a.ax * s, a.ay * s, a.az * s);
}

__device__ __forceinline__ float3 mat3(const float* M, float3 v) {
  return make_float3(M[0] * v.x + M[1] * v.y + M[2] * v.z, M[3] * v.x + M[4] * v.y + M[5] * v.z,
                     M[6] * v.x + M[7] * v.y + M[8] * v.z);
}

__device__ __forceinline__ float3 masked(const float* xc, int c, int a_cam) {
  return c == a_cam ? make_float3(0.f, 0.f, 0.f) : ld3(xc, c);
}

// r_anchor = aᵀ (X[a.point] − c[a.cam]) − 1.
__device__ __forceinline__ float anchor_residual(const Anchor& a, const float* centers,
                                                 const float* points) {
  const float3 X = ld3(points, a.point), c = ld3(centers, a.cam);
  return a.ax * (X.x - c.x) + a.ay * (X.y - c.y) + a.az * (X.z - c.z) - 1.f;
}

// (a) per observation: w, w P r and the cost term.
__global__ void __launch_bounds__(kBlock)
obs_kernel(long long O, Obs ob, float huber, const float* __restrict__ centers,
           const float* __restrict__ points, float* __restrict__ w_out,
           float* __restrict__ wpr, float* __restrict__ cost_term) {
  const long long o = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (o >= O) return;
  const float3 d = ld3(ob.dirs, o);
  const float3 X = ld3(points, ob.point[o]), c = ld3(centers, ob.cam[o]);
  const float3 r = proj(d, make_float3(X.x - c.x, X.y - c.y, X.z - c.z));
  const float rn2 = r.x * r.x + r.y * r.y + r.z * r.z;
  const float a2 = huber * huber;
  const float w = (rn2 <= a2 ? 1.f : sqrtf(a2 / fmaxf(rn2, 1e-30f))) * ob.obs_w[o];
  const float3 pr = proj(d, r);
  w_out[o] = w;
  st3(wpr, o, make_float3(w * pr.x, w * pr.y, w * pr.z));
  cost_term[o] = (rn2 <= a2 ? rn2 : 2.f * huber * sqrtf(fmaxf(rn2, 0.f)) - a2) * ob.obs_w[o];
}

// (a) per point: Hpp⁻¹, g_x and y0 = Hpp⁻¹ g_x.
__global__ void __launch_bounds__(kBlock)
point_setup_kernel(int P, Obs ob, Anchor a, float eps_rel, const float* __restrict__ centers,
                   const float* __restrict__ points, const float* __restrict__ w,
                   const float* __restrict__ wpr, float* __restrict__ hpp_inv,
                   float* __restrict__ gx, float* __restrict__ y0) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= P) return;
  float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
  float3 g = make_float3(0.f, 0.f, 0.f);
  for (int k = ob.pt_offsets[p]; k < ob.pt_offsets[p + 1]; ++k) {
    const int o = ob.pt_obs[k];
    const float3 d = ld3(ob.dirs, o);
    const float wo = w[o];
    h00 += wo * (1.f - d.x * d.x);
    h01 -= wo * d.x * d.y;
    h02 -= wo * d.x * d.z;
    h11 += wo * (1.f - d.y * d.y);
    h12 -= wo * d.y * d.z;
    h22 += wo * (1.f - d.z * d.z);
    g.x -= wpr[3 * o];
    g.y -= wpr[3 * o + 1];
    g.z -= wpr[3 * o + 2];
  }
  if (p == a.point) {
    h00 += a.mu * a.ax * a.ax;
    h01 += a.mu * a.ax * a.ay;
    h02 += a.mu * a.ax * a.az;
    h11 += a.mu * a.ay * a.ay;
    h12 += a.mu * a.ay * a.az;
    h22 += a.mu * a.az * a.az;
    const float s = a.mu * anchor_residual(a, centers, points);
    g.x -= s * a.ax;
    g.y -= s * a.ay;
    g.z -= s * a.az;
  }
  const float ridge = eps_rel * (h00 + h11 + h22) / 3.f + 1e-30f;
  h00 += ridge;
  h11 += ridge;
  h22 += ridge;
  // Inverse by the adjugate (symmetric).
  const float c00 = h11 * h22 - h12 * h12, c01 = h02 * h12 - h01 * h22,
              c02 = h01 * h12 - h02 * h11, c11 = h00 * h22 - h02 * h02,
              c12 = h01 * h02 - h00 * h12, c22 = h00 * h11 - h01 * h01;
  const float inv_det = 1.f / (h00 * c00 + h01 * c01 + h02 * c02);
  float* M = hpp_inv + 9LL * p;
  M[0] = c00 * inv_det;
  M[1] = c01 * inv_det;
  M[2] = c02 * inv_det;
  M[3] = c01 * inv_det;
  M[4] = c11 * inv_det;
  M[5] = c12 * inv_det;
  M[6] = c02 * inv_det;
  M[7] = c12 * inv_det;
  M[8] = c22 * inv_det;
  st3(gx, p, g);
  st3(y0, p, mat3(M, g));
}

// (a) per camera, one block: Hcc, b, diag_c and the camera's cost share.
__global__ void __launch_bounds__(kBlock)
camera_setup_kernel(int C, Obs ob, Anchor a, const float* __restrict__ centers,
                    const float* __restrict__ points, const float* __restrict__ w,
                    const float* __restrict__ wpr, const float* __restrict__ cost_term,
                    const float* __restrict__ y0, float* __restrict__ hcc,
                    float* __restrict__ b, float* __restrict__ diag,
                    float* __restrict__ cost_cam) {
  __shared__ float scratch[13 * kBlock / 32];
  const int c = blockIdx.x;
  // h00 h01 h02 h11 h12 h22 | g_c | Hcp y0 | cost; diag_c is Hcc's diagonal.
  float v[13] = {0.f};
  for (int k = ob.cam_offsets[c] + threadIdx.x; k < ob.cam_offsets[c + 1]; k += kBlock) {
    const int o = ob.cam_obs[k];
    const float3 d = ld3(ob.dirs, o);
    const float wo = w[o];
    v[0] += wo * (1.f - d.x * d.x);
    v[1] -= wo * d.x * d.y;
    v[2] -= wo * d.x * d.z;
    v[3] += wo * (1.f - d.y * d.y);
    v[4] -= wo * d.y * d.z;
    v[5] += wo * (1.f - d.z * d.z);
    v[6] += wpr[3 * o];
    v[7] += wpr[3 * o + 1];
    v[8] += wpr[3 * o + 2];
    const float3 py = proj(d, ld3(y0, ob.point[o]));
    v[9] -= wo * py.x;
    v[10] -= wo * py.y;
    v[11] -= wo * py.z;
    v[12] += cost_term[o];
  }
  gsfm::block_sum<13>(v, scratch);
  if (threadIdx.x != 0) return;
  if (c == a.cam) {
    v[0] += a.mu * a.ax * a.ax;
    v[1] += a.mu * a.ax * a.ay;
    v[2] += a.mu * a.ax * a.az;
    v[3] += a.mu * a.ay * a.ay;
    v[4] += a.mu * a.ay * a.az;
    v[5] += a.mu * a.az * a.az;
    const float s = a.mu * anchor_residual(a, centers, points);
    v[6] += s * a.ax;
    v[7] += s * a.ay;
    v[8] += s * a.az;
    const float3 qy = anchor_q(a, ld3(y0, a.point));
    v[9] -= qy.x;
    v[10] -= qy.y;
    v[11] -= qy.z;
  }
  float* H = hcc + 9LL * c;
  H[0] = v[0];
  H[1] = v[1];
  H[2] = v[2];
  H[3] = v[1];
  H[4] = v[3];
  H[5] = v[4];
  H[6] = v[2];
  H[7] = v[4];
  H[8] = v[5];
  const float m = c == a.cam ? 0.f : 1.f;
  st3(b, c, make_float3((v[6] - v[9]) * m, (v[7] - v[10]) * m, (v[8] - v[11]) * m));
  st3(diag, c, make_float3(v[0], v[3], v[5]));
  cost_cam[c] = v[12];
}

__global__ void __launch_bounds__(kBlock)
cost_kernel(int C, const float* __restrict__ cost_cam, double* __restrict__ cost) {
  __shared__ double scratch[kBlock / 32];
  double v[1] = {0.0};
  for (int c = threadIdx.x; c < C; c += kBlock) v[0] += (double)cost_cam[c];
  gsfm::block_sum<1>(v, scratch);
  if (threadIdx.x == 0) *cost = v[0];
}

// H_pc x at point p: −Σ w P x[cam] (− μ a aᵀ x[a.cam] at the anchor point),
// x masked at the anchor camera.
__device__ __forceinline__ float3 hpc_at(int p, const Obs& ob, const Anchor& a,
                                         const float* __restrict__ w,
                                         const float* __restrict__ xc) {
  float3 h = make_float3(0.f, 0.f, 0.f);
  for (int k = ob.pt_offsets[p]; k < ob.pt_offsets[p + 1]; ++k) {
    const int o = ob.pt_obs[k];
    const float3 px = proj(ld3(ob.dirs, o), masked(xc, ob.cam[o], a.cam));
    h.x -= w[o] * px.x;
    h.y -= w[o] * px.y;
    h.z -= w[o] * px.z;
  }
  if (p == a.point) {
    const float3 q = anchor_q(a, masked(xc, a.cam, a.cam));
    h.x -= q.x;
    h.y -= q.y;
    h.z -= q.z;
  }
  return h;
}

// (b), point side: y = Hpp⁻¹ H_pc x.
__global__ void __launch_bounds__(kBlock)
matvec_point_kernel(int P, Obs ob, Anchor a, const float* __restrict__ w,
                    const float* __restrict__ hpp_inv, const float* __restrict__ xc,
                    float* __restrict__ y) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= P) return;
  st3(y, p, mat3(hpp_inv + 9LL * p, hpc_at(p, ob, a, w, xc)));
}

// (b), camera side, one block: (Hcc x − H_cp y) · mask.
__global__ void __launch_bounds__(kBlock)
matvec_camera_kernel(int C, Obs ob, Anchor a, const float* __restrict__ w,
                     const float* __restrict__ hcc, const float* __restrict__ xc,
                     const float* __restrict__ y, float* __restrict__ out) {
  __shared__ float scratch[3 * kBlock / 32];
  const int c = blockIdx.x;
  float v[3] = {0.f, 0.f, 0.f};  // H_cp y = −Σ w P y[point]
  for (int k = ob.cam_offsets[c] + threadIdx.x; k < ob.cam_offsets[c + 1]; k += kBlock) {
    const int o = ob.cam_obs[k];
    const float3 py = proj(ld3(ob.dirs, o), ld3(y, ob.point[o]));
    v[0] -= w[o] * py.x;
    v[1] -= w[o] * py.y;
    v[2] -= w[o] * py.z;
  }
  gsfm::block_sum<3>(v, scratch);
  if (threadIdx.x != 0) return;
  if (c == a.cam) {
    st3(out, c, make_float3(0.f, 0.f, 0.f));
    return;
  }
  const float3 h = mat3(hcc + 9LL * c, ld3(xc, c));
  st3(out, c, make_float3(h.x - v[0], h.y - v[1], h.z - v[2]));
}

// (c): points += Hpp⁻¹ (g_x − H_pc x); centres += x · mask.
__global__ void __launch_bounds__(kBlock)
back_substitute_kernel(int P, int C, Obs ob, Anchor a, const float* __restrict__ w,
                       const float* __restrict__ hpp_inv, const float* __restrict__ gx,
                       const float* __restrict__ xc, const float* __restrict__ centers,
                       const float* __restrict__ points, float* __restrict__ centers_out,
                       float* __restrict__ points_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < C) {
    const float3 c = ld3(centers, i), x = masked(xc, i, a.cam);
    st3(centers_out, i, make_float3(c.x + x.x, c.y + x.y, c.z + x.z));
  }
  if (i >= P) return;
  const float3 h = hpc_at(i, ob, a, w, xc), g = ld3(gx, i);
  const float3 dx = mat3(hpp_inv + 9LL * i, make_float3(g.x - h.x, g.y - h.y, g.z - h.z));
  const float3 X = ld3(points, i);
  st3(points_out, i, make_float3(X.x + dx.x, X.y + dx.y, X.z + dx.z));
}

}  // namespace gp
}  // namespace ctt

namespace {
unsigned blocks_for(long long n) { return (unsigned)((n + ctt::gsfm::kBlock - 1) / ctt::gsfm::kBlock); }

ctt::gp::Obs obs_of(const float* dirs, const int* cam, const int* point, const float* obs_w,
                    const int* pt_offsets, const int* pt_obs, const int* cam_offsets,
                    const int* cam_obs) {
  return ctt::gp::Obs{dirs, cam, point, obs_w, pt_offsets, pt_obs, cam_offsets, cam_obs};
}
}  // namespace

// Shared leading arguments: sizes, the observation arrays and their CSR
// lists, the anchor (camera, point, direction, μ).
#define GP_OBS_ARGS                                                                           \
  long long O, int C, int P, const float *dirs, const int *cam, const int *point,            \
      const float *obs_w, const int *pt_offsets, const int *pt_obs, const int *cam_offsets, \
      const int *cam_obs, int a_cam, int a_point, float ax, float ay, float az, float mu

// (a). w (O,), wpr (O, 3), cost_term (O,) and cost_cam (C,) are the
// wrapper's scratch; w is kept for (b) and (c).
extern "C" int gp_setup_f32(GP_OBS_ARGS, float huber, float eps_rel, const float* centers,
                            const float* points, float* w, float* wpr, float* cost_term,
                            float* cost_cam, float* hpp_inv, float* gx, float* y0, float* hcc,
                            float* b, float* diag, double* cost, void* stream) {
  using namespace ctt::gp;
  cudaStream_t s = (cudaStream_t)stream;
  const Obs ob = obs_of(dirs, cam, point, obs_w, pt_offsets, pt_obs, cam_offsets, cam_obs);
  const Anchor a{a_cam, a_point, ax, ay, az, mu};
  if (O > 0) obs_kernel<<<blocks_for(O), kBlock, 0, s>>>(O, ob, huber, centers, points, w, wpr,
                                                          cost_term);
  if (P > 0)
    point_setup_kernel<<<blocks_for(P), kBlock, 0, s>>>(P, ob, a, eps_rel, centers, points, w,
                                                        wpr, hpp_inv, gx, y0);
  if (C > 0)
    camera_setup_kernel<<<C, kBlock, 0, s>>>(C, ob, a, centers, points, w, wpr, cost_term, y0,
                                             hcc, b, diag, cost_cam);
  cost_kernel<<<1, kBlock, 0, s>>>(C, cost_cam, cost);
  return (int)cudaGetLastError();
}

// (b). y (P, 3) is the wrapper's scratch.
extern "C" int gp_schur_matvec_f32(GP_OBS_ARGS, const float* w, const float* hpp_inv,
                                   const float* hcc, const float* xc, float* y, float* out,
                                   void* stream) {
  using namespace ctt::gp;
  cudaStream_t s = (cudaStream_t)stream;
  const Obs ob = obs_of(dirs, cam, point, obs_w, pt_offsets, pt_obs, cam_offsets, cam_obs);
  const Anchor a{a_cam, a_point, ax, ay, az, mu};
  if (P > 0) matvec_point_kernel<<<blocks_for(P), kBlock, 0, s>>>(P, ob, a, w, hpp_inv, xc, y);
  if (C > 0) matvec_camera_kernel<<<C, kBlock, 0, s>>>(C, ob, a, w, hcc, xc, y, out);
  return (int)cudaGetLastError();
}

// (c).
extern "C" int gp_back_substitute_f32(GP_OBS_ARGS, const float* w, const float* hpp_inv,
                                      const float* gx, const float* xc, const float* centers,
                                      const float* points, float* centers_out,
                                      float* points_out, void* stream) {
  using namespace ctt::gp;
  const Obs ob = obs_of(dirs, cam, point, obs_w, pt_offsets, pt_obs, cam_offsets, cam_obs);
  const Anchor a{a_cam, a_point, ax, ay, az, mu};
  const int n = P > C ? P : C;
  if (n > 0)
    back_substitute_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
        P, C, ob, a, w, hpp_inv, gx, xc, centers, points, centers_out, points_out);
  return (int)cudaGetLastError();
}
