// K24 rig_ba_jacobians: per-observation residuals and Jacobian blocks of the
// rig bundle adjustment, and its cost.
//
// Replaces colmap_tpu/estimators/bundle_adjustment_rig.py _obs_jacobians
// (l.169-202) with _apply_masks (l.205-220) and, in cost mode, compute_cost
// (l.160): jax.jacfwd of the residual through
//   cam_from_world = sensor_from_rig o rig_from_world
// with each rotation updated by quat_exp(delta) * q.
//
// One thread per observation, in K1's pattern with the extra sensor block.
// It forms a = Rf X, X_rig = a + tf, b = Rs X_rig, Xc = b + ts, and projects
// Xc with project<MODEL> on a forward-mode dual type carrying 3 + P
// directions (d proj / d(Xc, params) exactly, A = d proj / d Xc). The
// blocks follow in closed form by the chain rule:
//   Js = [A (-[b]x) | A],  Jf = [A Rs (-[a]x) | A Rs],  Jx = A Rs Rf,
// Jc from the dual's parameter directions. The epilogue applies the robust
// IRLS weight times obs_w, zeroes rows where anything is not finite (a point
// behind the camera projects to inf and must not reach a sum as NaN),
// scales by sqrt(w) and multiplies in the masks (frame rotation and
// translation columns, sensor, camera parameters, point).
// Cost mode writes no Jacobians: each block reduces 1/2 rho(|r|^2) w of its
// observations in double in a fixed tree, and one block then adds the block
// sums in order, so the cost is the same in every run.
//
// Bound on the card: memory. Per observation it reads 4 ids, xy and w
// (28 B) and writes r, Jf, Js, Jc, Jx ((32 + 2P) * 4 B, 160 B at P = 4);
// poses, sensors, cameras and points are small tables that stay in L2. The
// arithmetic (a few hundred flops) is far below the card's float32 rate.
// The design makes one pass with every output written once, coalesced.
#include <cfloat>
#include <cuda_runtime.h>

#include "ba_common.cuh"
#include "camera_models.cuh"

namespace ctt {
namespace rigj {

constexpr int kThreads = 256;

// v' = v + 2 (w (q x v) + q x (q x v)), as quat_rotate.
__device__ __forceinline__ void qrot(const float* q, const float* v, float* out) {
  const float c0 = q[2] * v[2] - q[3] * v[1], c1 = q[3] * v[0] - q[1] * v[2],
              c2 = q[1] * v[1] - q[2] * v[0];
  out[0] = v[0] + 2.f * (q[0] * c0 + (q[2] * c2 - q[3] * c1));
  out[1] = v[1] + 2.f * (q[0] * c1 + (q[3] * c0 - q[1] * c2));
  out[2] = v[2] + 2.f * (q[0] * c2 + (q[1] * c1 - q[2] * c0));
}

__device__ __forceinline__ void rotmat(const float* q, float R[3][3]) {
  const float xx = q[1] * q[1], yy = q[2] * q[2], zz = q[3] * q[3];
  const float wx = q[0] * q[1], wy = q[0] * q[2], wz = q[0] * q[3];
  const float xy = q[1] * q[2], xz = q[1] * q[3], yz = q[2] * q[3];
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

// Row B (1x3) times -[a]x: the rotation columns of a left-multiplied update.
__device__ __forceinline__ void rot_cols(const float* B, const float* a, float* out) {
  out[0] = -B[1] * a[2] + B[2] * a[1];
  out[1] = B[0] * a[2] - B[2] * a[0];
  out[2] = -B[0] * a[1] + B[1] * a[0];
}

struct Inputs {
  const float *quat, *t, *squat, *st, *cam, *points;
  const int *fids, *sids, *cids, *pids;
  const float *xy, *w;
  const float *pose_mask, *sensor_mask, *cam_mask, *point_mask;
};

template <int MODEL, bool COST>
__global__ void __launch_bounds__(kThreads)
rig_obs_kernel(long long n, int loss, float scale, Inputs in, float* __restrict__ r_out,
               float* __restrict__ jf_out, float* __restrict__ js_out,
               float* __restrict__ jc_out, float* __restrict__ jx_out,
               double* __restrict__ partials) {
  constexpr int P = ModelInfo<MODEL>::P;
  const long long o = blockIdx.x * (long long)kThreads + threadIdx.x;
  double my_cost = 0.0;
  if (o < n) {
    const int f = in.fids[o], g = in.sids[o], c = in.cids[o], p = in.pids[o];
    const float qf[4] = {in.quat[4 * f], in.quat[4 * f + 1], in.quat[4 * f + 2],
                         in.quat[4 * f + 3]};
    const float qs[4] = {in.squat[4 * g], in.squat[4 * g + 1], in.squat[4 * g + 2],
                         in.squat[4 * g + 3]};
    const float X[3] = {in.points[3 * p], in.points[3 * p + 1], in.points[3 * p + 2]};
    float a[3], b[3];
    qrot(qf, X, a);
    const float Xr[3] = {a[0] + in.t[3 * f], a[1] + in.t[3 * f + 1], a[2] + in.t[3 * f + 2]};
    qrot(qs, Xr, b);
    const float u = b[0] + in.st[3 * g], v = b[1] + in.st[3 * g + 1], w = b[2] + in.st[3 * g + 2];
    const float ox = in.xy[2 * o], oy = in.xy[2 * o + 1];
    const float ws = in.w[o];
    if constexpr (COST) {
      float prm[P];
#pragma unroll
      for (int j = 0; j < P; ++j) prm[j] = in.cam[c * P + j];
      float px, py;
      project<MODEL, float>(prm, u, v, w, px, py);
      const float rx = px - ox, ry = py - oy;
      float sq = rx * rx + ry * ry;
      if (!isfinite(sq)) sq = 0.f;
      my_cost = 0.5 * (double)(robust_cost(sq, loss, scale) * ws);
    } else {
      constexpr int ND = 3 + P;
      Dual<ND> U(u), V(v), Wd(w), prm[P];
      U.d[0] = 1.f;
      V.d[1] = 1.f;
      Wd.d[2] = 1.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        prm[j] = Dual<ND>(in.cam[c * P + j]);
        prm[j].d[3 + j] = 1.f;
      }
      Dual<ND> px, py;
      project<MODEL, Dual<ND>>(prm, U, V, Wd, px, py);
      const float rx = px.v - ox, ry = py.v - oy;
      float Rs[3][3], Rf[3][3];
      rotmat(qs, Rs);
      rotmat(qf, Rf);
      float Jf[2][6], Js[2][6], Jc[2][P], Jx[2][3];
      bool finite = isfinite(rx) && isfinite(ry);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const Dual<ND>& pr = i == 0 ? px : py;
        const float A[3] = {pr.d[0], pr.d[1], pr.d[2]};
        float B[3];  // A Rs
#pragma unroll
        for (int j = 0; j < 3; ++j) B[j] = A[0] * Rs[0][j] + A[1] * Rs[1][j] + A[2] * Rs[2][j];
        rot_cols(A, b, Js[i]);
        rot_cols(B, a, Jf[i]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Js[i][3 + j] = A[j];
          Jf[i][3 + j] = B[j];
          Jx[i][j] = B[0] * Rf[0][j] + B[1] * Rf[1][j] + B[2] * Rf[2][j];
          finite = finite && isfinite(Jx[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) finite = finite && isfinite(Jf[i][j]) && isfinite(Js[i][j]);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          Jc[i][j] = pr.d[3 + j];
          finite = finite && isfinite(Jc[i][j]);
        }
      }
      const float wgt = finite ? robust_weight(rx * rx + ry * ry, loss, scale) * ws : 0.f;
      const float sw = finite ? sqrtf(wgt) : 0.f;
      r_out[2 * o] = finite ? rx * sw : 0.f;
      r_out[2 * o + 1] = finite ? ry * sw : 0.f;
      const float sm = in.sensor_mask[g] * sw, pm = in.point_mask[p] * sw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          jf_out[12 * o + 6 * i + j] = finite ? Jf[i][j] * sw * in.pose_mask[6 * f + j] : 0.f;
          js_out[12 * o + 6 * i + j] = finite ? Js[i][j] * sm : 0.f;
        }
#pragma unroll
        for (int j = 0; j < P; ++j)
          jc_out[2 * P * o + P * i + j] = finite ? Jc[i][j] * sw * in.cam_mask[P * c + j] : 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) jx_out[6 * o + 3 * i + j] = finite ? Jx[i][j] * pm : 0.f;
      }
    }
  }
  if constexpr (COST) {
    __shared__ double warp_sums[kThreads / 32];
    for (int off = 16; off > 0; off >>= 1) my_cost += __shfl_down_sync(0xffffffffu, my_cost, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = my_cost;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int k = 0; k < kThreads / 32; ++k) s += warp_sums[k];
      partials[blockIdx.x] = s;
    }
  }
}

// One block adds the block sums: a strided pass, then a fixed tree.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(long long m, const double* __restrict__ partials, double* __restrict__ out) {
  __shared__ double warp_sums[kThreads / 32];
  double s = 0.0;
  for (long long k = threadIdx.x; k < m; k += kThreads) s += partials[k];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) total += warp_sums[k];
    *out = total;
  }
}

template <int MODEL>
cudaError_t launch(int mode, int loss, float scale, long long n, const Inputs& in, float* r,
                   float* jf, float* js, float* jc, float* jx, double* partials, double* cost,
                   cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (mode == 0) {
    if (n > 0)
      rig_obs_kernel<MODEL, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
          n, loss, scale, in, r, jf, js, jc, jx, partials);
  } else {
    if (n > 0)
      rig_obs_kernel<MODEL, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
          n, loss, scale, in, r, jf, js, jc, jx, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sum_partials_kernel<<<1, kThreads, 0, stream>>>(blocks, partials, cost);
  }
  return cudaGetLastError();
}

}  // namespace rigj
}  // namespace ctt

// mode 0: r, Jf, Js, Jc, Jx (the masks are read); mode 1: the cost into
// *cost, with ceil(n / 256) block sums in partials. loss: 0 trivial, 1 huber,
// 2 cauchy. P must be the model's parameter count.
extern "C" int rig_ba_jacobians_f32(int model_id, int mode, int loss, float loss_scale,
                                    long long n, int P, const float* quat, const float* t,
                                    const float* squat, const float* st, const float* cam,
                                    const float* points, const int* fids, const int* sids,
                                    const int* cids, const int* pids, const float* xy,
                                    const float* w, const float* pose_mask,
                                    const float* sensor_mask, const float* cam_mask,
                                    const float* point_mask, float* r, float* jf, float* js,
                                    float* jc, float* jx, double* partials, double* cost,
                                    cudaStream_t stream) {
  const ctt::rigj::Inputs in{quat, t, squat, st, cam, points, fids, sids, cids, pids,
                             xy, w, pose_mask, sensor_mask, cam_mask, point_mask};
#define CTT_K24(M)                                                                         \
  case M:                                                                                  \
    if (P != ctt::ModelInfo<M>::P) return (int)cudaErrorInvalidValue;                      \
    return (int)ctt::rigj::launch<M>(mode, loss, loss_scale, n, in, r, jf, js, jc, jx,     \
                                     partials, cost, stream);
  switch (model_id) {
    CTT_K24(0)
    CTT_K24(1)
    CTT_K24(2)
    CTT_K24(3)
    CTT_K24(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CTT_K24
}
