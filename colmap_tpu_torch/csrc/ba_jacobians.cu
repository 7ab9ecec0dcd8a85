// K1 ba_obs_jacobians: per-observation residuals and Jacobian blocks.
//
// Replaces colmap_tpu/estimators/bundle_adjustment.py _obs_jacobians_packed
// (with make_residual_fn, _fetch_obs_params and the masks of
// _packed_obs_masks) and, in cost mode, compute_cost_packed.
//
// One thread per observation slot, of one camera model. A problem that mixes
// models (colmap_tpu's padded parameter rows with a trailing model-position
// column) takes one launch per model present, each over that model's slots
// (``slots``, a CSR order by model): the camera rows, masks and Jc are
// ``cam_stride`` wide (the widest model's P plus 1), the thread writes its
// model's P columns of Jc and zeros in the others. One thread gathers the slot's pose, camera row,
// point and measurement with plain indexed loads (the one-hot matmul fetches
// of the TPU version are not needed on this card), forms
// Xc = R(q) X + t and projects Xc with project<MODEL> on a forward-mode dual
// type carrying 3 + P directions, which gives d(proj)/d(Xc, params) exactly.
// The pose and point blocks follow by the chain rule:
//   dXc/domega = -[R X]x   (left-multiplied quaternion exponential at 0)
//   dXc/dt     = I,        dXc/dX = R.
// The epilogue applies the robust IRLS weight times obs_w, zeroes rows that
// are not finite, scales by sqrt(w) and multiplies in the variability masks.
// Cost mode writes no Jacobians: it reduces 1/2 sum rho(|r|^2) w per block in
// double and adds the block sums into one double with atomicAdd.
//
// Bound on the card: memory. Per slot it reads 3 ids, xy and w (24 B) and
// writes r, Jp, Jc, Jx ((20 + 2P) * 4 B, 112 B at P = 4); poses, cameras and
// points are small tables that stay in L2. The arithmetic (a few hundred
// flops per slot) is far below the card's float32 rate. The design keeps one
// pass over the slots with every output written once, coalesced by slot.
#include <cfloat>
#include <cuda_runtime.h>

#include "ba_common.cuh"
#include "camera_models.cuh"

namespace ctt {

template <int MODEL, bool COST>
__global__ void obs_kernel(long long n, int loss, float scale, int cam_stride,
                           const int* __restrict__ slots, const float* __restrict__ quat,
                           const float* __restrict__ tvec, const float* __restrict__ cam,
                           const float* __restrict__ points, const int* __restrict__ fids,
                           const int* __restrict__ cids, const int* __restrict__ pids,
                           const float* __restrict__ xy, const float* __restrict__ wobs,
                           const float* __restrict__ pose_mask,
                           const float* __restrict__ cam_mask,
                           const float* __restrict__ point_mask, float* __restrict__ r_out,
                           float* __restrict__ jp_out, float* __restrict__ jc_out,
                           float* __restrict__ jx_out, double* __restrict__ cost) {
  constexpr int P = ModelInfo<MODEL>::P;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  double my_cost = 0.0;
  if (tid < n) {
    const long long s = slots != nullptr ? (long long)slots[tid] : tid;
    const int f = fids[s], c = cids[s], p = pids[s];
    const float qw = quat[4 * f], qx = quat[4 * f + 1], qy = quat[4 * f + 2],
                qz = quat[4 * f + 3];
    const float X0 = points[3 * p], X1 = points[3 * p + 1], X2 = points[3 * p + 2];
    // a = R X by the same formula as quat_rotate: X + 2 (w (q x X) + q x (q x X)).
    const float c0 = qy * X2 - qz * X1, c1 = qz * X0 - qx * X2, c2 = qx * X1 - qy * X0;
    const float a0 = X0 + 2.f * (qw * c0 + (qy * c2 - qz * c1));
    const float a1 = X1 + 2.f * (qw * c1 + (qz * c0 - qx * c2));
    const float a2 = X2 + 2.f * (qw * c2 + (qx * c1 - qy * c0));
    const float u = a0 + tvec[3 * f], v = a1 + tvec[3 * f + 1], w = a2 + tvec[3 * f + 2];
    const float ox = xy[2 * s], oy = xy[2 * s + 1];
    const float ws = wobs[s];
    if constexpr (COST) {
      float prm[P];
#pragma unroll
      for (int j = 0; j < P; ++j) prm[j] = cam[(long long)c * cam_stride + j];
      float px, py;
      project<MODEL, float>(prm, u, v, w, px, py);
      const float rx = px - ox, ry = py - oy;
      float sq = rx * rx + ry * ry;
      if (!isfinite(sq)) sq = 0.f;
      my_cost = 0.5 * (double)(robust_cost(sq, loss, scale) * ws);
    } else {
      constexpr int ND = 3 + P;
      Dual<ND> U(u), V(v), W(w), prm[P];
      U.d[0] = 1.f;
      V.d[1] = 1.f;
      W.d[2] = 1.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        prm[j] = Dual<ND>(cam[(long long)c * cam_stride + j]);
        prm[j].d[3 + j] = 1.f;
      }
      Dual<ND> px, py;
      project<MODEL, Dual<ND>>(prm, U, V, W, px, py);
      const float rx = px.v - ox, ry = py.v - oy;
      // A = d(proj)/d(Xc) (2x3).
      const float A[2][3] = {{px.d[0], px.d[1], px.d[2]}, {py.d[0], py.d[1], py.d[2]}};
      // R = rotmat(q) (unit q).
      const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
      const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
      const float xy_ = qx * qy, xz = qx * qz, yz = qy * qz;
      const float R[3][3] = {{1.f - 2.f * (yy + zz), 2.f * (xy_ - wz), 2.f * (xz + wy)},
                             {2.f * (xy_ + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx)},
                             {2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)}};
      float Jp[2][6], Jc[2][P], Jx[2][3];
      bool finite = isfinite(rx) && isfinite(ry);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // dXc/domega = -[a]x: columns (0, -a2, a1), (a2, 0, -a0), (-a1, a0, 0).
        Jp[i][0] = -A[i][1] * a2 + A[i][2] * a1;
        Jp[i][1] = A[i][0] * a2 - A[i][2] * a0;
        Jp[i][2] = -A[i][0] * a1 + A[i][1] * a0;
        Jp[i][3] = A[i][0];
        Jp[i][4] = A[i][1];
        Jp[i][5] = A[i][2];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Jx[i][j] = A[i][0] * R[0][j] + A[i][1] * R[1][j] + A[i][2] * R[2][j];
          finite = finite && isfinite(Jx[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) finite = finite && isfinite(Jp[i][j]);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          Jc[i][j] = (i == 0 ? px : py).d[3 + j];
          finite = finite && isfinite(Jc[i][j]);
        }
      }
      const float wgt = finite ? robust_weight(rx * rx + ry * ry, loss, scale) * ws : 0.f;
      const float sw = finite ? sqrtf(wgt) : 0.f;
      r_out[2 * s] = finite ? rx * sw : 0.f;
      r_out[2 * s + 1] = finite ? ry * sw : 0.f;
      const float pm = point_mask[p] * sw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          jp_out[12 * s + 6 * i + j] = finite ? Jp[i][j] * sw * pose_mask[6 * f + j] : 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j)
          jc_out[2 * cam_stride * s + cam_stride * i + j] =
              finite ? Jc[i][j] * sw * cam_mask[(long long)cam_stride * c + j] : 0.f;
        for (int j = P; j < cam_stride; ++j) jc_out[2 * cam_stride * s + cam_stride * i + j] = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) jx_out[6 * s + 3 * i + j] = finite ? Jx[i][j] * pm : 0.f;
      }
    }
  }
  if constexpr (COST) {
    __shared__ double warp_sums[32];
    for (int off = 16; off > 0; off >>= 1) my_cost += __shfl_down_sync(0xffffffffu, my_cost, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = my_cost;
    __syncthreads();
    if (warp == 0) {
      double x = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) atomicAdd(cost, x);
    }
  }
}

template <int MODEL>
cudaError_t launch(int mode, int loss, float scale, long long n, int cam_stride, const int* slots,
                   const float* quat, const float* t, const float* cam, const float* points,
                   const int* fids,
                   const int* cids, const int* pids, const float* xy, const float* w,
                   const float* pose_mask, const float* cam_mask, const float* point_mask,
                   float* r, float* jp, float* jc, float* jx, double* cost,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (mode == 0) {
    obs_kernel<MODEL, false><<<blocks, kThreads, 0, stream>>>(
        n, loss, scale, cam_stride, slots, quat, t, cam, points, fids, cids, pids, xy, w,
        pose_mask, cam_mask, point_mask, r, jp, jc, jx, cost);
  } else {
    obs_kernel<MODEL, true><<<blocks, kThreads, 0, stream>>>(
        n, loss, scale, cam_stride, slots, quat, t, cam, points, fids, cids, pids, xy, w,
        pose_mask, cam_mask, point_mask, r, jp, jc, jx, cost);
  }
  return cudaGetLastError();
}

}  // namespace ctt

// mode 0: r, Jp, Jc, Jx; mode 1: add the cost into *cost (zeroed by the caller).
// loss: 0 trivial, 1 huber, 2 cauchy. P must be the model's parameter count;
// cam_stride (>= P) is the row width of cam, cam_mask and Jc. With slots
// not null the launch covers the n slots listed there, else slots 0..n-1.
extern "C" int ba_obs_jacobians_f32(int model_id, int mode, int loss, float loss_scale,
                                    long long n, int P, int cam_stride, const int* slots,
                                    const float* quat, const float* t,
                                    const float* cam, const float* points, const int* fids,
                                    const int* cids, const int* pids, const float* xy,
                                    const float* w, const float* pose_mask,
                                    const float* cam_mask, const float* point_mask, float* r,
                                    float* jp, float* jc, float* jx, double* cost,
                                    cudaStream_t stream) {
  if (n == 0) return (int)cudaGetLastError();
#define CTT_K1(M)                                                                          \
  case M:                                                                                  \
    if (P != ctt::ModelInfo<M>::P || cam_stride < P) return (int)cudaErrorInvalidValue;    \
    return (int)ctt::launch<M>(mode, loss, loss_scale, n, cam_stride, slots, quat, t, cam, \
                               points, fids, cids, pids, xy, w, pose_mask, cam_mask,       \
                               point_mask, r, jp, jc, jx, cost, stream);
  switch (model_id) {
    CTT_FOR_EACH_MODEL(CTT_K1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CTT_K1
}
