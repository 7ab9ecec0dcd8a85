// K9 filter_points: the per-observation checks of point filtering.
//
// Replaces colmap_tpu/sfm/filtering.py _filter_kernel (l.24) for one camera
// model (ids 0-4).
//
// One warp per point, lane v for view slot v (V <= 32 slots):
//   - Xc = R(q) X + t (q as stored, colmap_tpu's quat_rotate), the depth
//     Xc.z, the projection through project<MODEL> (camera_models.cuh, the
//     formulas K1 and K5 use) and the error |proj - xy|; inf when the
//     projection fails the cheirality test (z >= FLT_EPSILON), 0 on
//     padding (l.44-46);
//   - the unit ray from the camera center -R(q̂)^T t to the point, and the
//     smallest |cos| between the rays of two distinct valid views by
//     shuffles over the warp and a warp min (1 when there is no such pair).
//
// Bound on the card: memory. Per slot it reads the pose, the camera row and
// the observation ((4 + 3 + P + 2) floats and a flag, 53 B at P = 4) and
// writes the error and the depth (8 B); the 32 x 32 cosines a point are
// shuffles in registers. The layout repeats each image's pose in every slot
// that sees it (as colmap_tpu's); an image-indexed table would read less and
// is later work.
#include <cfloat>
#include <cuda_runtime.h>

#include "camera_models.cuh"
#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kFilterWarps = 4;

__device__ __forceinline__ void quat_rotate3(const float* q, const float* v, float* out) {
  // v + 2 w (u x v) + 2 u x (u x v), u = q.xyz
  const float w = q[0], u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + 2.f * (w * uv[i] + uuv[i]);
}

template <int MODEL>
__global__ void filter_points_kernel(int p, int V, const float* __restrict__ quat,
                                     const float* __restrict__ tvec,
                                     const float* __restrict__ params,
                                     const float* __restrict__ xyz,
                                     const float* __restrict__ obs_xy,
                                     const unsigned char* __restrict__ valid,
                                     float* __restrict__ err_out, float* __restrict__ depth_out,
                                     float* __restrict__ min_cos) {
  constexpr int P = ModelInfo<MODEL>::P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int point = blockIdx.x * kFilterWarps + warp;
  if (point >= p) return;  // whole warps leave together
  const float X[3] = {xyz[point * 3], xyz[point * 3 + 1], xyz[point * 3 + 2]};
  const bool ok_slot = lane < V;
  const long long o = (long long)point * V + lane;
  const bool val = ok_slot && valid[o];
  float ray[3] = {0.f, 0.f, 0.f};
  if (ok_slot) {
    const float q[4] = {quat[o * 4], quat[o * 4 + 1], quat[o * 4 + 2], quat[o * 4 + 3]};
    const float t[3] = {tvec[o * 3], tvec[o * 3 + 1], tvec[o * 3 + 2]};
    float prm[P];
    for (int k = 0; k < P; ++k) prm[k] = params[o * P + k];
    float Xc[3];
    quat_rotate3(q, X, Xc);
    for (int i = 0; i < 3; ++i) Xc[i] += t[i];
    float x, y;
    project<MODEL, float>(prm, Xc[0], Xc[1], Xc[2], x, y);
    const float ex = x - obs_xy[o * 2], ey = y - obs_xy[o * 2 + 1];
    const bool cheiral = Xc[2] >= FLT_EPSILON;
    const float e = sqrtf(ex * ex + ey * ey);
    err_out[o] = val ? (cheiral ? e : INFINITY) : 0.f;
    depth_out[o] = Xc[2];
    // Camera center -R(q̂)^T t = -rotate(conj(q̂), t).
    const float qn = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), FLT_MIN);
    const float qc[4] = {q[0] / qn, -q[1] / qn, -q[2] / qn, -q[3] / qn};
    float c[3];
    quat_rotate3(qc, t, c);
    for (int i = 0; i < 3; ++i) ray[i] = X[i] + c[i];
    const float rn = fmaxf(sqrtf(ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2]), 1e-30f);
    for (int i = 0; i < 3; ++i) ray[i] /= rn;
  }
  float mc = 1.f;
  for (int w = 0; w < 32; ++w) {
    const float rx = __shfl_sync(kFull, ray[0], w);
    const float ry = __shfl_sync(kFull, ray[1], w);
    const float rz = __shfl_sync(kFull, ray[2], w);
    const bool vw = __shfl_sync(kFull, val, w);
    if (val && vw && w != lane) mc = fminf(mc, fabsf(ray[0] * rx + ray[1] * ry + ray[2] * rz));
  }
  for (int off = 16; off > 0; off >>= 1) mc = fminf(mc, __shfl_xor_sync(kFull, mc, off));
  if (lane == 0) min_cos[point] = mc;
}

template <int MODEL>
int launch_filter(int p, int V, const float* quat, const float* t, const float* params,
                  const float* xyz, const float* obs_xy, const unsigned char* valid, float* err,
                  float* depth, float* min_cos, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p + kFilterWarps - 1) / kFilterWarps);
  filter_points_kernel<MODEL><<<blocks, 32 * kFilterWarps, 0, stream>>>(
      p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos);
  return (int)cudaGetLastError();
}

}  // namespace ctt

extern "C" int filter_points_f32(int model_id, int p, int V, int num_params, const float* quat,
                                 const float* t, const float* params, const float* xyz,
                                 const float* obs_xy, const unsigned char* valid, float* err,
                                 float* depth, float* min_cos, void* stream) {
  using namespace ctt;
  cudaStream_t s = (cudaStream_t)stream;
  if (V > 32) return (int)cudaErrorInvalidValue;
  const int expected[5] = {ModelInfo<0>::P, ModelInfo<1>::P, ModelInfo<2>::P, ModelInfo<3>::P,
                           ModelInfo<4>::P};
  if (model_id < 0 || model_id > 4 || num_params != expected[model_id])
    return (int)cudaErrorInvalidValue;
  switch (model_id) {
    case 0: return launch_filter<0>(p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos, s);
    case 1: return launch_filter<1>(p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos, s);
    case 2: return launch_filter<2>(p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos, s);
    case 3: return launch_filter<3>(p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos, s);
    case 4: return launch_filter<4>(p, V, quat, t, params, xyz, obs_xy, valid, err, depth, min_cos, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
