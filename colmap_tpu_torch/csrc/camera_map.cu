// K5 camera_map: pixel <-> camera maps for a batch of points.
//
// Replaces colmap_tpu/sensor/models.py img_from_cam (l.367), cam_from_img
// (l.465) with _newton_undistort (l.327) and cam_ray_from_img (l.557), for
// all 18 camera models (camera_models.cuh).
//
// One thread per point, in three modes:
//   mode 0, project:   (u, v, w) -> (x, y) with project<MODEL>, valid as
//                      img_from_cam with check_cheirality=True;
//   mode 1, unproject: (x, y) -> (u, v) on the z = 1 plane with
//                      unproject<MODEL> (closed forms, or 25 Newton steps),
//                      valid as cam_from_img;
//   mode 2, ray:       (x, y) -> the unit bearing (rx, ry, rz) with
//                      ray<MODEL> (EQUIRECTANGULAR's closed form, else the
//                      z = 1 lift normalized), valid as cam_ray_from_img.
// Parameters are one row for all points (param_stride 0) or one row per
// point (param_stride P).
//
// Bound on the card: at the mapper's sizes (a few hundred to a few thousand
// points per call) the launch itself; at large n, memory for project (20 B
// in, 9 B out a point) and ray on EQUIRECTANGULAR (8 B in, 13 B out), and
// the 25 Newton steps (~40 flops each, ~1000 a point; ~3000 for the 12- and
// 16-parameter models) for unproject, far below the card's rates. The design
// keeps one pass with every input read once and every output written once,
// coalesced by point.
#include <cfloat>
#include <cuda_runtime.h>

#include "camera_models.cuh"

namespace ctt {

constexpr int kMapThreads = 256;

template <int MODEL>
__global__ void camera_map_kernel(int mode, long long n, int param_stride,
                                  const float* __restrict__ params, const float* __restrict__ in,
                                  float* __restrict__ out, unsigned char* __restrict__ valid) {
  constexpr int P = ModelInfo<MODEL>::P;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float p[P];
  const float* pr = params + i * param_stride;
#pragma unroll
  for (int k = 0; k < P; ++k) p[k] = pr[k];
  if (mode == 0) {
    const float u = in[3 * i], v = in[3 * i + 1], w = in[3 * i + 2];
    float x, y;
    valid[i] = project<MODEL, float>(p, u, v, w, x, y);
    out[2 * i] = x;
    out[2 * i + 1] = y;
  } else if (mode == 1) {
    float u, v;
    valid[i] = unproject<MODEL>(p, in[2 * i], in[2 * i + 1], u, v);
    out[2 * i] = u;
    out[2 * i + 1] = v;
  } else {
    float r[3];
    valid[i] = ray<MODEL>(p, in[2 * i], in[2 * i + 1], r);
    out[3 * i] = r[0];
    out[3 * i + 1] = r[1];
    out[3 * i + 2] = r[2];
  }
}

template <int MODEL>
int launch_camera_map(int mode, long long n, int stride, const float* params, const float* in,
                      float* out, unsigned char* valid, cudaStream_t stream) {
  if (stride != 0 && stride != ModelInfo<MODEL>::P) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kMapThreads - 1) / kMapThreads);
  camera_map_kernel<MODEL><<<blocks, kMapThreads, 0, stream>>>(mode, n, stride, params, in, out,
                                                               valid);
  return (int)cudaGetLastError();
}

}  // namespace ctt

// mode 0 project (in (n, 3), out (n, 2)), 1 unproject (in (n, 2), out
// (n, 2)), 2 ray (in (n, 2), out (n, 3)).
extern "C" int camera_map_f32(int model_id, int mode, long long n, int param_stride,
                              const float* params, const float* in, float* out,
                              unsigned char* valid, void* stream) {
  using namespace ctt;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
#define CTT_K5(M) \
  case M: return launch_camera_map<M>(mode, n, param_stride, params, in, out, valid, s);
  switch (model_id) {
    CTT_FOR_EACH_MODEL(CTT_K5)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CTT_K5
}
