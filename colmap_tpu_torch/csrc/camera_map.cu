// K5 camera_map: pixel <-> camera maps for a batch of points.
//
// Replaces colmap_tpu/sensor/models.py img_from_cam (l.367), cam_from_img
// (l.464-465) with _newton_undistort (l.325), and the unprojection inside
// cam_ray_from_img (l.557), for models 0-4.
//
// One thread per point, in two modes:
//   mode 0, project:   (u, v, w) -> (x, y), valid = w >= FLT_EPSILON
//                      (check_cheirality=True), with project<MODEL>;
//   mode 1, unproject: (x, y) -> (u, v) on the z = 1 plane with
//                      unproject<MODEL> (25 Newton steps), valid = 1.
// Parameters are one row for all points (param_stride 0) or one row per
// point (param_stride P).
//
// Bound on the card: at the mapper's sizes (a few hundred to a few thousand
// points per call) the launch itself; at large n, memory for project (20 B
// in, 9 B out a point) and the 25 Newton steps (~40 flops each, ~1000 a
// point) for unproject, both far below the card's rates. The design keeps
// one pass with every input read once and every output written once,
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
    project<MODEL, float>(p, u, v, w, x, y);
    out[2 * i] = x;
    out[2 * i + 1] = y;
    valid[i] = w >= FLT_EPSILON;
  } else {
    float u, v;
    unproject<MODEL>(p, in[2 * i], in[2 * i + 1], u, v);
    out[2 * i] = u;
    out[2 * i + 1] = v;
    valid[i] = 1;
  }
}

template <int MODEL>
int launch_camera_map(int mode, long long n, int stride, const float* params, const float* in,
                      float* out, unsigned char* valid, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kMapThreads - 1) / kMapThreads);
  camera_map_kernel<MODEL><<<blocks, kMapThreads, 0, stream>>>(mode, n, stride, params, in, out,
                                                               valid);
  return (int)cudaGetLastError();
}

}  // namespace ctt

extern "C" int camera_map_f32(int model_id, int mode, long long n, int param_stride,
                              const float* params, const float* in, float* out,
                              unsigned char* valid, void* stream) {
  using namespace ctt;
  cudaStream_t s = (cudaStream_t)stream;
  switch (model_id) {
    case 0: return launch_camera_map<0>(mode, n, param_stride, params, in, out, valid, s);
    case 1: return launch_camera_map<1>(mode, n, param_stride, params, in, out, valid, s);
    case 2: return launch_camera_map<2>(mode, n, param_stride, params, in, out, valid, s);
    case 3: return launch_camera_map<3>(mode, n, param_stride, params, in, out, valid, s);
    case 4: return launch_camera_map<4>(mode, n, param_stride, params, in, out, valid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
