// Shared device code of the spectral Poisson kernels K41-K44.
//
// A sample x in [0, 1)^3 of an N^3 grid has p = x N - 0.5, base = floor(p),
// frac = p - base (colmap_tpu/mvs/meshing.py l.53-56), and eight corner
// voxels (dx, dy, dz) in the reference's loop order, corner c = 4 dx + 2 dy +
// dz, each clipped to [0, N - 1] with the weight (frac or 1 - frac) over the
// three axes times the sample's weight (l.60-69). Every float32 operation
// is rounded on its own (__fmul_rn and friends), as JAX's are: a fused
// multiply-add in p = x N - 0.5 would move samples across voxel borders.
#pragma once

#include <cuda_runtime.h>

namespace ctt {
namespace poisson {

constexpr int kThreads = 256;

__device__ __forceinline__ void sample_base(const float* __restrict__ x01, long long s, int N,
                                            int base[3], float frac[3]) {
  for (int a = 0; a < 3; ++a) {
    const float p = __fsub_rn(__fmul_rn(x01[3 * s + a], (float)N), 0.5f);
    const float b = floorf(p);
    frac[a] = __fsub_rn(p, b);
    base[a] = (int)b;
  }
}

// Flat voxel index (ix N + iy) N + iz and weight of corner c.
__device__ __forceinline__ void corner(const int base[3], const float frac[3], float weight, int N,
                                       int c, int* key, float* w) {
  const int d[3] = {c >> 2, (c >> 1) & 1, c & 1};
  float prod = 1.f;
  int idx[3];
  for (int a = 0; a < 3; ++a) {
    const float t = d[a] ? frac[a] : __fsub_rn(1.f, frac[a]);
    prod = a == 0 ? t : __fmul_rn(prod, t);
    idx[a] = min(max(base[a] + d[a], 0), N - 1);
  }
  *w = __fmul_rn(prod, weight);
  *key = (idx[0] * N + idx[1]) * N + idx[2];
}

// Sum of one double per thread over the block; every thread gets the sum.
// `scratch` holds 32 doubles. Fixed order: shuffle tree, then warp 0..W-1.
__device__ __forceinline__ double block_sum_d(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < nwarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

}  // namespace poisson
}  // namespace ctt
