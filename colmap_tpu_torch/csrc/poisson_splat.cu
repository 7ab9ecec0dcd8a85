// K41 poisson_splat: the trilinear splat of the oriented samples into the
// N^3 grids of the spectral Poisson solve.
//
// Replaces colmap_tpu/mvs/meshing.py _poisson_indicator_jax l.54-75: eight
// scatter-adds of w and n w into W (N^3) and V (3 x N^3). Two entries:
//   poisson_splat_corners  (a) one thread a (sample, corner): the corner's
//                          voxel and weight (poisson_common.cuh), in
//                          (sample, corner) order, so that a warp's stores
//                          are contiguous;
//   poisson_splat_sum      (b) after a stable sort of the 8P voxel keys (a
//                          library sort used only to order the
//                          contributions), one thread a sorted position:
//                          the first position of each voxel's run walks
//                          the run and writes the voxel's four sums, V's
//                          three channels and W, into the (4, N, N, N)
//                          grid that K42 blurs. Voxels without a
//                          contribution keep the wrapper's zeros.
// No float atomics: a run adds in float64 in (sample, corner) order, the
// sort being stable, and stores float32, so two runs agree to the bit. The
// products n w are float32, as the reference's normals.T * w.
//
// Bound on the card: bytes. (a) reads 16 bytes and writes 64 a sample; (b)
// reads the sorted keys, the permutation, the weights and the normals of
// 8P contributions and writes the 4 N^3 grid. The run walk makes a voxel
// with many contributions serial; the path's clouds put a few to a few
// hundred in a voxel.
#include <cuda_runtime.h>

#include "poisson_common.cuh"

namespace ctt {
namespace poisson {

__global__ void __launch_bounds__(kThreads)
splat_corners_kernel(long long P, int N, const float* __restrict__ x01,
                     const float* __restrict__ weights, int* __restrict__ keys,
                     float* __restrict__ w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 8 * P) return;
  const long long s = t >> 3;
  int base[3];
  float frac[3];
  sample_base(x01, s, N, base, frac);
  corner(base, frac, weights[s], N, (int)(t & 7), keys + t, w + t);
}

__global__ void __launch_bounds__(kThreads)
splat_sum_kernel(long long M, long long NNN, const int* __restrict__ keys_sorted,
                 const long long* __restrict__ perm, const float* __restrict__ w,
                 const float* __restrict__ normals, float* __restrict__ grid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int k = keys_sorted[i];
  if (i > 0 && keys_sorted[i - 1] == k) return;
  double v0 = 0.0, v1 = 0.0, v2 = 0.0, sw = 0.0;
  for (long long j = i; j < M && keys_sorted[j] == k; ++j) {
    const long long idx = perm[j];
    const long long s = idx >> 3;
    const float wv = w[idx];
    sw += (double)wv;
    v0 += (double)__fmul_rn(normals[3 * s], wv);
    v1 += (double)__fmul_rn(normals[3 * s + 1], wv);
    v2 += (double)__fmul_rn(normals[3 * s + 2], wv);
  }
  grid[k] = (float)v0;
  grid[NNN + k] = (float)v1;
  grid[2 * NNN + k] = (float)v2;
  grid[3 * NNN + k] = (float)sw;
}

}  // namespace poisson
}  // namespace ctt

extern "C" int poisson_splat_corners_f32(long long P, int N, const float* x01,
                                         const float* weights, int* keys, float* w,
                                         void* stream) {
  using namespace ctt::poisson;
  const unsigned blocks = (unsigned)((8 * P + kThreads - 1) / kThreads);
  if (blocks)
    splat_corners_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(P, N, x01, weights,
                                                                         keys, w);
  return (int)cudaGetLastError();
}

extern "C" int poisson_splat_sum_f32(long long M, int N, const int* keys_sorted,
                                     const long long* perm, const float* w,
                                     const float* normals, float* grid, void* stream) {
  using namespace ctt::poisson;
  const unsigned blocks = (unsigned)((M + kThreads - 1) / kThreads);
  const long long NNN = (long long)N * N * N;
  if (blocks)
    splat_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(M, NNN, keys_sorted, perm,
                                                                     w, normals, grid);
  return (int)cudaGetLastError();
}
