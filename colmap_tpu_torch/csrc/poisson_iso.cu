// K44 poisson_iso: the iso level of the indicator and its shift.
//
// Replaces colmap_tpu/mvs/meshing.py _poisson_indicator_jax l.110-126: iso =
// sum_s sum_c chi[corner] w / sum_s sum_c w over the samples' eight corners
// (K41's corners and weights, recomputed from the samples), then chi - iso.
// Two entries:
//   poisson_iso_level  (a) a grid-stride gather: each thread sums its
//                      samples' num and den in float64, then block sums
//                      (a fixed shuffle tree, then the warps in order), one
//                      partial a block; a second launch of one block sums
//                      the partials in block order and writes iso =
//                      num / max(den, 1e-12) to a 0-d device tensor. The
//                      grid's size depends on P alone, so two runs agree
//                      to the bit, and there are no atomics;
//   poisson_iso_shift  (b) chi -= iso in place, iso read from device memory,
//                      so nothing reaches the host between the splat and
//                      the surface extraction.
//
// Bound on the card: (a) bytes, 16 bytes a sample and 8 scattered float
// reads of chi (32 bytes) a sample; (b) bytes, N^3 floats read and written.
#include <cuda_runtime.h>

#include "poisson_common.cuh"

namespace ctt {
namespace poisson {

constexpr int kIsoMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
iso_partial_kernel(long long P, int N, const float* __restrict__ x01,
                   const float* __restrict__ weights, const float* __restrict__ chi,
                   double* __restrict__ partial) {
  __shared__ double scratch[32];
  double num = 0.0, den = 0.0;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < P;
       s += (long long)gridDim.x * blockDim.x) {
    int base[3];
    float frac[3];
    sample_base(x01, s, N, base, frac);
    const float wt = weights[s];
    for (int c = 0; c < 8; ++c) {
      int key;
      float w;
      corner(base, frac, wt, N, c, &key, &w);
      num += (double)chi[key] * (double)w;
      den += (double)w;
    }
  }
  num = block_sum_d(num, scratch);
  den = block_sum_d(den, scratch);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = num;
    partial[2 * blockIdx.x + 1] = den;
  }
}

__global__ void __launch_bounds__(kIsoMaxBlocks)
iso_final_kernel(int nblocks, const double* __restrict__ partial, float* __restrict__ iso) {
  __shared__ double scratch[32];
  double num = 0.0, den = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
    num += partial[2 * b];
    den += partial[2 * b + 1];
  }
  num = block_sum_d(num, scratch);
  den = block_sum_d(den, scratch);
  if (threadIdx.x == 0) iso[0] = (float)(num / fmax(den, 1e-12));
}

__global__ void __launch_bounds__(kThreads)
iso_shift_kernel(long long n, const float* __restrict__ iso, float* __restrict__ chi) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  chi[t] = __fsub_rn(chi[t], *iso);
}

}  // namespace poisson
}  // namespace ctt

// Blocks of the gather for P samples: the partials buffer holds 2 doubles a block.
extern "C" int poisson_iso_blocks(long long P) {
  using namespace ctt::poisson;
  const long long b = (P + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : b > kIsoMaxBlocks ? kIsoMaxBlocks : b);
}

extern "C" int poisson_iso_level_f32(long long P, int N, const float* x01, const float* weights,
                                     const float* chi, double* partial, float* iso,
                                     void* stream) {
  using namespace ctt::poisson;
  const int blocks = poisson_iso_blocks(P);
  iso_partial_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(P, N, x01, weights, chi,
                                                                      partial);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  iso_final_kernel<<<1, kIsoMaxBlocks, 0, (cudaStream_t)stream>>>(blocks, partial, iso);
  return (int)cudaGetLastError();
}

extern "C" int poisson_iso_shift_f32(long long n, const float* iso, float* chi, void* stream) {
  using namespace ctt::poisson;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  iso_shift_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(n, iso, chi);
  return (int)cudaGetLastError();
}
