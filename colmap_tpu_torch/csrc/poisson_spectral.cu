// K43 poisson_spectral: the screened spectral divide of the Poisson solve,
// in place on the rfftn output.
//
// Replaces colmap_tpu/mvs/meshing.py _poisson_indicator_jax l.95-106: chi_hat
// = div_hat / (lam - alpha), lam the eigenvalue of the 7-point Laplacian at
// the bin's frequencies and alpha = point_weight 1e-4. One thread a complex
// bin (i, j, k) of the (N, N, N/2 + 1) spectrum computes lam from its three
// indices with the reference's float32 arithmetic (fftfreq / rfftfreq as a
// float32, times 2, times float32 pi; 2 cos - 2 per axis, summed x, y, z)
// and divides the real and imaginary parts; no lam tensor is made. Threads
// walk the spectrum in its storage order (cuFFT's rfftn hands back a dense
// tensor with the last axis outermost), each finding its bin's indices
// from its place, so the loads and stores are coalesced. At the
// DC bin lam is 0 and the divide by -alpha is kept as the reference's: the
// constant it adds to chi is taken out by K44's iso shift.
//
// Bound on the card: bytes, 8 bytes read and written a bin, against three
// cosines (recomputed a bin).
#include <cuda_runtime.h>

#include "poisson_common.cuh"

namespace ctt {
namespace poisson {

__device__ __forceinline__ float eig(int fi, int N) {
  const float kPi = 3.14159265358979323846f;
  const float freq = (float)((double)fi / (double)N);
  const float k = __fmul_rn(__fmul_rn(freq, 2.f), kPi);
  return __fsub_rn(__fmul_rn(2.f, cosf(k)), 2.f);
}

__global__ void __launch_bounds__(kThreads)
spectral_kernel(int N, float alpha, int3 order, int3 size, float2* __restrict__ spec) {
  const long long total = (long long)size.x * size.y * size.z;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  // t is the bin's place in memory; order.x is the logical axis (0: i, 1:
  // j, 2: k) of the fastest storage axis, order.z of the slowest.
  int idx[3];
  idx[order.x] = (int)(t % size.x);
  idx[order.y] = (int)((t / size.x) % size.y);
  idx[order.z] = (int)(t / ((long long)size.x * size.y));
  const int i = idx[0], j = idx[1], k = idx[2];
  const int half = (N + 1) / 2;  // fftfreq: 0 .. half-1, then -(N - half) .. -1
  const float lam = __fadd_rn(__fadd_rn(eig(i < half ? i : i - N, N), eig(j < half ? j : j - N, N)),
                              eig(k, N));
  const float den = __fsub_rn(lam, alpha);
  float2 v = spec[t];
  v.x = __fdiv_rn(v.x, den);
  v.y = __fdiv_rn(v.y, den);
  spec[t] = v;
}

}  // namespace poisson
}  // namespace ctt

extern "C" int poisson_spectral_f32(int N, float alpha, int fast, int mid, int slow,
                                    void* spec, void* stream) {
  using namespace ctt::poisson;
  const int sizes[3] = {N, N, N / 2 + 1};
  const long long total = (long long)N * N * (N / 2 + 1);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  spectral_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      N, alpha, make_int3(fast, mid, slow), make_int3(sizes[fast], sizes[mid], sizes[slow]),
      (float2*)spec);
  return (int)cudaGetLastError();
}
