// K42 poisson_stencil: the periodic blur of the splatted grids and the
// divergence of the blurred normal field.
//
// Replaces colmap_tpu/mvs/meshing.py _poisson_indicator_jax l.78-92. Two
// entries on the (4, N, N, N) float32 grid of K41 (V's three channels,
// then W):
//   poisson_blur        (a) one periodic pass (f[i-1] + 2 f[i]) + f[i+1],
//                       times 1/4, along one axis (0: x, 1: y, 2: z) for
//                       the four channels in one launch, into a second
//                       grid; launched for x, y and z in turn, as the
//                       reference's roll loop over axes -3, -2, -1;
//   poisson_divergence  (b) ((V0[i+1] - V0[i-1]) + (V1[j+1] - V1[j-1]) +
//                       (V2[k+1] - V2[k-1])) / 2 with wrap-around, written
//                       into the (N, N, N) buffer that rfftn reads.
// Each float32 operation rounds as the reference's does, so the kernel
// and its plain version agree to the bit.
//
// Bound on the card: bytes. A blur pass reads and writes 4 N^3 floats, the
// divergence reads 3 N^3 and writes N^3; one thread an output, the
// neighbours along x and y coming from the L2 cache.
#include <cuda_runtime.h>

#include "poisson_common.cuh"

namespace ctt {
namespace poisson {

__global__ void __launch_bounds__(kThreads)
blur_kernel(long long total, int N, long long stride, const float* __restrict__ in,
            float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c = (int)((t / stride) % N);
  const long long prev = c == 0 ? t + (long long)(N - 1) * stride : t - stride;
  const long long next = c == N - 1 ? t - (long long)(N - 1) * stride : t + stride;
  out[t] = __fmul_rn(__fadd_rn(__fadd_rn(in[prev], __fmul_rn(2.f, in[t])), in[next]), 0.25f);
}

__global__ void __launch_bounds__(kThreads)
divergence_kernel(int N, const float* __restrict__ grid, float* __restrict__ div) {
  const long long NNN = (long long)N * N * N;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= NNN) return;
  const int k = (int)(t % N), j = (int)((t / N) % N), i = (int)(t / ((long long)N * N));
  const long long NN = (long long)N * N;
  const float* V0 = grid;
  const float* V1 = grid + NNN;
  const float* V2 = grid + 2 * NNN;
  const long long ip = (long long)((i + 1) % N) * NN + (long long)j * N + k;
  const long long im = (long long)((i + N - 1) % N) * NN + (long long)j * N + k;
  const long long jp = (long long)i * NN + (long long)((j + 1) % N) * N + k;
  const long long jm = (long long)i * NN + (long long)((j + N - 1) % N) * N + k;
  const long long kp = (long long)i * NN + (long long)j * N + (k + 1) % N;
  const long long km = (long long)i * NN + (long long)j * N + (k + N - 1) % N;
  const float a = __fsub_rn(V0[ip], V0[im]);
  const float b = __fsub_rn(V1[jp], V1[jm]);
  const float c = __fsub_rn(V2[kp], V2[km]);
  div[t] = __fmul_rn(__fadd_rn(__fadd_rn(a, b), c), 0.5f);
}

}  // namespace poisson
}  // namespace ctt

extern "C" int poisson_blur_f32(int N, int axis, const float* in, float* out, void* stream) {
  using namespace ctt::poisson;
  const long long total = 4LL * N * N * N;
  const long long stride = axis == 0 ? (long long)N * N : axis == 1 ? N : 1;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  blur_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(total, N, stride, in, out);
  return (int)cudaGetLastError();
}

extern "C" int poisson_divergence_f32(int N, const float* grid, float* div, void* stream) {
  using namespace ctt::poisson;
  const long long NNN = (long long)N * N * N;
  const unsigned blocks = (unsigned)((NNN + kThreads - 1) / kThreads);
  divergence_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(N, grid, div);
  return (int)cudaGetLastError();
}
