// K43 poisson_spectral: the screened spectral divide of the Poisson solve,
// in place on the rfftn output.
//
// Replaces colmap_tpu/mvs/meshing.py _poisson_indicator_jax l.95-106: chi_hat
// = div_hat / (lam - alpha), lam the eigenvalue of the 7-point Laplacian at
// the bin's frequencies and alpha = point_weight 1e-4. The eigenvalue is a
// sum of three per-axis terms, e(f) = 2 cos(2 pi f) - 2 with f the bin's
// fftfreq (axes i, j) or rfftfreq (axis k), taken in the reference's float32
// arithmetic (the frequency a float32, times 2, times float32 pi) and summed
// as (e_i + e_j) + e_k; at the DC bin lam is 0 and the divide by -alpha is
// kept as the reference's: the constant it adds to chi is taken out by K44's
// iso shift.
//
// Bound on the card: bytes, 8 bytes read and 8 written a bin. Design:
// - Only N + N/2 + 1 distinct terms exist (one table for i and j, one for
//   k). Each block computes both tables once into shared memory (6 KB at N
//   = 1024), with the same arithmetic a bin used to repeat three times.
// - The grid is persistent (2 blocks of 512 an SM) and a warp takes whole
//   rows of the fastest storage axis, the row number split into the two
//   slower axes with one 32-bit divide a row: no bin divides. The two
//   slower axes' terms are read once a row.
// - A lane moves two bins as one 16-byte load and store, and issues the
//   loads of up to 4 such pairs before it divides (64 KB in flight an SM).
//   A row starts on an odd bin where the row length (N/2 + 1, or any odd
//   N) or the base makes it so: that bin and a last odd one go alone as
//   8-byte accesses, so no vector access is misaligned.
// - Each bin keeps its two correctly rounded divides (no reciprocal), so
//   the output bits are those of the one-thread-a-bin kernel before it.
// Threads walk the spectrum in its storage order (cuFFT's rfftn hands back a
// dense tensor with the last axis outermost); `order` names the logical axis
// (0: i, 1: j, 2: k) of each storage axis, fastest first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "poisson_common.cuh"

namespace ctt {
namespace poisson {

constexpr int kSpectralThreads = 512;
constexpr int kSpectralBlocksPerSm = 2;
constexpr int kUnroll = 4;  // pairs a lane loads before it divides
constexpr int kMaxGrid = 1024;  // kernels/meshing.py MAX_GRID

__device__ __forceinline__ float eig(int fi, int N) {
  const float kPi = 3.14159265358979323846f;
  const float freq = (float)((double)fi / (double)N);
  const float k = __fmul_rn(__fmul_rn(freq, 2.f), kPi);
  return __fsub_rn(__fmul_rn(2.f, cosf(k)), 2.f);
}

__device__ __forceinline__ float2 divide(float2 v, float den) {
  return make_float2(__fdiv_rn(v.x, den), __fdiv_rn(v.y, den));
}

__global__ void __launch_bounds__(kSpectralThreads, kSpectralBlocksPerSm)
spectral_kernel(int N, float alpha, int3 order, int3 size, float2* __restrict__ spec) {
  __shared__ float tab[kMaxGrid + kMaxGrid / 2 + 1];
  const int nk = N / 2 + 1;
  const int half = (N + 1) / 2;  // fftfreq: 0 .. half-1, then -(N - half) .. -1
  for (int t = threadIdx.x; t < N + nk; t += blockDim.x)
    tab[t] = t < N ? eig(t < half ? t : t - N, N) : eig(t - N, N);
  __syncthreads();
  const float* tf = tab + (order.x == 2 ? N : 0);
  const float* tm = tab + (order.y == 2 ? N : 0);
  const float* ts = tab + (order.z == 2 ? N : 0);
  const bool fast_k = order.x == 2;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int rows = size.y * size.z;
  const unsigned base_odd = (unsigned)(reinterpret_cast<uintptr_t>(spec) >> 3) & 1u;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < rows; r += warps) {
    const int y = r % size.y, z = r / size.y;
    const float em = tm[y], es = ts[z];
    // lam = (e_i + e_j) + e_k. With k fastest, a = e_i + e_j is the row's;
    // otherwise a is the other of e_i, e_j and b = e_k (addition commutes).
    const float a = fast_k ? __fadd_rn(em, es) : (order.y == 2 ? es : em);
    const float b = order.y == 2 ? em : es;
    auto den = [&](int bin) {
      const float lam = fast_k ? __fadd_rn(a, tf[bin]) : __fadd_rn(__fadd_rn(tf[bin], a), b);
      return __fsub_rn(lam, alpha);
    };
    float2* row = spec + (long long)r * size.x;
    // An odd first bin (lead) and an odd last bin go alone; pairs between.
    const int lead = (int)((base_odd + (unsigned)r * (unsigned)size.x) & 1u);
    const int pairs = (size.x - lead) >> 1;
    const int tail = lead + 2 * pairs;
    if (lane == 0 && lead) row[0] = divide(row[0], den(0));
    if (lane == 1 && tail < size.x) row[tail] = divide(row[tail], den(tail));
    float4* p = reinterpret_cast<float4*>(row + lead);
    for (int q0 = lane; q0 < pairs; q0 += 32 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + 32 * u < pairs) v[u] = p[q0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u;
        if (q < pairs) {
          const int bin = lead + 2 * q;
          const float2 lo = divide(make_float2(v[u].x, v[u].y), den(bin));
          const float2 hi = divide(make_float2(v[u].z, v[u].w), den(bin + 1));
          p[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
  }
}

}  // namespace poisson
}  // namespace ctt

extern "C" int poisson_spectral_f32(int N, float alpha, int fast, int mid, int slow,
                                    void* spec, void* stream) {
  using namespace ctt::poisson;
  if (N < 1 || N > kMaxGrid) return (int)cudaErrorInvalidValue;
  const int sizes[3] = {N, N, N / 2 + 1};
  const int rows = sizes[mid] * sizes[slow];
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int warps_per_block = kSpectralThreads / 32;
  int blocks = (rows + warps_per_block - 1) / warps_per_block;
  if (blocks > sms * kSpectralBlocksPerSm) blocks = sms * kSpectralBlocksPerSm;
  spectral_kernel<<<blocks, kSpectralThreads, 0, (cudaStream_t)stream>>>(
      N, alpha, make_int3(fast, mid, slow), make_int3(sizes[fast], sizes[mid], sizes[slow]),
      (float2*)spec);
  return (int)cudaGetLastError();
}
