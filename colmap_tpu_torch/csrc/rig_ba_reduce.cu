// K25 rig_ba_reduce: one LM step's reductions of the rig bundle adjustment.
//
// Replaces colmap_tpu/estimators/bundle_adjustment_rig.py lm_step's
// gradients (l.350-353), _build_schur (l.238-252: the point blocks Hpp, their
// damped inverse _inv3x3_spd, the damping lam_f, lam_s, lam_c), the reduced
// right-hand side bf, bs, bc (l.356-361) and _pcg's Jacobi preconditioner
// diag_f/s/c (l.284-290). The one-hot segment sums of the JAX program become
// gathers over CSR lists (rig_common.cuh).
//
// Three kernels:
//   point     one thread per point walks its observations: Hpp = sum JxT Jx,
//             gx = -sum JxT r, diag(Hpp), (Hpp + diag(lam diag + 1e-12))^-1,
//             y = Hpp^-1 gx; a second pass writes q = r + Jx y per
//             observation;
//   chunk     one block per chunk of a camera-side row's observations:
//             -sum JT r, -sum JT q and sum J^2 over the row's block J,
//             reduced in a fixed tree;
//   finalize  one thread per row adds its chunks in order: g, b = g - sum
//             JT Jx y, diag, lam diag and the preconditioner
//             1 / (diag + lam diag) (0 where that is <= 1e-12).
// A row with no observations (a sensor held constant, an unused camera)
// has no chunk and gets zeros. lam is one float in device memory, which the
// rig LM loop's accept (K38) updates, so a captured CUDA graph of an LM
// iteration reads the current value at each replay.
//
// Bound on the card: memory. It reads r, Jx and the point ids once per
// observation on the point side, and each observation's three blocks (Jf,
// Js, Jc), r and q once on the camera side ((40 + 2P) * 4 B an
// observation in all), and writes q and the small tables. The design keeps
// every sum in registers and shared memory and writes each output once.
#include <cuda_runtime.h>

#include "ba_common.cuh"
#include "rig_common.cuh"

namespace ctt {
namespace rigba {

__global__ void __launch_bounds__(kBlock)
reduce_point_kernel(int N, const float* __restrict__ lam_p, const float* __restrict__ r, const float* __restrict__ jx,
                    Layout L, float* __restrict__ q, float* __restrict__ gx_out,
                    float* __restrict__ hinv_out, float* __restrict__ diag_out) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= N) return;
  const float lam = *lam_p;
  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
  const int beg = L.pt_offsets[p], end = L.pt_offsets[p + 1];
  for (int k = beg; k < end; ++k) {
    const long long o = L.pt_obs[k];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x0 = jx[6 * o + 3 * i], x1 = jx[6 * o + 3 * i + 1], x2 = jx[6 * o + 3 * i + 2];
      const float ri = r[2 * o + i];
      h[0] += x0 * x0; h[1] += x0 * x1; h[2] += x0 * x2;
      h[3] += x1 * x1; h[4] += x1 * x2; h[5] += x2 * x2;
      g[0] -= x0 * ri; g[1] -= x1 * ri; g[2] -= x2 * ri;
    }
  }
  float hi[9];
  inv3x3_sym(h[0] + lam * h[0] + 1e-12f, h[1], h[2], h[3] + lam * h[3] + 1e-12f, h[4],
             h[5] + lam * h[5] + 1e-12f, hi);
  const float y0 = hi[0] * g[0] + hi[1] * g[1] + hi[2] * g[2];
  const float y1 = hi[3] * g[0] + hi[4] * g[1] + hi[5] * g[2];
  const float y2 = hi[6] * g[0] + hi[7] * g[1] + hi[8] * g[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) gx_out[3LL * p + i] = g[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) hinv_out[9LL * p + i] = hi[i];
  diag_out[3LL * p] = h[0];
  diag_out[3LL * p + 1] = h[3];
  diag_out[3LL * p + 2] = h[5];
  for (int k = beg; k < end; ++k) {
    const long long o = L.pt_obs[k];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      q[2 * o + i] = r[2 * o + i] + jx[6 * o + 3 * i] * y0 + jx[6 * o + 3 * i + 1] * y1 +
                     jx[6 * o + 3 * i + 2] * y2;
  }
}

template <int KW>
__global__ void __launch_bounds__(kBlock)
reduce_chunk_kernel(int F, int G, int P, Jac J, const float* __restrict__ r,
                    const float* __restrict__ q, Layout L, float* __restrict__ partials) {
  __shared__ float scratch[3 * KW * kBlock / 32];
  const int k = blockIdx.x;
  const int row = L.chunk_row[k];
  float acc[3 * KW];  // -sum JT r | -sum JT q | sum J^2
#pragma unroll
  for (int j = 0; j < 3 * KW; ++j) acc[j] = 0.f;
  for (int e = L.chunk_start[k] + threadIdx.x; e < L.chunk_end[k]; e += kBlock) {
    const long long o = L.seg_obs[e];
    int width;
    const float* B = row_block(J, row, F, G, P, o, width);
    const float r0 = r[2 * o], r1 = r[2 * o + 1], q0 = q[2 * o], q1 = q[2 * o + 1];
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      if (j < width) {
        const float b0 = B[j], b1 = B[width + j];
        acc[j] -= b0 * r0 + b1 * r1;
        acc[KW + j] -= b0 * q0 + b1 * q1;
        acc[2 * KW + j] += b0 * b0 + b1 * b1;
      }
    }
  }
  chunk_sum<3 * KW>(acc, scratch, partials + 3LL * KW * k);
}

template <int KW>
__global__ void reduce_finalize_kernel(int R, const float* __restrict__ lam_p,
                                       const int* __restrict__ row_chunks,
                                       const float* __restrict__ partials, float* __restrict__ g,
                                       float* __restrict__ b, float* __restrict__ d,
                                       float* __restrict__ lam_d, float* __restrict__ precond) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const float lam = *lam_p;
  for (int j = 0; j < KW; ++j) {
    float sg = 0.f, sb = 0.f, sd = 0.f;
    for (int k = row_chunks[row]; k < row_chunks[row + 1]; ++k) {
      sg += partials[3LL * KW * k + j];
      sb += partials[3LL * KW * k + KW + j];
      sd += partials[3LL * KW * k + 2 * KW + j];
    }
    const int i = row * KW + j;
    const float ld = lam * sd;
    const float damped = sd + ld;
    g[i] = sg;
    b[i] = sb;
    d[i] = sd;
    lam_d[i] = ld;
    precond[i] = damped > 1e-12f ? 1.f / damped : 0.f;
  }
}

}  // namespace rigba
}  // namespace ctt

// Outputs in the order of colmap_tpu_torch.kernels.rig.RigReduction, the
// camera-side ones (R, W); q (O, 2) and partials (K, 3W) are scratch. W is
// kW or kWideW; lam one float in device memory.
extern "C" int rig_ba_reduce_f32(int N, int F, int G, int C, int P, int K, int W, const float* lam,
                                 const float* r, const float* jf, const float* js,
                                 const float* jc, const float* jx, const int* pt_offsets, const int* pt_obs, const int* seg_obs,
                                 const int* chunk_row, const int* chunk_start,
                                 const int* chunk_end, const int* row_chunks, float* q,
                                 float* partials, float* gx, float* hinv, float* diag_x,
                                 float* g, float* b, float* diag, float* lam_diag,
                                 float* precond, cudaStream_t stream) {
  using namespace ctt::rigba;
  const Layout L{pt_offsets, pt_obs, seg_obs, chunk_row, chunk_start, chunk_end, row_chunks};
  const Jac J{jf, js, jc, jx};
  if (N > 0)
    reduce_point_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, stream>>>(N, lam, r, jx, L, q, gx,
                                                                           hinv, diag_x);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (W != kW && W != kWideW) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    if (W == kW)
      reduce_chunk_kernel<kW><<<K, kBlock, 0, stream>>>(F, G, P, J, r, q, L, partials);
    else
      reduce_chunk_kernel<kWideW><<<K, kBlock, 0, stream>>>(F, G, P, J, r, q, L, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = F + G + C;
  if (R > 0) {
    const unsigned blocks = (unsigned)((R + 127) / 128);
    if (W == kW)
      reduce_finalize_kernel<kW><<<blocks, 128, 0, stream>>>(R, lam, row_chunks, partials, g, b,
                                                             diag, lam_diag, precond);
    else
      reduce_finalize_kernel<kWideW><<<blocks, 128, 0, stream>>>(R, lam, row_chunks, partials, g,
                                                                 b, diag, lam_diag, precond);
  }
  return (int)cudaGetLastError();
}
