// K26 rig_ba_matvec: the reduced-camera-system product of the rig bundle
// adjustment inside PCG, and the point back-substitution.
//
// Replaces colmap_tpu/estimators/bundle_adjustment_rig.py _schur_matvec
// (l.255-278, once per _pcg iteration) and lm_step's back-substitution of dx
// (l.364-370), on the three camera-side families (frames, sensors,
// cameras). Two modes, like K3's; x is the (R, W) camera-side vector:
//   u = Jf x_f + Js x_s + Jc x_c per observation (one thread each), then per
//   point (one thread walks its observations) w = sum JxT u and
//   mode 0 (matvec)    y = Hpp^-1 w, z = u - Jx y written over u, then per
//                      chunk of a camera-side row sum JT z in a fixed tree,
//                      and per row the chunks added in order plus
//                      lam diag * x: H_cc x - H_cp Hpp^-1 H_pc x + lam D x in
//                      one reduction (the JAX code takes two with the same
//                      sum);
//   mode 1 (back-sub)  dx = Hpp^-1 (gx - w) per point.
// No float atomics (rig_common.cuh): the product is the same in every run.
//
// Bound on the card: memory. A matvec reads each observation's blocks
// (Jf, Js, Jc, Jx: (30 + 2P) * 4 B) on the observation side, Jx and u on the
// point side and Jf, Js, Jc and z again on the camera side; it runs
// pcg_iterations times per LM step, so it is the rig kernel whose time
// matters most.
#include <cuda_runtime.h>

#include "rig_common.cuh"

namespace ctt {
namespace rigba {

struct Ids {
  const int *f, *s, *c, *p;
};

template <int KW>
__global__ void __launch_bounds__(kBlock)
apply_kernel(long long O, int F, int G, int P, Jac J, Ids ids, const float* __restrict__ x,
             float* __restrict__ u) {
  const long long o = blockIdx.x * (long long)kBlock + threadIdx.x;
  if (o >= O) return;
  const float* xf = x + (long long)KW * ids.f[o];
  const float* xs = x + (long long)KW * (F + ids.s[o]);
  const float* xc = x + (long long)KW * (F + G + ids.c[o]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += J.jf[12 * o + 6 * i + j] * xf[j] + J.js[12 * o + 6 * i + j] * xs[j];
    for (int j = 0; j < P; ++j) acc += J.jc[2LL * P * o + P * i + j] * xc[j];
    u[2 * o + i] = acc;
  }
}

__global__ void __launch_bounds__(kBlock)
point_kernel(int mode, int N, const float* __restrict__ jx, Layout L,
             const float* __restrict__ hinv, const float* __restrict__ gx,
             float* __restrict__ uz, float* __restrict__ dx) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= N) return;
  const int beg = L.pt_offsets[p], end = L.pt_offsets[p + 1];
  float w0 = 0.f, w1 = 0.f, w2 = 0.f;
  for (int k = beg; k < end; ++k) {
    const long long o = L.pt_obs[k];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ui = uz[2 * o + i];
      w0 += jx[6 * o + 3 * i] * ui;
      w1 += jx[6 * o + 3 * i + 1] * ui;
      w2 += jx[6 * o + 3 * i + 2] * ui;
    }
  }
  const float* h = hinv + 9LL * p;
  if (mode == 1) {
    const float e0 = gx[3LL * p] - w0, e1 = gx[3LL * p + 1] - w1, e2 = gx[3LL * p + 2] - w2;
    dx[3LL * p] = h[0] * e0 + h[1] * e1 + h[2] * e2;
    dx[3LL * p + 1] = h[3] * e0 + h[4] * e1 + h[5] * e2;
    dx[3LL * p + 2] = h[6] * e0 + h[7] * e1 + h[8] * e2;
    return;
  }
  const float y0 = h[0] * w0 + h[1] * w1 + h[2] * w2;
  const float y1 = h[3] * w0 + h[4] * w1 + h[5] * w2;
  const float y2 = h[6] * w0 + h[7] * w1 + h[8] * w2;
  for (int k = beg; k < end; ++k) {
    const long long o = L.pt_obs[k];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      uz[2 * o + i] -= jx[6 * o + 3 * i] * y0 + jx[6 * o + 3 * i + 1] * y1 +
                       jx[6 * o + 3 * i + 2] * y2;
  }
}

template <int KW>
__global__ void __launch_bounds__(kBlock)
chunk_kernel(int F, int G, int P, Jac J, const float* __restrict__ z, Layout L,
             float* __restrict__ partials) {
  __shared__ float scratch[KW * kBlock / 32];
  const int k = blockIdx.x;
  const int row = L.chunk_row[k];
  float acc[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) acc[j] = 0.f;
  for (int e = L.chunk_start[k] + threadIdx.x; e < L.chunk_end[k]; e += kBlock) {
    const long long o = L.seg_obs[e];
    int width;
    const float* B = row_block(J, row, F, G, P, o, width);
    const float z0 = z[2 * o], z1 = z[2 * o + 1];
#pragma unroll
    for (int j = 0; j < KW; ++j)
      if (j < width) acc[j] += B[j] * z0 + B[width + j] * z1;
  }
  chunk_sum<KW>(acc, scratch, partials + (long long)KW * k);
}

template <int KW>
__global__ void finalize_kernel(int R, const int* __restrict__ row_chunks,
                                const float* __restrict__ partials,
                                const float* __restrict__ lam_d, const float* __restrict__ x,
                                float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  for (int j = 0; j < KW; ++j) {
    float s = 0.f;
    for (int k = row_chunks[row]; k < row_chunks[row + 1]; ++k) s += partials[(long long)KW * k + j];
    const int i = row * KW + j;
    out[i] = s + lam_d[i] * x[i];
  }
}

}  // namespace rigba
}  // namespace ctt

// mode 0: out (R, W) = the reduced system's product with x (R, W; lam_diag
// read); mode 1: out (N, 3) = dx (gx read). uz (O, 2) and partials (K, W)
// are scratch. W is kW or kWideW.
template <int KW>
static int rig_ba_matvec_w(int mode, long long O, int N, int F, int G, int C, int P, int K,
                           const ctt::rigba::Jac& J, const ctt::rigba::Ids& ids,
                           const ctt::rigba::Layout& L, const float* hinv, const float* lam_diag,
                           const float* gx, const float* x, float* uz, float* partials,
                           float* out, cudaStream_t stream) {
  using namespace ctt::rigba;
  const int* row_chunks = L.row_chunks;
  if (O > 0)
    apply_kernel<KW><<<(unsigned)((O + kBlock - 1) / kBlock), kBlock, 0, stream>>>(O, F, G, P, J,
                                                                                 ids, x, uz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    point_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, stream>>>(mode, N, J.jx, L, hinv, gx, uz,
                                                                    out);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == 1) return (int)err;
  if (K > 0) chunk_kernel<KW><<<K, kBlock, 0, stream>>>(F, G, P, J, uz, L, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = F + G + C;
  if (R > 0)
    finalize_kernel<KW><<<(R + 127) / 128, 128, 0, stream>>>(R, row_chunks, partials, lam_diag, x,
                                                              out);
  return (int)cudaGetLastError();
}

extern "C" int rig_ba_matvec_f32(int mode, long long O, int N, int F, int G, int C, int P, int K,
                                 int W,
                                 const float* jf, const float* js, const float* jc,
                                 const float* jx, const int* fids, const int* sids,
                                 const int* cids, const int* pids, const int* pt_offsets,
                                 const int* pt_obs, const int* seg_obs, const int* chunk_row,
                                 const int* chunk_start, const int* chunk_end,
                                 const int* row_chunks, const float* hinv, const float* lam_diag,
                                 const float* gx, const float* x, float* uz, float* partials,
                                 float* out, cudaStream_t stream) {
  using namespace ctt::rigba;
  const Layout L{pt_offsets, pt_obs, seg_obs, chunk_row, chunk_start, chunk_end, row_chunks};
  const Jac J{jf, js, jc, jx};
  const Ids ids{fids, sids, cids, pids};
  if (W == kW)
    return rig_ba_matvec_w<kW>(mode, O, N, F, G, C, P, K, J, ids, L, hinv, lam_diag, gx, x, uz,
                               partials, out, stream);
  if (W == kWideW)
    return rig_ba_matvec_w<kWideW>(mode, O, N, F, G, C, P, K, J, ids, L, hinv, lam_diag, gx, x,
                                   uz, partials, out, stream);
  return (int)cudaErrorInvalidValue;
}
