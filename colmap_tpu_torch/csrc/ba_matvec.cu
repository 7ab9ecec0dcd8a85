// K3 ba_schur_matvec: the reduced-camera-system product inside PCG, and the
// point back-substitution.
//
// Replaces colmap_tpu/estimators/bundle_adjustment.py _packed_matvec (called
// once per iteration of _packed_pcg / _pcg) and the back-substitution of
// _lm_step_packed_impl (l.1112-1120). The one-hot fetches and reductions of
// the TPU version become indexed loads and shared-memory atomics.
//
// A group of G lanes owns one point (G = capp rounded up to a power of two):
//   u_s = Jp_s xp[f_s] + Jc_s xc[c_s] per slot, w = sum_s Jx_sT u_s summed by
//   shuffles over the group, then
//   mode 0 (matvec)    y = Hpp^-1 w, v_s = Jx_s y, and JpT (u - v), JcT (u - v)
//                      added into the frame / camera outputs: H_cc x and
//                      H_cp Hpp^-1 H_pc x in one reduction (the JAX code takes
//                      two with the same sum). The lam D x term is the caller's.
//   mode 1 (back-sub)  dx = Hpp^-1 (gx - w) per point.
// Frame/camera sums go into a shared-memory copy of the (6F + CP) output and
// each block flushes it with one atomicAdd per non-zero entry; above
// kMaxTableBytes the blocks add straight into the output. Atomics make the
// order of those sums vary from run to run.
//
// Bound on the card: memory. Each launch reads Jp, Jc, Jx and the ids of
// every slot ((20 + 2P) * 4 B + 8 B) and Hpp^-1 per point; it runs
// pcg_iterations + 1 times per LM step, so it is the kernel whose time
// matters most. The design makes one pass over the slots per launch.
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace ctt {

template <bool SMEM>
__global__ void matvec_kernel(int mode, long long N, int capp, int F, int C, int P, int G,
                              const float* __restrict__ Jp, const float* __restrict__ Jc,
                              const float* __restrict__ Jx, const int* __restrict__ fids,
                              const int* __restrict__ cids, const float* __restrict__ hinv,
                              const float* __restrict__ xp, const float* __restrict__ xc,
                              const float* __restrict__ gx, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int table_size = 6 * F + P * C;
  float* table = SMEM ? smem : out;
  if (SMEM) {
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) smem[i] = 0.f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int gpw = 32 / G;
  const int grp = lane / G, k0 = lane % G;
  const long long stride = (long long)gridDim.x * warps * gpw;
  for (long long base = ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * gpw; base < N;
       base += stride) {
    const long long pt = base + grp;
    const bool valid = pt < N;
    float w0 = 0.f, w1 = 0.f, w2 = 0.f;
    if (valid) {
      for (int k = k0; k < capp; k += G) {
        const long long s = pt * capp + k;
        const float* xpf = xp + 6 * fids[s];
        const float* xcc = xc + P * cids[s];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float u = 0.f;
#pragma unroll
          for (int a = 0; a < 6; ++a) u += Jp[12 * s + 6 * i + a] * xpf[a];
          for (int j = 0; j < P; ++j) u += Jc[2 * P * s + P * i + j] * xcc[j];
          w0 += Jx[6 * s + 3 * i] * u;
          w1 += Jx[6 * s + 3 * i + 1] * u;
          w2 += Jx[6 * s + 3 * i + 2] * u;
        }
      }
    }
    w0 = group_sum(w0, G);
    w1 = group_sum(w1, G);
    w2 = group_sum(w2, G);
    if (valid) {
      const float* h = hinv + 9 * pt;
      if (mode == 1) {
        if (k0 == 0) {
          const float e0 = gx[3 * pt] - w0, e1 = gx[3 * pt + 1] - w1, e2 = gx[3 * pt + 2] - w2;
          out[3 * pt] = h[0] * e0 + h[1] * e1 + h[2] * e2;
          out[3 * pt + 1] = h[3] * e0 + h[4] * e1 + h[5] * e2;
          out[3 * pt + 2] = h[6] * e0 + h[7] * e1 + h[8] * e2;
        }
      } else {
        const float y0 = h[0] * w0 + h[1] * w1 + h[2] * w2;
        const float y1 = h[3] * w0 + h[4] * w1 + h[5] * w2;
        const float y2 = h[6] * w0 + h[7] * w1 + h[8] * w2;
        for (int k = k0; k < capp; k += G) {
          const long long s = pt * capp + k;
          const int f = fids[s], c = cids[s];
          const float* xpf = xp + 6 * f;
          const float* xcc = xc + P * c;
          float z[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float u = 0.f;
#pragma unroll
            for (int a = 0; a < 6; ++a) u += Jp[12 * s + 6 * i + a] * xpf[a];
            for (int j = 0; j < P; ++j) u += Jc[2 * P * s + P * i + j] * xcc[j];
            z[i] = u - (Jx[6 * s + 3 * i] * y0 + Jx[6 * s + 3 * i + 1] * y1 +
                        Jx[6 * s + 3 * i + 2] * y2);
          }
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            const float x = Jp[12 * s + a] * z[0] + Jp[12 * s + 6 + a] * z[1];
            if (x != 0.f) atomicAdd(table + 6 * f + a, x);
          }
          for (int j = 0; j < P; ++j) {
            const float x = Jc[2 * P * s + j] * z[0] + Jc[2 * P * s + P + j] * z[1];
            if (x != 0.f) atomicAdd(table + 6 * F + P * c + j, x);
          }
        }
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) {
      const float x = smem[i];
      if (x != 0.f) atomicAdd(out + i, x);
    }
  }
}

}  // namespace ctt

// mode 0: out is the (6F + PC) product, zeroed by the caller;
// mode 1: out is dx (N, 3) and gx is read.
extern "C" int ba_schur_matvec_f32(int mode, long long N, int capp, int F, int C, int P,
                                   const float* Jp, const float* Jc, const float* Jx,
                                   const int* fids, const int* cids, const float* hinv,
                                   const float* xp, const float* xc, const float* gx,
                                   float* out, int num_sms, cudaStream_t stream) {
  if (N == 0) return (int)cudaGetLastError();
  constexpr int kThreads = 256;
  const int G = ctt::group_size(capp);
  const long long points_per_block = (kThreads / 32) * (32 / G);
  long long blocks = (N + points_per_block - 1) / points_per_block;
  const size_t table_bytes = sizeof(float) * (6 * (size_t)F + (size_t)P * C);
  if (mode == 0 && table_bytes <= (size_t)ctt::kMaxTableBytes) {
    if (blocks > 4LL * num_sms) blocks = 4LL * num_sms;
    cudaFuncSetAttribute(ctt::matvec_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)table_bytes);
    ctt::matvec_kernel<true><<<(unsigned)blocks, kThreads, table_bytes, stream>>>(
        mode, N, capp, F, C, P, G, Jp, Jc, Jx, fids, cids, hinv, xp, xc, gx, out);
  } else {
    ctt::matvec_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        mode, N, capp, F, C, P, G, Jp, Jc, Jx, fids, cids, hinv, xp, xc, gx, out);
  }
  return (int)cudaGetLastError();
}
