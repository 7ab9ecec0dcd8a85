// K2 ba_lm_reduce: one LM step's reductions over the point-major slots.
//
// Replaces the reductions of colmap_tpu/estimators/bundle_adjustment.py
// _lm_step_packed_impl (gradients, Jacobi diagonals, the 3x3 point blocks and
// their damped inverse _inv3x3_spd, the reduced right-hand side) and the
// 6x6 pose blocks of H_cc that _packed_pcg's block-Jacobi preconditioner
// builds. The one-hot matmul reductions of the TPU version become plain
// indexed loads and shared-memory atomics.
//
// A point's slots are contiguous in the point-major layout, so a group of
// G lanes (G = capp rounded up to a power of two, at most 32) owns a point:
//   phase 1  Hpp = sum JxT Jx and gx = -sum JxT r, summed over the group by
//            shuffles; the damped inverse (Hpp + lam diag(Hpp) + 1e-12)^-1
//            and y = Hpp^-1 gx follow in registers (lam is read from device
//            memory, so that the LM loop keeps its damping on the card);
//   phase 2  per slot v = Jx y, and the frame / camera sums
//            gp = -sum JpT r, bp = -sum JpT (r + v), H = sum JpT Jp (upper
//            triangle), gc, bc, diag_cam.
// Frame and camera sums go into a shared-memory copy of the tables
// (33 floats per frame, 3P per camera; 26 KB at F = 200) and each block
// flushes its table into a global scratch with one atomicAdd per non-zero
// entry; when the tables exceed kMaxTableBytes the blocks add straight into
// the scratch. A second small kernel expands the scratch into the outputs.
// Atomics make the order of the frame/camera sums vary from run to run.
//
// Bound on the card: memory. It reads r, Jp, Jc, Jx once per slot
// ((20 + 2P) * 4 B) plus the ids, and writes per point gx, Hpp^-1, diag
// (60 B). The design reads every slot once and keeps all partial sums on
// chip; the shared-memory atomics are its cost above the bound.
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace ctt {

constexpr int kFrameStride = 33;  // gp 6, bp 6, upper-triangular JpT Jp 21

template <bool SMEM>
__global__ void lm_reduce_kernel(long long N, int capp, int F, int C, int P, int G,
                                 const float* __restrict__ lam_ptr,
                                 const float* __restrict__ r, const float* __restrict__ Jp,
                                 const float* __restrict__ Jc, const float* __restrict__ Jx,
                                 const int* __restrict__ fids, const int* __restrict__ cids,
                                 float* __restrict__ scratch, float* __restrict__ gx_out,
                                 float* __restrict__ hinv_out, float* __restrict__ diag_out) {
  extern __shared__ float smem[];
  const int table_size = kFrameStride * F + 3 * P * C;
  float* table = SMEM ? smem : scratch;
  if (SMEM) {
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) smem[i] = 0.f;
    __syncthreads();
  }
  const float lam = *lam_ptr;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int gpw = 32 / G;  // points per warp
  const int grp = lane / G, k0 = lane % G;
  const long long stride = (long long)gridDim.x * warps * gpw;
  for (long long base = ((long long)blockIdx.x * warps + (threadIdx.x >> 5)) * gpw; base < N;
       base += stride) {
    const long long pt = base + grp;
    const bool valid = pt < N;
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
    if (valid) {
      for (int k = k0; k < capp; k += G) {
        const long long s = pt * capp + k;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x0 = Jx[6 * s + 3 * i], x1 = Jx[6 * s + 3 * i + 1],
                      x2 = Jx[6 * s + 3 * i + 2];
          const float ri = r[2 * s + i];
          h[0] += x0 * x0; h[1] += x0 * x1; h[2] += x0 * x2;
          h[3] += x1 * x1; h[4] += x1 * x2; h[5] += x2 * x2;
          g[0] -= x0 * ri; g[1] -= x1 * ri; g[2] -= x2 * ri;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) h[i] = group_sum(h[i], G);
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = group_sum(g[i], G);
    if (valid) {
      float hi[9];
      inv3x3_sym(h[0] + lam * h[0] + 1e-12f, h[1], h[2], h[3] + lam * h[3] + 1e-12f, h[4],
                 h[5] + lam * h[5] + 1e-12f, hi);
      const float y0 = hi[0] * g[0] + hi[1] * g[1] + hi[2] * g[2];
      const float y1 = hi[3] * g[0] + hi[4] * g[1] + hi[5] * g[2];
      const float y2 = hi[6] * g[0] + hi[7] * g[1] + hi[8] * g[2];
      if (k0 == 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) gx_out[3 * pt + i] = g[i];
#pragma unroll
        for (int i = 0; i < 9; ++i) hinv_out[9 * pt + i] = hi[i];
        diag_out[3 * pt] = h[0];
        diag_out[3 * pt + 1] = h[3];
        diag_out[3 * pt + 2] = h[5];
      }
      for (int k = k0; k < capp; k += G) {
        const long long s = pt * capp + k;
        float jp[2][6];
        bool any = false;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int a = 0; a < 6; ++a) {
            jp[i][a] = Jp[12 * s + 6 * i + a];
            any = any || jp[i][a] != 0.f;
          }
        for (int j = 0; j < 2 * P; ++j) any = any || Jc[2 * P * s + j] != 0.f;
        if (!any) continue;
        const float r0 = r[2 * s], r1 = r[2 * s + 1];
        const float z0 = r0 + Jx[6 * s] * y0 + Jx[6 * s + 1] * y1 + Jx[6 * s + 2] * y2;
        const float z1 = r1 + Jx[6 * s + 3] * y0 + Jx[6 * s + 4] * y1 + Jx[6 * s + 5] * y2;
        float* tf = table + kFrameStride * fids[s];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          atomicAdd(tf + a, -(jp[0][a] * r0 + jp[1][a] * r1));
          atomicAdd(tf + 6 + a, -(jp[0][a] * z0 + jp[1][a] * z1));
        }
        int idx = 12;
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = a; b < 6; ++b) atomicAdd(tf + idx++, jp[0][a] * jp[0][b] + jp[1][a] * jp[1][b]);
        float* tc = table + kFrameStride * F + 3 * P * cids[s];
        for (int j = 0; j < P; ++j) {
          const float c0 = Jc[2 * P * s + j], c1 = Jc[2 * P * s + P + j];
          atomicAdd(tc + j, -(c0 * r0 + c1 * r1));
          atomicAdd(tc + P + j, -(c0 * z0 + c1 * z1));
          atomicAdd(tc + 2 * P + j, c0 * c0 + c1 * c1);
        }
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) {
      const float x = smem[i];
      if (x != 0.f) atomicAdd(scratch + i, x);
    }
  }
}

__global__ void lm_reduce_finalize(int F, int C, int P, const float* __restrict__ scratch,
                                   float* gp, float* gc, float* bp, float* bc, float* diag_pose,
                                   float* diag_cam, float* hcc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) {
    const float* tf = scratch + kFrameStride * i;
    for (int a = 0; a < 6; ++a) {
      gp[6 * i + a] = tf[a];
      bp[6 * i + a] = tf[6 + a];
    }
    int idx = 12;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) {
        const float x = tf[idx++];
        hcc[36 * i + 6 * a + b] = x;
        hcc[36 * i + 6 * b + a] = x;
        if (a == b) diag_pose[6 * i + a] = x;
      }
  }
  if (i < C) {
    const float* tc = scratch + kFrameStride * F + 3 * P * i;
    for (int j = 0; j < P; ++j) {
      gc[P * i + j] = tc[j];
      bc[P * i + j] = tc[P + j];
      diag_cam[P * i + j] = tc[2 * P + j];
    }
  }
}

}  // namespace ctt

// scratch: 33 F + 3 P C floats, zeroed by the caller; lam: one float in device
// memory. Outputs in the order of colmap_tpu_torch.kernels.ba.LMReduction.
extern "C" int ba_lm_reduce_f32(long long N, int capp, int F, int C, int P, const float* lam,
                                const float* r, const float* Jp, const float* Jc,
                                const float* Jx, const int* fids, const int* cids,
                                float* scratch, float* gp, float* gc, float* bp, float* bc,
                                float* diag_pose, float* diag_cam, float* hcc, float* gx,
                                float* hinv, float* diag_pt, int num_sms, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int G = ctt::group_size(capp);
  const long long points_per_block = (kThreads / 32) * (32 / G);
  const size_t table_bytes = sizeof(float) * ((size_t)ctt::kFrameStride * F + 3 * (size_t)P * C);
  if (N > 0) {
    if (table_bytes <= (size_t)ctt::kMaxTableBytes) {
      long long blocks = (N + points_per_block - 1) / points_per_block;
      if (blocks > 2LL * num_sms) blocks = 2LL * num_sms;
      cudaFuncSetAttribute(ctt::lm_reduce_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)table_bytes);
      ctt::lm_reduce_kernel<true><<<(unsigned)blocks, kThreads, table_bytes, stream>>>(
          N, capp, F, C, P, G, lam, r, Jp, Jc, Jx, fids, cids, scratch, gx, hinv, diag_pt);
    } else {
      long long blocks = (N + points_per_block - 1) / points_per_block;
      if (blocks > 8LL * num_sms) blocks = 8LL * num_sms;
      ctt::lm_reduce_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
          N, capp, F, C, P, G, lam, r, Jp, Jc, Jx, fids, cids, scratch, gx, hinv, diag_pt);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = F > C ? F : C;
  if (n > 0)
    ctt::lm_reduce_finalize<<<(n + 127) / 128, 128, 0, stream>>>(F, C, P, scratch, gp, gc, bp,
                                                                bc, diag_pose, diag_cam, hcc);
  return (int)cudaGetLastError();
}
