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
// Frame/camera sums go into shared-memory copies of the (6F + PC) output:
// one a warp where the table is small (kWarpTables: up to kWarpTableFloats
// floats), so that only the lanes of a warp collide, else one a block; the
// block then adds each non-zero entry (its warps' copies summed in warp
// order) into the output with one atomicAdd. Above kMaxTableBytes the
// blocks add straight into the output. Where every slot of a warp's trip
// sees one camera (a single-camera scene: every slot), its P camera terms
// are summed across the warp by an xor butterfly and one lane adds them,
// rather than every lane of the block into the same P entries. Atomics
// make the order of those sums vary from run to run.
//
// Bound on the card: memory. Each launch reads Jp, Jc, Jx and the ids of
// every slot ((20 + 2P) * 4 B + 8 B) and Hpp^-1 per point; it runs
// pcg_iterations + 1 times per LM step, so it is the kernel whose time
// matters most. The design makes one pass over the slots per launch.
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace ctt {

enum MatvecTable { kGlobalTable = 0, kBlockTable = 1, kWarpTables = 2 };
constexpr int kMatvecThreads = 256;
constexpr int kWarpTableFloats = 1536;  // 8 warps x 6 KB

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int TABLE>
__global__ void __launch_bounds__(kMatvecThreads)
matvec_kernel(int mode, long long N, int capp, int F, int C, int P, int G,
              const float* __restrict__ Jp, const float* __restrict__ Jc,
              const float* __restrict__ Jx, const int* __restrict__ fids,
              const int* __restrict__ cids, const float* __restrict__ hinv,
              const float* __restrict__ xp, const float* __restrict__ xc,
              const float* __restrict__ gx, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int table_size = 6 * F + P * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* table = TABLE == kWarpTables ? smem + warp * table_size
                                      : (TABLE == kBlockTable ? smem : out);
  if (TABLE != kGlobalTable) {
    const int n = (TABLE == kWarpTables ? warps : 1) * table_size;
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = 0.f;
    __syncthreads();
  }
  const int gpw = 32 / G;
  const int grp = lane / G, k0 = lane % G;
  const long long stride = (long long)gridDim.x * warps * gpw;
  for (long long base = ((long long)blockIdx.x * warps + warp) * gpw; base < N; base += stride) {
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
    const float* h = hinv + 9 * (valid ? pt : 0);
    if (mode == 1) {
      if (valid && k0 == 0) {
        const float e0 = gx[3 * pt] - w0, e1 = gx[3 * pt + 1] - w1, e2 = gx[3 * pt + 2] - w2;
        out[3 * pt] = h[0] * e0 + h[1] * e1 + h[2] * e2;
        out[3 * pt + 1] = h[3] * e0 + h[4] * e1 + h[5] * e2;
        out[3 * pt + 2] = h[6] * e0 + h[7] * e1 + h[8] * e2;
      }
      continue;
    }
    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    if (valid) {
      y0 = h[0] * w0 + h[1] * w1 + h[2] * w2;
      y1 = h[3] * w0 + h[4] * w1 + h[5] * w2;
      y2 = h[6] * w0 + h[7] * w1 + h[8] * w2;
    }
    // The same trips on every lane of the warp, for the camera butterfly.
    for (int kk = 0; kk < capp; kk += G) {
      const int k = kk + k0;
      const bool has = valid && k < capp;
      const long long s = has ? pt * capp + k : 0;
      const int f = has ? fids[s] : 0, c = has ? cids[s] : 0;
      float z[2] = {0.f, 0.f};
      if (has) {
        const float* xpf = xp + 6 * f;
        const float* xcc = xc + P * c;
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
      }
      const unsigned with = __ballot_sync(0xffffffffu, has);
      if (with == 0u) continue;
      const int c_ref = __shfl_sync(0xffffffffu, c, __ffs(with) - 1);
      if (__all_sync(0xffffffffu, !has || c == c_ref)) {
        for (int j = 0; j < P; ++j) {
          const float x = warp_sum(has ? Jc[2 * P * s + j] * z[0] + Jc[2 * P * s + P + j] * z[1]
                                       : 0.f);
          if (lane == 0 && x != 0.f) atomicAdd(table + 6 * F + P * c_ref + j, x);
        }
      } else if (has) {
        for (int j = 0; j < P; ++j) {
          const float x = Jc[2 * P * s + j] * z[0] + Jc[2 * P * s + P + j] * z[1];
          if (x != 0.f) atomicAdd(table + 6 * F + P * c + j, x);
        }
      }
    }
  }
  if (TABLE != kGlobalTable) {
    __syncthreads();
    for (int i = threadIdx.x; i < table_size; i += blockDim.x) {
      float x = smem[i];
      if (TABLE == kWarpTables)
        for (int w = 1; w < warps; ++w) x += smem[w * table_size + i];
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
  using namespace ctt;
  if (N == 0) return (int)cudaGetLastError();
  const int G = group_size(capp);
  const long long points_per_block = (kMatvecThreads / 32) * (32 / G);
  long long blocks = (N + points_per_block - 1) / points_per_block;
  const long long table_size = 6LL * F + (long long)P * C;
  const size_t table_bytes = sizeof(float) * (size_t)table_size;
  if (mode == 0 && table_size <= kWarpTableFloats) {
    if (blocks > 4LL * num_sms) blocks = 4LL * num_sms;
    const size_t bytes = table_bytes * (kMatvecThreads / 32);
    matvec_kernel<kWarpTables><<<(unsigned)blocks, kMatvecThreads, bytes, stream>>>(
        mode, N, capp, F, C, P, G, Jp, Jc, Jx, fids, cids, hinv, xp, xc, gx, out);
  } else if (mode == 0 && table_bytes <= (size_t)kMaxTableBytes) {
    if (blocks > 4LL * num_sms) blocks = 4LL * num_sms;
    if (table_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          matvec_kernel<kBlockTable>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)table_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    matvec_kernel<kBlockTable><<<(unsigned)blocks, kMatvecThreads, table_bytes, stream>>>(
        mode, N, capp, F, C, P, G, Jp, Jc, Jx, fids, cids, hinv, xp, xc, gx, out);
  } else {
    matvec_kernel<kGlobalTable><<<(unsigned)blocks, kMatvecThreads, 0, stream>>>(
        mode, N, capp, F, C, P, G, Jp, Jc, Jx, fids, cids, hinv, xp, xc, gx, out);
  }
  return (int)cudaGetLastError();
}
