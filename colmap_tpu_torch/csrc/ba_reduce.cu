// K2 ba_lm_reduce: one LM step's reductions over the point-major slots.
//
// Replaces the reductions of colmap_tpu/estimators/bundle_adjustment.py
// _lm_step_packed_impl (gradients, Jacobi diagonals, the 3x3 point blocks and
// their damped inverse _inv3x3_spd, the reduced right-hand side) and the
// 6x6 pose blocks of H_cc that _packed_pcg's block-Jacobi preconditioner
// builds. The one-hot matmul reductions of the TPU version become sums over
// each frame's and each camera's own slots, in a fixed order.
//
// One launch of blocks of 256 threads (two above kReduceRecomputeCapp
// slots a point), two kinds of block:
//   point blocks  a group of G lanes (G = capp rounded up to a power of two,
//                 at most 32) owns a point: Hpp = sum JxT Jx and
//                 gx = -sum JxT r, summed over the group by shuffles; the
//                 damped inverse (Hpp + lam diag(Hpp) + 1e-12)^-1 follows in
//                 registers (lam is read from device memory, so that the LM
//                 loop keeps its damping on the card);
//   item blocks   an item is up to 256 or 1024 slots (kernels/ba.py
//                 reduce_chunk) of one frame or one camera, in the slot order
//                 that pack_problem builds once a solve (kernels/ba.py
//                 slot_order: the real slots frame by frame, then camera by
//                 camera). Each thread sums its slots' 33 frame values (gp,
//                 bp and the upper triangle of JpT Jp) or 3P camera values
//                 (gc, bc, diag_cam) in registers, with v = Jx y and y =
//                 Hpp^-1 gx of the slot's point; the block sums them by warp
//                 butterflies and then the warps in order. A segment of one
//                 item writes its outputs; the items of a longer segment
//                 write partial rows, and the last of them to finish (a
//                 ticket counter of the order's, which it resets to 0) sums
//                 the rows in item order and writes the outputs.
// Up to kReduceRecomputeCapp slots a point the item blocks recompute y from
// the point's slots; above, the re-reads cost more than a second launch
// (measured on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6), and the
// point blocks write y for a second launch of the item blocks
// (lm_reduce_plan in kernels/ba.py mirrors the choice). Every sum has a
// fixed order: the outputs have the same bits run to run, with no memset,
// no atomics on values and no finalize launch.
//
// Registers (ptxas -v, sm_90a): 64-128 by PMAX (210 at PMAX 32 with y
// recomputed); 1-3 KB of shared memory; no stack frame, no spills.
//
// Bound on the card: memory. It reads r, Jp, Jc, Jx once per slot
// ((20 + 2P) * 4 B) plus the ids, and writes per point gx, Hpp^-1, diag
// (60 B). The item blocks read each slot's y (12 B), or up to capp 2 its
// point's slots again (from L2), once for the frame sums and once for the
// camera sums.
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace ctt {

constexpr int kFrameStride = 33;  // gp 6, bp 6, upper-triangular JpT Jp 21
constexpr int kReduceThreads = 256;
constexpr int kItemFields = 8;  // segment, begin, end, part, first part, parts, ticket, 0
constexpr int kReduceRecomputeCapp = 2;

struct ReduceIn {
  long long N;
  int capp, F, C, P, G, part_width;
  long long point_blocks;
  const float* lam;
  const float *r, *Jp, *Jc, *Jx;
  const int* slots;
  const int* items;
  int* tickets;
  float* partials;
  float* y;  // (N, 3): written by the point blocks where the item blocks read it
};

struct ReduceOut {
  float *gp, *gc, *bp, *bc, *diag_pose, *diag_cam, *hcc, *gx, *hinv, *diag_pt;
};

// One slot's terms of Hpp (upper triangle) and of gx.
__device__ __forceinline__ void point_terms(const ReduceIn& in, long long s, float (&h)[6],
                                            float (&g)[3]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float x0 = in.Jx[6 * s + 3 * i], x1 = in.Jx[6 * s + 3 * i + 1],
                x2 = in.Jx[6 * s + 3 * i + 2];
    const float ri = in.r[2 * s + i];
    h[0] += x0 * x0; h[1] += x0 * x1; h[2] += x0 * x2;
    h[3] += x1 * x1; h[4] += x1 * x2; h[5] += x2 * x2;
    g[0] -= x0 * ri; g[1] -= x1 * ri; g[2] -= x2 * ri;
  }
}

__device__ __forceinline__ void damped_inverse(const float (&h)[6], float lam, float (&hi)[9]) {
  inv3x3_sym(h[0] + lam * h[0] + 1e-12f, h[1], h[2], h[3] + lam * h[3] + 1e-12f, h[4],
             h[5] + lam * h[5] + 1e-12f, hi);
}

__device__ void point_block(const ReduceIn& in, const ReduceOut& out, long long block) {
  const float lam = *in.lam;
  const int lane = threadIdx.x & 31, G = in.G;
  const long long pt =
      (block * (kReduceThreads / 32) + (threadIdx.x >> 5)) * (32 / G) + lane / G;
  const int k0 = lane % G;
  const bool valid = pt < in.N;
  float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
  if (valid)
    for (int k = k0; k < in.capp; k += G) point_terms(in, pt * in.capp + k, h, g);
#pragma unroll
  for (int i = 0; i < 6; ++i) h[i] = group_sum(h[i], G);
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = group_sum(g[i], G);
  if (!valid || k0 != 0) return;
  float hi[9];
  damped_inverse(h, lam, hi);
#pragma unroll
  for (int i = 0; i < 3; ++i) out.gx[3 * pt + i] = g[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) out.hinv[9 * pt + i] = hi[i];
  out.diag_pt[3 * pt] = h[0];
  out.diag_pt[3 * pt + 1] = h[3];
  out.diag_pt[3 * pt + 2] = h[5];
  if (in.y != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      in.y[3 * pt + i] = hi[3 * i] * g[0] + hi[3 * i + 1] * g[1] + hi[3 * i + 2] * g[2];
  }
}

// y = Hpp^-1 gx of point pt: recomputed over its capp slots, or read.
template <bool RECOMPUTE>
__device__ __forceinline__ void point_y(const ReduceIn& in, float lam, long long pt,
                                        float (&y)[3]) {
  if constexpr (RECOMPUTE) {
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < in.capp; ++k) point_terms(in, pt * in.capp + k, h, g);
    float hi[9];
    damped_inverse(h, lam, hi);
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = hi[3 * i] * g[0] + hi[3 * i + 1] * g[1] + hi[3 * i + 2] * g[2];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = in.y[3 * pt + i];
  }
}

// Output v of segment seg (a frame's 33 values, or a camera's 3P).
__device__ void write_value(const ReduceIn& in, const ReduceOut& out, int seg, int v, float x) {
  if (seg < in.F) {
    const int f = seg;
    if (v < 6) {
      out.gp[6 * f + v] = x;
    } else if (v < 12) {
      out.bp[6 * f + v - 6] = x;
    } else {
      int a = 0, rem = v - 12;
      while (rem >= 6 - a) rem -= 6 - a++;
      const int b = a + rem;
      out.hcc[36 * f + 6 * a + b] = x;
      out.hcc[36 * f + 6 * b + a] = x;
      if (a == b) out.diag_pose[6 * f + a] = x;
    }
  } else {
    const int c = seg - in.F, P = in.P;
    if (v < P)
      out.gc[P * c + v] = x;
    else if (v < 2 * P)
      out.bc[P * c + v - P] = x;
    else
      out.diag_cam[P * c + v - 2 * P] = x;
  }
}

// The block's sum of each of the NV values of every thread, in a fixed
// order (butterflies, then the warps in order); a thread with src >= 0 gets
// sum src.
template <int NV>
__device__ __forceinline__ float block_sum_fixed(float (&acc)[NV], float* sm, int src) {
  constexpr int W = kReduceThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float x = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) sm[warp * NV + v] = x;
  }
  __syncthreads();
  float total = 0.f;
  if (src >= 0)
#pragma unroll
    for (int w = 0; w < W; ++w) total += sm[w * NV + src];
  return total;
}

// Writes an item's sums: its segment's outputs, or its partial row and, in
// the segment's last item to finish, the sum of the rows in item order.
__device__ void finish_item(const ReduceIn& in, const ReduceOut& out, const int* it, int nv,
                            float total) {
  const int seg = it[0], part = it[3];
  if (part < 0) {
    if (threadIdx.x < nv) write_value(in, out, seg, threadIdx.x, total);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x < nv) in.partials[(size_t)part * in.part_width + threadIdx.x] = total;
  __threadfence();
  __syncthreads();
  const int first = it[4], parts = it[5], ticket = it[6];
  if (threadIdx.x == 0) last = atomicAdd(in.tickets + ticket, 1) == parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < nv; v += kReduceThreads / 32) {
    float x = 0.f;
    for (int p = lane; p < parts; p += 32)
      x += __ldcg(in.partials + (size_t)(first + p) * in.part_width + v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) write_value(in, out, seg, v, x);
  }
  if (threadIdx.x == 0) in.tickets[ticket] = 0;
}

template <int PMAX, bool RECOMPUTE>
__device__ void item_block(const ReduceIn& in, const ReduceOut& out, int item) {
  constexpr int NVC = 3 * PMAX, NVMAX = NVC > kFrameStride ? NVC : kFrameStride;
  __shared__ float sm[(kReduceThreads / 32) * NVMAX];
  const int* it = in.items + (size_t)item * kItemFields;
  const int seg = it[0], begin = it[1], end = it[2];
  const float lam = RECOMPUTE ? *in.lam : 0.f;
  const int capp = in.capp;
  if (seg < in.F) {
    float acc[kFrameStride];
#pragma unroll
    for (int v = 0; v < kFrameStride; ++v) acc[v] = 0.f;
#pragma unroll 2
    for (int j = begin + threadIdx.x; j < end; j += kReduceThreads) {
      const long long s = in.slots[j];
      float y[3];
      point_y<RECOMPUTE>(in, lam, s / capp, y);
      float jp[2][6];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int a = 0; a < 6; ++a) jp[i][a] = in.Jp[12 * s + 6 * i + a];
      const float r0 = in.r[2 * s], r1 = in.r[2 * s + 1];
      const float* jx = in.Jx + 6 * s;
      const float z0 = r0 + jx[0] * y[0] + jx[1] * y[1] + jx[2] * y[2];
      const float z1 = r1 + jx[3] * y[0] + jx[4] * y[1] + jx[5] * y[2];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        acc[a] -= jp[0][a] * r0 + jp[1][a] * r1;
        acc[6 + a] -= jp[0][a] * z0 + jp[1][a] * z1;
      }
      int idx = 12;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[idx++] += jp[0][a] * jp[0][b] + jp[1][a] * jp[1][b];
    }
    const int v = threadIdx.x;
    const float total = block_sum_fixed<kFrameStride>(acc, sm, v < kFrameStride ? v : -1);
    finish_item(in, out, it, kFrameStride, total);
  } else {
    const int P = in.P;
    float acc[NVC];
#pragma unroll
    for (int v = 0; v < NVC; ++v) acc[v] = 0.f;
#pragma unroll 2
    for (int j = begin + threadIdx.x; j < end; j += kReduceThreads) {
      const long long s = in.slots[j];
      float y[3];
      point_y<RECOMPUTE>(in, lam, s / capp, y);
      const float r0 = in.r[2 * s], r1 = in.r[2 * s + 1];
      const float* jx = in.Jx + 6 * s;
      const float z0 = r0 + jx[0] * y[0] + jx[1] * y[1] + jx[2] * y[2];
      const float z1 = r1 + jx[3] * y[0] + jx[4] * y[1] + jx[5] * y[2];
      const float* jc = in.Jc + 2 * (size_t)P * s;
#pragma unroll
      for (int q = 0; q < PMAX; ++q) {
        if (q < P) {
          const float c0 = jc[q], c1 = jc[P + q];
          acc[q] -= c0 * r0 + c1 * r1;
          acc[PMAX + q] -= c0 * z0 + c1 * z1;
          acc[2 * PMAX + q] += c0 * c0 + c1 * c1;
        }
      }
    }
    // Camera value v (gc, bc, diag_cam: P each) sits at acc[(v / P) * PMAX + v % P].
    const int v = threadIdx.x;
    const float total = block_sum_fixed<NVC>(acc, sm, v < 3 * P ? v / P * PMAX + v % P : -1);
    finish_item(in, out, it, 3 * P, total);
  }
}

template <int PMAX, bool RECOMPUTE>
__global__ void __launch_bounds__(kReduceThreads) lm_reduce_kernel(ReduceIn in, ReduceOut out) {
  if (blockIdx.x < in.point_blocks)
    point_block(in, out, blockIdx.x);
  else
    item_block<PMAX, RECOMPUTE>(in, out, (int)(blockIdx.x - in.point_blocks));
}

template <int PMAX>
int launch_reduce(const ReduceIn& in, const ReduceOut& out, int items, bool recompute,
                  cudaStream_t stream) {
  if (recompute) {
    const long long blocks = in.point_blocks + items;
    if (blocks > 0)
      lm_reduce_kernel<PMAX, true><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(in, out);
    return (int)cudaGetLastError();
  }
  if (in.point_blocks > 0)
    lm_reduce_kernel<PMAX, false><<<(unsigned)in.point_blocks, kReduceThreads, 0, stream>>>(in,
                                                                                         out);
  ReduceIn second = in;
  second.point_blocks = 0;
  if (items > 0)
    lm_reduce_kernel<PMAX, false><<<(unsigned)items, kReduceThreads, 0, stream>>>(second, out);
  return (int)cudaGetLastError();
}

}  // namespace ctt

// slots, items (num_items x 8), tickets: the order of kernels/ba.py
// slot_order; partials: its num_partials rows of max(33, 3P) floats; y:
// (N, 3) floats where the plan writes y (capp above kReduceRecomputeCapp),
// else null. lam: one float in device memory. Outputs in the order of
// colmap_tpu_torch.kernels.ba.LMReduction. One launch, or two with y.
extern "C" int ba_lm_reduce_f32(long long N, int capp, int F, int C, int P, const float* lam,
                                const float* r, const float* Jp, const float* Jc,
                                const float* Jx, const int* slots, const int* items,
                                int num_items, int* tickets, float* partials, float* y, float* gp,
                                float* gc, float* bp, float* bc, float* diag_pose,
                                float* diag_cam, float* hcc, float* gx, float* hinv,
                                float* diag_pt, cudaStream_t stream) {
  if (P > 32) return (int)cudaErrorInvalidValue;
  const bool recompute = capp <= ctt::kReduceRecomputeCapp;
  if (!recompute && y == nullptr && N > 0) return (int)cudaErrorInvalidValue;
  const int G = ctt::group_size(capp);
  const long long points_per_block = (ctt::kReduceThreads / 32) * (32 / G);
  ctt::ReduceIn in{N, capp, F, C, P, G, 3 * P > ctt::kFrameStride ? 3 * P : ctt::kFrameStride,
                   N > 0 ? (N + points_per_block - 1) / points_per_block : 0,
                   lam, r, Jp, Jc, Jx, slots, items, tickets, partials,
                   recompute ? nullptr : y};
  ctt::ReduceOut out{gp, gc, bp, bc, diag_pose, diag_cam, hcc, gx, hinv, diag_pt};
  if (P <= 4) return ctt::launch_reduce<4>(in, out, num_items, recompute, stream);
  if (P <= 8) return ctt::launch_reduce<8>(in, out, num_items, recompute, stream);
  if (P <= 16) return ctt::launch_reduce<16>(in, out, num_items, recompute, stream);
  return ctt::launch_reduce<32>(in, out, num_items, recompute, stream);
}
