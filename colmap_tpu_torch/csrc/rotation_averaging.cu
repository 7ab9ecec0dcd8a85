// K21 rotation_averaging: one IRLS iteration of global rotation averaging.
//
// Replaces colmap_tpu/estimators/rotation_averaging.py `iteration`
// (l.274-289) over _edge_residuals (l.114), _quat_log / _quat_exp (l.95,
// l.107) and _solve_tangent_cg (l.123). Three entries, float32:
//   (a) edge pass: per edge e = (i, j) the residual r = Log(q_rel ⊗ q_i ⊗
//       q_j⁻¹), |r|, its world-frame form R_jᵀ r (quat_rotate by q_j⁻¹) and
//       the L1 weight 1 / max(|r|, 1e-5) or the Geman-McClure weight
//       σ² / (|r|² + σ²)²; then per node, over its incident edges, the CG
//       right-hand side b = Σ_{j=n} w r_w − Σ_{i=n} w r_w and the Jacobi
//       degree Σ w, both through `constrain` (the free mask, then the
//       node's gravity projector, l.134-138); and the cost Σ |r|;
//   (b) Laplacian matvec: (Lᵀ W L x)_n = Σ_{j=n} w (x_j − x_i) −
//       Σ_{i=n} w (x_j − x_i), then `constrain`; each CG iteration calls it;
//   (c) node update q ← normalize(q ⊗ Exp(δ)).
//
// Layout: the incidence list of each node (CSR over nodes, built once per
// solve on the card) holds 2e + 1 where the node is the edge's j and 2e
// where it is its i. A warp gathers one node's list and reduces by
// shuffles: no float atomics, so the sums do not depend on scheduling.
//
// Bound on the card: bytes. Per edge (a) reads two quaternions, the
// relative one and the indices (56 B) for ~200 operations; (b) reads the
// weight and two 3-vectors per incidence. At 1000 nodes and 25 000 edges
// (b) moves about 330 KB, so its launch and the CG's torch ops around it
// cost more than its traffic; a fused CG step is later work.
#include <cuda_runtime.h>
#include <math.h>

#include "global_common.cuh"

namespace ctt {
namespace ra {

using gsfm::kBlock;

struct Q4 {
  float w, x, y, z;
};

__device__ __forceinline__ Q4 load_q(const float* q, int i) {
  return Q4{q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]};
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return Q4{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  const float n = fmaxf(sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), 1.17549435e-38f);
  return Q4{q.w / n, q.x / n, q.y / n, q.z / n};
}

__device__ __forceinline__ Q4 qconj(Q4 q) { return Q4{q.w, -q.x, -q.y, -q.z}; }

// v + 2 w (u x v) + 2 u x (u x v), u = q.xyz (geometry/rotation.py quat_rotate).
__device__ __forceinline__ float3 qrotate(Q4 q, float3 v) {
  const float3 uv = make_float3(q.y * v.z - q.z * v.y, q.z * v.x - q.x * v.z,
                                q.x * v.y - q.y * v.x);
  const float3 uuv = make_float3(q.y * uv.z - q.z * uv.y, q.z * uv.x - q.x * uv.z,
                                 q.x * uv.y - q.y * uv.x);
  return make_float3(v.x + 2.f * (q.w * uv.x + uuv.x), v.y + 2.f * (q.w * uv.y + uuv.y),
                     v.z + 2.f * (q.w * uv.z + uuv.z));
}

// _quat_log: unit quaternion -> tangent vector.
__device__ __forceinline__ float3 qlog(Q4 q) {
  q = qnormalize(q);
  if (q.w < 0.f) q = Q4{-q.w, -q.x, -q.y, -q.z};
  const float w = fminf(fmaxf(q.w, -1.f), 1.f);
  const float vn = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z);
  const float angle = 2.f * atan2f(vn, w);
  const float s = vn > 1e-12f ? angle / fmaxf(vn, 1e-30f) : 2.f;
  return make_float3(q.x * s, q.y * s, q.z * s);
}

// _quat_exp: tangent vector -> quaternion.
__device__ __forceinline__ Q4 qexp(float3 d) {
  const float th = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  const float s = th > 1e-12f ? sinf(0.5f * th) / fmaxf(th, 1e-30f) : 0.5f;
  return Q4{cosf(0.5f * th), s * d.x, s * d.y, s * d.z};
}

// constrain(x) at node n: x * free[n], then P_n x when projectors are given.
__device__ __forceinline__ float3 constrain(float3 v, int n, const float* __restrict__ free_mask,
                                            const float* __restrict__ proj) {
  const float f = free_mask[n];
  v = make_float3(v.x * f, v.y * f, v.z * f);
  if (proj == nullptr) return v;
  const float* P = proj + 9 * n;
  return make_float3(P[0] * v.x + P[1] * v.y + P[2] * v.z, P[3] * v.x + P[4] * v.y + P[5] * v.z,
                     P[6] * v.x + P[7] * v.y + P[8] * v.z);
}

// (a), first half: per edge, w * r_world and w into ew (E, 4), |r| into rn.
__global__ void __launch_bounds__(kBlock)
edge_kernel(int E, int use_l1, float sigma, const int* __restrict__ edges,
            const float* __restrict__ quats, const float* __restrict__ rel,
            float* __restrict__ ew, float* __restrict__ rn_out) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= E) return;
  const int i = edges[2 * e], j = edges[2 * e + 1];
  const Q4 qj_inv = qconj(qnormalize(load_q(quats, j)));
  const Q4 err = qmul(qmul(load_q(rel, e), load_q(quats, i)), qj_inv);
  const float3 r = qlog(err);
  const float rn = sqrtf(r.x * r.x + r.y * r.y + r.z * r.z);
  const float3 rw = qrotate(qj_inv, r);
  const float s2 = sigma * sigma, d = rn * rn + s2;
  const float w = use_l1 ? 1.f / fmaxf(rn, 1e-5f) : s2 / (d * d);
  ew[4 * e] = w * rw.x;
  ew[4 * e + 1] = w * rw.y;
  ew[4 * e + 2] = w * rw.z;
  ew[4 * e + 3] = w;
  rn_out[e] = rn;
}

// (a), second half: one warp per node gathers b and deg over its incidence list.
__global__ void __launch_bounds__(kBlock)
node_rhs_kernel(int N, const int* __restrict__ offsets, const int* __restrict__ inc,
                const float* __restrict__ ew, const float* __restrict__ free_mask,
                const float* __restrict__ proj, float* __restrict__ b, float* __restrict__ deg) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warps leave together
  float bx = 0.f, by = 0.f, bz = 0.f, dg = 0.f;
  for (int k = offsets[n] + lane; k < offsets[n + 1]; k += 32) {
    const int code = inc[k], e = code >> 1;
    const float sgn = (code & 1) ? 1.f : -1.f;
    bx += sgn * ew[4 * e];
    by += sgn * ew[4 * e + 1];
    bz += sgn * ew[4 * e + 2];
    dg += ew[4 * e + 3];
  }
  bx = gsfm::warp_sum(bx);
  by = gsfm::warp_sum(by);
  bz = gsfm::warp_sum(bz);
  dg = gsfm::warp_sum(dg);
  if (lane == 0) {
    const float3 v = constrain(make_float3(bx, by, bz), n, free_mask, proj);
    b[3 * n] = v.x;
    b[3 * n + 1] = v.y;
    b[3 * n + 2] = v.z;
    deg[n] = dg;
  }
}

// The cost Σ |r| in one block, in a fixed order, accumulated in float64.
__global__ void __launch_bounds__(kBlock)
cost_kernel(int E, const float* __restrict__ rn, double* __restrict__ cost) {
  __shared__ double scratch[kBlock / 32];
  double v[1] = {0.0};
  for (int e = threadIdx.x; e < E; e += kBlock) v[0] += (double)rn[e];
  gsfm::block_sum<1>(v, scratch);
  if (threadIdx.x == 0) *cost = v[0];
}

// (b): one warp per node.
__global__ void __launch_bounds__(kBlock)
matvec_kernel(int N, const int* __restrict__ edges, const int* __restrict__ offsets,
              const int* __restrict__ inc, const float* __restrict__ w,
              const float* __restrict__ x, const float* __restrict__ free_mask,
              const float* __restrict__ proj, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (n >= N) return;
  float ox = 0.f, oy = 0.f, oz = 0.f;
  for (int k = offsets[n] + lane; k < offsets[n + 1]; k += 32) {
    const int code = inc[k], e = code >> 1;
    const int i = edges[2 * e], j = edges[2 * e + 1];
    const float sw = (code & 1) ? w[4 * e + 3] : -w[4 * e + 3];
    ox += sw * (x[3 * j] - x[3 * i]);
    oy += sw * (x[3 * j + 1] - x[3 * i + 1]);
    oz += sw * (x[3 * j + 2] - x[3 * i + 2]);
  }
  ox = gsfm::warp_sum(ox);
  oy = gsfm::warp_sum(oy);
  oz = gsfm::warp_sum(oz);
  if (lane == 0) {
    const float3 v = constrain(make_float3(ox, oy, oz), n, free_mask, proj);
    out[3 * n] = v.x;
    out[3 * n + 1] = v.y;
    out[3 * n + 2] = v.z;
  }
}

// (c): one thread per node.
__global__ void __launch_bounds__(kBlock)
update_kernel(int N, const float* __restrict__ quats, const float* __restrict__ delta,
              float* __restrict__ out) {
  const int n = blockIdx.x * kBlock + threadIdx.x;
  if (n >= N) return;
  const Q4 q = qnormalize(
      qmul(load_q(quats, n), qexp(make_float3(delta[3 * n], delta[3 * n + 1], delta[3 * n + 2]))));
  out[4 * n] = q.w;
  out[4 * n + 1] = q.x;
  out[4 * n + 2] = q.y;
  out[4 * n + 3] = q.z;
}

}  // namespace ra
}  // namespace ctt

namespace {
unsigned blocks_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}
}  // namespace

// (a). ew (E, 4) and rn (E,) are the wrapper's scratch; ew is kept for (b).
extern "C" int ra_edge_pass_f32(int N, int E, int use_l1, float sigma, const int* edges,
                                const float* quats, const float* rel, const int* offsets,
                                const int* inc, const float* free_mask, const float* proj,
                                float* ew, float* rn, float* b, float* deg, double* cost,
                                void* stream) {
  using namespace ctt::ra;
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0) {
    edge_kernel<<<blocks_for(E, kBlock), kBlock, 0, s>>>(E, use_l1, sigma, edges, quats, rel, ew,
                                                         rn);
  }
  if (N > 0) {
    node_rhs_kernel<<<blocks_for(N, kBlock / 32), kBlock, 0, s>>>(N, offsets, inc, ew, free_mask,
                                                                  proj, b, deg);
  }
  cost_kernel<<<1, kBlock, 0, s>>>(E, rn, cost);
  return (int)cudaGetLastError();
}

// (b). ew is the edge pass's (E, 4) scratch: the weight is its fourth column.
extern "C" int ra_matvec_f32(int N, const int* edges, const int* offsets, const int* inc,
                             const float* ew, const float* x, const float* free_mask,
                             const float* proj, float* out, void* stream) {
  using namespace ctt::ra;
  if (N > 0) {
    matvec_kernel<<<blocks_for(N, kBlock / 32), kBlock, 0, (cudaStream_t)stream>>>(
        N, edges, offsets, inc, ew, x, free_mask, proj, out);
  }
  return (int)cudaGetLastError();
}

// (c).
extern "C" int ra_update_f32(int N, const float* quats, const float* delta, float* out,
                             void* stream) {
  using namespace ctt::ra;
  if (N > 0) {
    update_kernel<<<blocks_for(N, kBlock), kBlock, 0, (cudaStream_t)stream>>>(N, quats, delta,
                                                                             out);
  }
  return (int)cudaGetLastError();
}
