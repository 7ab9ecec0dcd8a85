// K39 global_cg: the Jacobi-preconditioned CG step of global SfM's two
// linear solves, around their matvecs (K21 (b), K22 (b)).
//
// Replaces the CG vector work and scalars of two colmap_tpu programs:
//   rotation mode     estimators/rotation_averaging.py _solve_tangent_cg
//                     (l.123-175): M = 1 / deg where deg > 1e-12 (else 0),
//                     alpha = rz / max(p.Ap, 1e-30), beta = rz_new /
//                     max(rz, 1e-30), on the N x 3 tangent vectors;
//   positioning mode  estimators/global_positioning.py _irls_solve's CG
//                     (l.140-164): M = 1 / (diag_c + eps_rel mean(diag_c) +
//                     1e-30), and the freeze rule live = rz > 1e-12 rz0:
//                     once it fails, alpha = beta = 0 and p, rz stay, so x
//                     and r stop moving (colmap_tpu freezes float32 CG past
//                     convergence this way), on the C x 3 camera centres.
// Two entries:
//   global_cg_setup  M (3n floats; a node's 1 / deg repeated on its three
//                    entries in rotation mode; the mean of diag_c a fixed-
//                    order sum in positioning mode), x = 0, r = b, z = M r,
//                    p = z, rz and rz0 into scal[0], scal[1];
//   global_cg_step   after the matvec wrote Ap = A p: pAp, alpha, x, r, z,
//                    rz_new, beta, p and rz; one launch.
// One CG iteration is then two launches (matvec, step) with every scalar in
// device memory, where the torch version took about 14 ops; a whole CG
// (cg_iterations of them) is one CUDA graph that the solvers replay once
// per IRLS round.
//
// One block strides over the vector and takes every dot product as a block
// reduction in float64 in a fixed order (K34's block_sum_d: each thread's
// entries in order, a fixed shuffle tree, the warps in order): no atomics,
// so two runs agree to the bit. The vectors stay float32.
//
// Bound on the card: neither bytes nor operations. n is 3000 at the
// 1000-node / 1000-camera scale; a step moves 7n floats, and a few
// microseconds of launch latency dominate. The design's point is the
// launch count and the absence of host reads.
#include <cuda_runtime.h>

namespace ctt {
namespace gcg {

constexpr int kThreads = 1024;

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < nwarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// mode 0 rotation (diag = deg, n / 3 nodes), 1 positioning (diag = diag_c,
// n entries).
__global__ void setup_kernel(int mode, int n, float eps_rel, const float* __restrict__ b,
                             const float* __restrict__ diag, float* __restrict__ M,
                             float* __restrict__ x, float* __restrict__ r,
                             float* __restrict__ z, float* __restrict__ p,
                             double* __restrict__ scal) {
  __shared__ double scratch[32];
  float shift = 0.f;
  if (mode == 1) {
    double acc = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) acc += (double)diag[i];
    const double mean = block_sum(acc, scratch) / (double)(n > 0 ? n : 1);
    shift = eps_rel * (float)mean;
  }
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float m;
    if (mode == 0) {
      const float d = diag[i / 3];
      m = d > 1e-12f ? 1.f / d : 0.f;
    } else {
      m = 1.f / (diag[i] + shift + 1e-30f);
    }
    const float ri = b[i], zi = m * ri;
    M[i] = m;
    x[i] = 0.f;
    r[i] = ri;
    z[i] = zi;
    p[i] = zi;
    acc += (double)ri * (double)zi;
  }
  const double rz = block_sum(acc, scratch);
  if (threadIdx.x == 0) {
    scal[0] = rz;
    scal[1] = rz;
  }
}

__global__ void step_kernel(int mode, int n, const float* __restrict__ M,
                            const float* __restrict__ Ap, float* __restrict__ x,
                            float* __restrict__ r, float* __restrict__ z, float* __restrict__ p,
                            double* __restrict__ scal) {
  __shared__ double scratch[32];
  const double rz = scal[0];
  // The freeze rule (positioning): every thread reads the same scal, so the
  // whole block leaves together.
  if (mode == 1 && !(rz > 1e-12 * scal[1])) return;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += (double)p[i] * (double)Ap[i];
  const double pAp = block_sum(acc, scratch);
  const float alpha = (float)(rz / fmax(pAp, 1e-30));
  acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] += alpha * p[i];
    const float ri = r[i] - alpha * Ap[i];
    const float zi = M[i] * ri;
    r[i] = ri;
    z[i] = zi;
    acc += (double)ri * (double)zi;
  }
  const double rz_new = block_sum(acc, scratch);
  const float beta = (float)(rz_new / fmax(rz, 1e-30));
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = z[i] + beta * p[i];
  if (threadIdx.x == 0) scal[0] = rz_new;
}

}  // namespace gcg
}  // namespace ctt

// b, diag, M, x, r, z, p: n = 3 x nodes floats (diag: deg, one a node, in
// mode 0; diag_c, n entries, in mode 1); scal two doubles (rz, rz0).
extern "C" int global_cg_setup_f32(int mode, int n, float eps_rel, const float* b,
                                   const float* diag, float* M, float* x, float* r, float* z,
                                   float* p, double* scal, cudaStream_t stream) {
  ctt::gcg::setup_kernel<<<1, ctt::gcg::kThreads, 0, stream>>>(mode, n, eps_rel, b, diag, M, x,
                                                               r, z, p, scal);
  return (int)cudaGetLastError();
}

// Ap: the matvec's product with p (n floats).
extern "C" int global_cg_step_f32(int mode, int n, const float* M, const float* Ap, float* x,
                                  float* r, float* z, float* p, double* scal,
                                  cudaStream_t stream) {
  ctt::gcg::step_kernel<<<1, ctt::gcg::kThreads, 0, stream>>>(mode, n, M, Ap, x, r, z, p, scal);
  return (int)cudaGetLastError();
}
