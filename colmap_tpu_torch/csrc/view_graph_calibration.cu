// K23 view_graph_calibration: the focal-refinement loss and its gradient.
//
// Replaces colmap_tpu/estimators/view_graph_calibration.py K_of, loss and
// the jitted jax.value_and_grad (l.58-76). Per edge (F between cameras a
// and b, log-scales x):
//   f = f0 · exp(x), K = [[f, 0, cx], [0, f, cy], [0, 0, 1]],
//   E = K_bᵀ F K_a, its two largest singular values σ0 ≥ σ1 and vectors,
//   res = (σ0 − σ1) / max(σ0 + σ1, 1e-12), loss term res²,
//   and its gradient in x_a and x_b through ∂σ_k = u_kᵀ ∂E v_k (the formula
//   JAX's SVD derivative uses) with ∂K/∂x = diag(f, f, 0):
//   ∂E/∂x_a = K_bᵀ F diag(f_a, f_a, 0), ∂E/∂x_b = diag(f_b, f_b, 0) F K_a.
// Then per camera the sum of its edges' gradient terms (an edge whose two
// images share a camera gives it both), and the loss in one block.
//
// Precision: F is ~1e-7 and K ~1e3, and res compares two singular values,
// so the per-edge arithmetic (E, EᵀE's Jacobi eigensolve, the vectors and
// the gradient) runs in float64, as K19 does for its angles; the log-scales
// come in and the gradient goes out in float32.
//
// Layout: each camera's incidence list (CSR, built once per solve) holds
// 2e for the edges where it is camera a and 2e + 1 where it is camera b,
// which index the per-edge gradient pairs directly. A warp sums a camera's
// list by shuffles; no atomics.
//
// Bound on the card: operations, in float64 (a 3x3 Jacobi eigensolve and a
// few 3x3 products per edge); 2000 edges are 8 blocks of threads, so the
// launch costs more than the arithmetic.
#include <cuda_runtime.h>
#include <math.h>

#include "global_common.cuh"

namespace ctt {
namespace vgc {

using gsfm::kBlock;

// Cyclic Jacobi on symmetric 3x3 A (row-major, in place), the algebraic
// rotation and skip rule of small_linalg.cuh's jacobi_eigh, in float64.
__device__ void jacobi3(double* A, double* V, int sweeps) {
  for (int i = 0; i < 9; ++i) V[i] = (i / 3 == i % 3) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        const double apq = A[p * 3 + q];
        const double diff = A[q * 3 + q] - A[p * 3 + p];
        if (apq == 0.0 || fabs(apq) * 1e15 < fabs(diff)) continue;
        const double tau = diff / (2.0 * apq);
        const double t = tau == 0.0 ? 1.0 : copysign(1.0, tau) / (fabs(tau) + sqrt(1.0 + tau * tau));
        const double c = 1.0 / sqrt(1.0 + t * t), s = t * c;
        for (int k = 0; k < 3; ++k) {
          const double akp = A[k * 3 + p], akq = A[k * 3 + q];
          A[k * 3 + p] = c * akp - s * akq;
          A[k * 3 + q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          const double apk = A[p * 3 + k], aqk = A[q * 3 + k];
          A[p * 3 + k] = c * apk - s * aqk;
          A[q * 3 + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          const double vkp = V[k * 3 + p], vkq = V[k * 3 + q];
          V[k * 3 + p] = c * vkp - s * vkq;
          V[k * 3 + q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
edge_kernel(int E, const double* __restrict__ Fs, const int* __restrict__ e1,
            const int* __restrict__ e2, const double* __restrict__ f0,
            const double* __restrict__ pp, const float* __restrict__ x,
            double* __restrict__ res2, double* __restrict__ g) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= E) return;
  const int ca = e1[e], cb = e2[e];
  const double fa = f0[ca] * exp((double)x[ca]), fb = f0[cb] * exp((double)x[cb]);
  const double Ka[9] = {fa, 0.0, pp[2 * ca], 0.0, fa, pp[2 * ca + 1], 0.0, 0.0, 1.0};
  const double Kb[9] = {fb, 0.0, pp[2 * cb], 0.0, fb, pp[2 * cb + 1], 0.0, 0.0, 1.0};
  const double* F = Fs + 9LL * e;
  double A[9], B[9], M[9];  // A = K_bᵀ F, B = F K_a, M = E = A K_a
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      A[r * 3 + c] = Kb[0 * 3 + r] * F[0 * 3 + c] + Kb[1 * 3 + r] * F[1 * 3 + c] +
                     Kb[2 * 3 + r] * F[2 * 3 + c];
      B[r * 3 + c] = F[r * 3 + 0] * Ka[0 * 3 + c] + F[r * 3 + 1] * Ka[1 * 3 + c] +
                     F[r * 3 + 2] * Ka[2 * 3 + c];
    }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      M[r * 3 + c] = A[r * 3 + 0] * Ka[0 * 3 + c] + A[r * 3 + 1] * Ka[1 * 3 + c] +
                     A[r * 3 + 2] * Ka[2 * 3 + c];
  double MtM[9], V[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      MtM[i * 3 + j] = M[i] * M[j] + M[3 + i] * M[3 + j] + M[6 + i] * M[6 + j];
  jacobi3(MtM, V, 12);
  // The largest (i0) and second largest (i1) eigenvalues.
  int i0 = 0;
  for (int i = 1; i < 3; ++i)
    if (MtM[i * 4] > MtM[i0 * 4]) i0 = i;
  int i1 = i0 == 0 ? 1 : 0;
  for (int i = 0; i < 3; ++i)
    if (i != i0 && MtM[i * 4] > MtM[i1 * 4]) i1 = i;
  const double s0 = sqrt(fmax(MtM[i0 * 4], 0.0)), s1 = sqrt(fmax(MtM[i1 * 4], 0.0));
  double v0[3], v1[3], u0[3], u1[3];
  for (int r = 0; r < 3; ++r) {
    v0[r] = V[r * 3 + i0];
    v1[r] = V[r * 3 + i1];
  }
  for (int r = 0; r < 3; ++r) {
    u0[r] = (M[r * 3] * v0[0] + M[r * 3 + 1] * v0[1] + M[r * 3 + 2] * v0[2]) / fmax(s0, 1e-300);
    u1[r] = (M[r * 3] * v1[0] + M[r * 3 + 1] * v1[1] + M[r * 3 + 2] * v1[2]) / fmax(s1, 1e-300);
  }
  const double dot01 = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
  for (int r = 0; r < 3; ++r) u1[r] -= dot01 * u0[r];
  const double n1 = fmax(sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]), 1e-300);
  for (int r = 0; r < 3; ++r) u1[r] /= n1;
  const double sum = s0 + s1;
  const double den = fmax(sum, 1e-12);
  const double res = (s0 - s1) / den;
  // d res / d σ0, d σ1 (the max(·, 1e-12) passes no gradient below it).
  const double dr0 = sum > 1e-12 ? 2.0 * s1 / (sum * sum) : 1.0 / den;
  const double dr1 = sum > 1e-12 ? -2.0 * s0 / (sum * sum) : -1.0 / den;
  // u_kᵀ ∂E/∂x_a v_k = f_a Σ_{c<2} (u_kᵀ A)_c v_kc;  u_kᵀ ∂E/∂x_b v_k = f_b Σ_{r<2} u_kr (B v_k)_r.
  double da[2], db[2];
  const double* us[2] = {u0, u1};
  const double* vs[2] = {v0, v1};
  for (int k = 0; k < 2; ++k) {
    const double *u = us[k], *v = vs[k];
    double ua = 0.0, bv = 0.0;
    for (int c = 0; c < 2; ++c) ua += (u[0] * A[c] + u[1] * A[3 + c] + u[2] * A[6 + c]) * v[c];
    for (int r = 0; r < 2; ++r) bv += u[r] * (B[r * 3] * v[0] + B[r * 3 + 1] * v[1] + B[r * 3 + 2] * v[2]);
    da[k] = fa * ua;
    db[k] = fb * bv;
  }
  res2[e] = res * res;
  g[2 * e] = 2.0 * res * (dr0 * da[0] + dr1 * da[1]);
  g[2 * e + 1] = 2.0 * res * (dr0 * db[0] + dr1 * db[1]);
}

// One warp per camera: the sum of its incidence list's gradient terms.
__global__ void __launch_bounds__(kBlock)
camera_kernel(int n, const int* __restrict__ offsets, const int* __restrict__ inc,
              const double* __restrict__ g, float* __restrict__ grad) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (c >= n) return;
  double s = 0.0;
  for (int k = offsets[c] + lane; k < offsets[c + 1]; k += 32) s += g[inc[k]];
  s = gsfm::warp_sum(s);
  if (lane == 0) grad[c] = (float)s;
}

__global__ void __launch_bounds__(kBlock)
loss_kernel(int E, const double* __restrict__ res2, double* __restrict__ loss) {
  __shared__ double scratch[kBlock / 32];
  double v[1] = {0.0};
  for (int e = threadIdx.x; e < E; e += kBlock) v[0] += res2[e];
  gsfm::block_sum<1>(v, scratch);
  if (threadIdx.x == 0) *loss = v[0];
}

}  // namespace vgc
}  // namespace ctt

// res2 (E,) and g (E, 2) are the wrapper's float64 scratch.
extern "C" int vgc_loss_grad_f32(int E, int n, const double* Fs, const int* e1, const int* e2,
                                 const double* f0, const double* pp, const float* x,
                                 const int* offsets, const int* inc, double* res2, double* g,
                                 float* grad, double* loss, void* stream) {
  using namespace ctt::vgc;
  cudaStream_t s = (cudaStream_t)stream;
  if (E > 0) edge_kernel<<<(E + kBlock - 1) / kBlock, kBlock, 0, s>>>(E, Fs, e1, e2, f0, pp, x,
                                                                    res2, g);
  if (n > 0) {
    const int per = kBlock / 32;
    camera_kernel<<<(n + per - 1) / per, kBlock, 0, s>>>(n, offsets, inc, g, grad);
  }
  loss_kernel<<<1, kBlock, 0, s>>>(E, res2, loss);
  return (int)cudaGetLastError();
}
