// K34 ba_pcg: preconditioned CG on the damped reduced camera system, around
// K3's matvec.
//
// Replaces colmap_tpu/estimators/bundle_adjustment.py _packed_pcg (l.986-1036)
// apart from _packed_matvec, which stays K3: the block-Jacobi preconditioner
// (l.993-1002: 6x6 inverses of the pose blocks of H_cc + diag(lam diag_pose +
// 1e-10), scalar Jacobi for the camera parameters), the start vectors, and
// the fori_loop body's vector work and scalars (l.1015-1032). `_pcg`'s scalar
// Jacobi preconditioner (l.397-404, the one `solve` runs) is the set-up's
// second mode.
//
// The vectors are flat float32 arrays of n = 6F + CP entries, poses first:
// x, r, z, p, and K3's product Ap (its pose and camera parts). Three entries:
//   ba_pcg_setup  M (36F + CP floats: one 6x6 block per frame, a diagonal
//                 block in scalar mode, then the camera entries), x = 0,
//                 r = b, z = M r, p = z and rz = r.z into scal[0];
//   ba_pcg_setup_diag  (c), the rig BA's set-up (colmap_tpu/estimators/
//                 bundle_adjustment_rig.py _pcg, l.281-296): M given (K25's
//                 Jacobi preconditioner of the (R, W) camera-side tensor, R W
//                 scalars), x = 0, r = b, z = M r, p = z, rz into scal[0];
//   ba_pcg_step   after K3 wrote Ap = S p: Ap += lam D p, pAp = p.Ap,
//                 alpha = rz / pAp (0 where |pAp| <= 1e-30), x += alpha p,
//                 r -= alpha Ap, z = M r, rz_new = r.z, beta = rz_new / rz (0
//                 where |rz| <= 1e-30), p = z + beta p, scal[0] = rz_new.
// A PCG iteration is then two launches (K3, step) with alpha, beta and rz in
// device memory, where the torch version took about 17. The rig's PCG runs
// the step with F = 0 (every entry a scalar of M) and no D: K26's product
// already holds its damping, so the step skips Ap += lam D p where the
// diagonal pointers are null. Its padding columns are 0 in b and M, so they
// stay 0 in x, r, z and p.
//
// The step runs by a launch plan that the wrapper computes from F and CP
// (kernels/solver.py pcg_step_plan):
//   one warp   where F <= 32 and CP <= 128, which holds the mapper's local
//              BAs (the weighed classes have F 4-8 and CP 4-8). Lane l owns
//              frame l (its 6 entries and its 6x6 block of M), then camera
//              entries l + 32 j (1, 2 or 4 a lane, an instance each), so
//              z = M r reads only the lane's own r: no barrier and no round
//              trip through global memory. Every load (p, Ap, the diagonal,
//              M, x, r, scal[0], lam) is issued first and the entries stay in
//              registers through the step; the two dot products are
//              xor-shuffle trees.
//   one block  of 1024 threads for more frames or camera entries (the BA
//              headline, 200 frames; the 4200-frame check problem), striding
//              over the vector with a block barrier before z = M r; each dot
//              product is a shuffle tree over the warp, then a second over
//              the warps' sums. The set-up entries take the same reduction.
//              (Two frames a lane, with M's 36-float blocks loaded a lane
//              each, measured slower than the block at 64 frames on the H100.)
// Every sum runs in a fixed order (each thread its entries in order, then
// the trees), with no atomics, so two runs agree to the bit; an xor tree
// leaves the same sum on every lane. The 6x6 inverses (Gauss-Jordan with
// partial pivoting) and the dot products run in float64; the vectors stay
// float32.
//
// Bound on the card: neither bytes nor operations. n is at most a few
// thousand on the mapper and the BA headline, ~25 000 on the 4200-frame
// check problem; a step moves 7n floats plus 36F for M. What remains is
// the launch and one dependent chain: the loads, a tree, the divide, a
// tree, the stores. The one-warp plan leaves the chain one round trip to
// memory and no barrier; the block plan two round trips and five barriers.
#include <cuda_runtime.h>

namespace ctt {

constexpr int kPcgSetupThreads = 256;
constexpr int kPcgStepThreads = 1024;

// Sum over the warp by an xor tree; every lane gets the same sum.
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of one double per thread over the block; every thread gets the sum.
// `scratch` holds 32 doubles. Fixed order: a tree over each warp, then a
// tree over the warps' sums.
__device__ __forceinline__ double block_sum_d(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  v = warp_sum_d(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = warp_sum_d(lane < nwarps ? scratch[lane] : 0.0);
  __syncthreads();
  return v;
}

// In place: A (6x6, row-major) <- A^-1 by Gauss-Jordan with partial
// pivoting; a zero matrix where a pivot vanishes.
__device__ void invert6(double* A) {
  double B[36];
  for (int i = 0; i < 36; ++i) B[i] = (i / 6 == i % 6) ? 1.0 : 0.0;
  bool ok = true;
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[r * 6 + c]) > fabs(A[piv * 6 + c])) piv = r;
    if (!(fabs(A[piv * 6 + c]) > 0.0)) {
      ok = false;
      break;
    }
    if (piv != c)
      for (int k = 0; k < 6; ++k) {
        double t = A[c * 6 + k];
        A[c * 6 + k] = A[piv * 6 + k];
        A[piv * 6 + k] = t;
        t = B[c * 6 + k];
        B[c * 6 + k] = B[piv * 6 + k];
        B[piv * 6 + k] = t;
      }
    const double inv = 1.0 / A[c * 6 + c];
    for (int k = 0; k < 6; ++k) {
      A[c * 6 + k] *= inv;
      B[c * 6 + k] *= inv;
    }
    for (int r = 0; r < 6; ++r) {
      if (r == c) continue;
      const double f = A[r * 6 + c];
      if (f == 0.0) continue;
      for (int k = 0; k < 6; ++k) {
        A[r * 6 + k] -= f * A[c * 6 + k];
        B[r * 6 + k] -= f * B[c * 6 + k];
      }
    }
  }
  for (int i = 0; i < 36; ++i) A[i] = ok ? B[i] : 0.0;
}

// (M v)_i: the frame's 6x6 block times its 6 entries for a pose entry, the
// scalar for a camera entry.
__device__ __forceinline__ float precond(const float* __restrict__ M, const float* v, int F,
                                         int i) {
  const int n_pose = 6 * F;
  if (i >= n_pose) return M[36 * F + (i - n_pose)] * v[i];
  const int f = i / 6, a = i - 6 * f;
  const float* m = M + 36 * f + 6 * a;
  const float* w = v + 6 * f;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) s += m[j] * w[j];
  return s;
}

__global__ void pcg_setup_kernel(int F, int CP, int block_jacobi, const float* __restrict__ lam_p,
                                 const float* __restrict__ hcc,
                                 const float* __restrict__ diag_pose,
                                 const float* __restrict__ diag_cam,
                                 const float* __restrict__ bp, const float* __restrict__ bc,
                                 float* __restrict__ M, float* __restrict__ x,
                                 float* __restrict__ r, float* __restrict__ z,
                                 float* __restrict__ p, double* __restrict__ scal) {
  __shared__ double scratch[32];
  const float lam = *lam_p;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    if (block_jacobi) {
      double A[36];
      for (int i = 0; i < 36; ++i) A[i] = (double)hcc[36 * f + i];
      for (int a = 0; a < 6; ++a)
        A[7 * a] += (double)(lam * diag_pose[6 * f + a]) + 1e-10;
      invert6(A);
      for (int i = 0; i < 36; ++i) M[36 * f + i] = (float)A[i];
    } else {
      for (int i = 0; i < 36; ++i) M[36 * f + i] = 0.f;
      for (int a = 0; a < 6; ++a) {
        const float d = diag_pose[6 * f + a];
        const float dp = d + lam * d;
        M[36 * f + 7 * a] = dp > 1e-12f ? 1.f / dp : 0.f;
      }
    }
  }
  for (int c = threadIdx.x; c < CP; c += blockDim.x) {
    const float d = diag_cam[c];
    const float dc = d + lam * d;
    M[36 * F + c] = dc > 1e-12f ? 1.f / dc : 0.f;
  }
  const int n_pose = 6 * F, n = n_pose + CP;
  for (int i = threadIdx.x; i < n; i += blockDim.x) r[i] = i < n_pose ? bp[i] : bc[i - n_pose];
  __syncthreads();
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float zi = precond(M, r, F, i);
    x[i] = 0.f;
    z[i] = zi;
    p[i] = zi;
    acc += (double)r[i] * (double)zi;
  }
  const double rz = block_sum_d(acc, scratch);
  if (threadIdx.x == 0) scal[0] = rz;
}

__global__ void pcg_step_kernel(int F, int CP, const float* __restrict__ lam_p,
                                const float* __restrict__ diag_pose,
                                const float* __restrict__ diag_cam, const float* __restrict__ M,
                                float* __restrict__ Ap_p, float* __restrict__ Ap_c,
                                float* __restrict__ x,
                                float* __restrict__ r, float* __restrict__ z,
                                float* __restrict__ p, double* __restrict__ scal) {
  __shared__ double scratch[32];
  const bool damped = diag_cam != nullptr;
  const float lam = damped ? *lam_p : 0.f;
  const int n_pose = 6 * F, n = n_pose + CP;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float* ap_i = i < n_pose ? Ap_p + i : Ap_c + (i - n_pose);
    const float pi = p[i];
    float ap = *ap_i;
    if (damped) {
      const float d = i < n_pose ? diag_pose[i] : diag_cam[i - n_pose];
      ap += lam * d * pi;
      *ap_i = ap;
    }
    acc += (double)pi * (double)ap;
  }
  const double pAp = block_sum_d(acc, scratch);
  const double rz = scal[0];
  const float alpha = (float)(fabs(pAp) > 1e-30 ? rz / pAp : 0.0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    x[i] += alpha * p[i];
    r[i] -= alpha * (i < n_pose ? Ap_p[i] : Ap_c[i - n_pose]);
  }
  __syncthreads();  // z = M r reads the whole frame's entries of r
  acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float zi = precond(M, r, F, i);
    z[i] = zi;
    acc += (double)r[i] * (double)zi;
  }
  const double rz_new = block_sum_d(acc, scratch);
  const float beta = (float)(fabs(rz) > 1e-30 ? rz_new / rz : 0.0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = z[i] + beta * p[i];
  if (threadIdx.x == 0) scal[0] = rz_new;
}

// The one-warp step: lane l owns frame l (F <= 32) and camera entries
// l + 32 j (j < CPL); entries beyond F or CP load and store nothing and
// add 0 to the sums.
template <int CPL>
__global__ void __launch_bounds__(32)
    pcg_step_warp_kernel(int F, int CP, const float* __restrict__ lam_p,
                         const float* __restrict__ diag_pose, const float* __restrict__ diag_cam,
                         const float* __restrict__ M, float* __restrict__ Ap_p,
                         float* __restrict__ Ap_c, float* __restrict__ x, float* __restrict__ r,
                         float* __restrict__ z, float* __restrict__ p,
                         double* __restrict__ scal) {
  const int lane = threadIdx.x;
  const bool damped = diag_cam != nullptr;
  const bool own = lane < F;
  const int i0 = 6 * lane;
  const float* Mc = M + 36 * F;
  float* pc_ = p + 6 * F;
  float* xc_ = x + 6 * F;
  float* rc_ = r + 6 * F;
  float* zc_ = z + 6 * F;
  float fp[6], fa[6], fd[6], fx[6], fr[6], fm[36];
  float cp[CPL], ca[CPL], cd[CPL], cx[CPL], cr[CPL], cm[CPL];
  bool cown[CPL];
  const double rz = scal[0];
  const float lam = damped ? *lam_p : 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    fp[a] = own ? p[i0 + a] : 0.f;
    fa[a] = own ? Ap_p[i0 + a] : 0.f;
    fd[a] = own && damped ? diag_pose[i0 + a] : 0.f;
    fx[a] = own ? x[i0 + a] : 0.f;
    fr[a] = own ? r[i0 + a] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 36; ++e) fm[e] = own ? M[36 * lane + e] : 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    cown[j] = c < CP;
    cp[j] = cown[j] ? pc_[c] : 0.f;
    ca[j] = cown[j] ? Ap_c[c] : 0.f;
    cd[j] = cown[j] && damped ? diag_cam[c] : 0.f;
    cx[j] = cown[j] ? xc_[c] : 0.f;
    cr[j] = cown[j] ? rc_[c] : 0.f;
    cm[j] = cown[j] ? Mc[c] : 0.f;
  }
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    if (damped) fa[a] += lam * fd[a] * fp[a];
    acc += (double)fp[a] * (double)fa[a];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (damped) ca[j] += lam * cd[j] * cp[j];
    acc += (double)cp[j] * (double)ca[j];
  }
  const double pAp = warp_sum_d(acc);
  const float alpha = (float)(fabs(pAp) > 1e-30 ? rz / pAp : 0.0);
  acc = 0.0;
  float fz[6], cz[CPL];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    fx[a] += alpha * fp[a];
    fr[a] -= alpha * fa[a];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) s += fm[6 * a + b] * fr[b];
    fz[a] = s;
    acc += (double)fr[a] * (double)s;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    cx[j] += alpha * cp[j];
    cr[j] -= alpha * ca[j];
    cz[j] = cm[j] * cr[j];
    acc += (double)cr[j] * (double)cz[j];
  }
  const double rz_new = warp_sum_d(acc);
  const float beta = (float)(fabs(rz) > 1e-30 ? rz_new / rz : 0.0);
  if (own) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      if (damped) Ap_p[i0 + a] = fa[a];
      x[i0 + a] = fx[a];
      r[i0 + a] = fr[a];
      z[i0 + a] = fz[a];
      p[i0 + a] = fz[a] + beta * fp[a];
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!cown[j]) continue;
    const int c = lane + 32 * j;
    if (damped) Ap_c[c] = ca[j];
    xc_[c] = cx[j];
    rc_[c] = cr[j];
    zc_[c] = cz[j];
    pc_[c] = cz[j] + beta * cp[j];
  }
  if (lane == 0) scal[0] = rz_new;
}

__global__ void pcg_setup_diag_kernel(int n, const float* __restrict__ M,
                                      const float* __restrict__ b, float* __restrict__ x,
                                      float* __restrict__ r, float* __restrict__ z,
                                      float* __restrict__ p, double* __restrict__ scal) {
  __shared__ double scratch[32];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float ri = b[i];
    const float zi = M[i] * ri;
    x[i] = 0.f;
    r[i] = ri;
    z[i] = zi;
    p[i] = zi;
    acc += (double)ri * (double)zi;
  }
  const double rz = block_sum_d(acc, scratch);
  if (threadIdx.x == 0) scal[0] = rz;
}

}  // namespace ctt

// (c): M and b (n), x, r, z, p (n) written; scal one double.
extern "C" int ba_pcg_setup_diag_f32(int n, const float* M, const float* b, float* x, float* r,
                                     float* z, float* p, double* scal, cudaStream_t stream) {
  ctt::pcg_setup_diag_kernel<<<1, ctt::kPcgSetupThreads, 0, stream>>>(n, M, b, x, r, z, p, scal);
  return (int)cudaGetLastError();
}

// hcc (F, 6, 6), diag_pose / bp (F, 6), diag_cam / bc (C*P); lam one float and
// scal one double in device memory; M (36F + CP), x, r, z, p (6F + CP).
extern "C" int ba_pcg_setup_f32(int F, int CP, int block_jacobi, const float* lam,
                                const float* hcc, const float* diag_pose, const float* diag_cam,
                                const float* bp, const float* bc, float* M, float* x, float* r,
                                float* z, float* p, double* scal, cudaStream_t stream) {
  ctt::pcg_setup_kernel<<<1, ctt::kPcgSetupThreads, 0, stream>>>(
      F, CP, block_jacobi, lam, hcc, diag_pose, diag_cam, bp, bc, M, x, r, z, p, scal);
  return (int)cudaGetLastError();
}

// Ap_p (6F), Ap_c (CP): K3's product S p, updated in place to (S + lam D) p;
// with diag_pose, diag_cam and lam null, S p as it is (the rig's K26
// product, F = 0). cpl: the plan, camera entries a lane of the one-warp
// step (1, 2 or 4, with F <= 32), or 0 for the block.
extern "C" int ba_pcg_step_f32(int F, int CP, int cpl, const float* lam, const float* diag_pose,
                               const float* diag_cam, const float* M, float* Ap_p, float* Ap_c,
                               float* x, float* r, float* z, float* p, double* scal,
                               cudaStream_t stream) {
  if (cpl != 0 && (F > 32 || CP > 32 * cpl)) return (int)cudaErrorInvalidValue;
  if (cpl == 1)
    ctt::pcg_step_warp_kernel<1><<<1, 32, 0, stream>>>(F, CP, lam, diag_pose, diag_cam, M, Ap_p,
                                                       Ap_c, x, r, z, p, scal);
  else if (cpl == 2)
    ctt::pcg_step_warp_kernel<2><<<1, 32, 0, stream>>>(F, CP, lam, diag_pose, diag_cam, M, Ap_p,
                                                       Ap_c, x, r, z, p, scal);
  else if (cpl == 4)
    ctt::pcg_step_warp_kernel<4><<<1, 32, 0, stream>>>(F, CP, lam, diag_pose, diag_cam, M, Ap_p,
                                                       Ap_c, x, r, z, p, scal);
  else if (cpl == 0)
    ctt::pcg_step_kernel<<<1, ctt::kPcgStepThreads, 0, stream>>>(
        F, CP, lam, diag_pose, diag_cam, M, Ap_p, Ap_c, x, r, z, p, scal);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
