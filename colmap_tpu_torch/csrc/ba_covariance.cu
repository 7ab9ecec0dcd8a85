// K54 ba_covariance_assemble: the reduced camera matrix of the BA covariance
//   S = H_cc - sum_points W (H_pp + diag(lam diag(H_pp) + 1e-12))^-1 WT + lam diag(H_cc)
// in float64 (D x D, D = 6F + CP), from K1's float32 Jacobians.
//
// Replaces colmap_tpu/estimators/covariance.py:22-78's S: jax.vmap of
// bundle_adjustment.py:351 _schur_matvec over the n columns of the identity
// (l.57), with the operators of _obs_jacobians (l.236), _apply_masks (l.276)
// and _build_schur (l.323). colmap_tpu runs n matvecs; this kernel assembles
// S directly, one point a block, as K4 (ba_dense_schur.cu) assembles the LM
// step's S, from whose staging it is designed. It differs from K4 in three
// ways, each needed by the covariance:
//   - everything past the float32 Jacobians is float64: each block forms its
//     point's H_pp = sum JxT Jx and the damped inverse itself in float64 (K2's
//     float32 Hpp_inv would drop a damping of 1e-8, below float32's step), and
//     S is accumulated with float64 atomics;
//   - the damping lam diag(H_cc) is added by the H_cc term itself, slot by
//     slot (lam J_a^2 on each diagonal entry), and nothing else is added to
//     the diagonal: K4's 1e-10 would make a gauge-fixed row read 1e-10, and
//     colmap_tpu finds the fixed rows by |S_ii| < 1e-12;
//   - so a row whose Jacobian column is masked (K1 multiplies it by its 0
//     mask, giving exact zeros) receives no term at all and stays exactly 0.
//
// One block per point (grid-stride). The block first sums its point's H_pp
// over its slots and inverts it (adjugate / determinant, a zero block when
// |det| <= 1e-12, as _inv3x3_spd), then works on tiles of up to kTile slots
// staged in shared memory: J = [Jp | Jc] (2 x K per slot, K = 6 + P), the
// coupling blocks W_k = J_kT Jx_k (K x 3), Z_k = W_k H_pp^-1, the rows of S
// each slot's entries go to, and the list of the tile's slots whose J row is
// not zero. For every pair of tiles and every pair of listed slots (k, l) and
// entries (a, b) it adds -Z_k[a] . W_l[b] into S at (row(k, a), row(l, b));
// the pair k == l also adds the H_cc term J_kT J_k, times (1 + lam) on the
// diagonal. Atomics make the order of the sums vary from run to run.
//
// Bound on the card: at the BA headline (200 frames x 50 000 points x
// 300 000 observations, capp 6, P 4) the bytes, the float32 Jacobians read
// once and the 1204 x 1204 float64 S written once, about 43 MB; the float64
// operations (a symmetric S_corr needs (nK)(nK + 1)/2 dot products of 3 a
// point with n slots) about 0.6 GFLOP. The kernel is far above both: each
// point adds n^2 K^2 entries (3600 at the headline) into S with float64
// atomics. A simple kernel first; a faster one (per-block S tiles in shared
// memory, or a GEMM of the stacked W and Z) is later work.
#include <cuda_runtime.h>

namespace ctt {

constexpr int kCovTile = 32;  // slots per tile: one warp builds a tile's list

// One staged tile in shared memory: the doubles first, then the ints.
struct CovTile {
  double* J;   // kCovTile x 2 x K
  double* X;   // kCovTile x 2 x 3
  double* W;   // kCovTile x K x 3
  double* Z;   // kCovTile x K x 3
  int* rows;   // kCovTile x K
  int* list;   // kCovTile: tile-local indices of slots with a non-zero J row
  int* count;  // 1
};

__host__ __device__ inline size_t cov_tile_bytes(int K) {
  const size_t doubles = (size_t)kCovTile * (8 * K + 6);
  const size_t ints = (size_t)kCovTile * (K + 1) + 1;
  return (8 * doubles + 4 * ints + 7) / 8 * 8;
}

__device__ inline CovTile cov_carve(unsigned char* base, int K) {
  CovTile t;
  t.J = reinterpret_cast<double*>(base);
  t.X = t.J + kCovTile * 2 * K;
  t.W = t.X + kCovTile * 6;
  t.Z = t.W + kCovTile * 3 * K;
  t.rows = reinterpret_cast<int*>(t.Z + kCovTile * 3 * K);
  t.list = t.rows + kCovTile * K;
  t.count = t.list + kCovTile;
  return t;
}

// Stage slots [s, s + n) (n <= kCovTile) of the point whose damped inverse
// block is H. Every thread of the block calls it; it ends with
// __syncthreads and returns the number of listed slots.
__device__ int cov_stage(const CovTile& t, long long s, int n, int F, int P, const double* H,
                         const float* __restrict__ Jp, const float* __restrict__ Jc,
                         const float* __restrict__ Jx, const int* __restrict__ fids,
                         const int* __restrict__ cids) {
  const int K = 6 + P, K2 = 2 * K;
  const int tid = threadIdx.x, bd = blockDim.x;
  for (int e = tid; e < n * K2; e += bd) {
    const int k = e / K2, i = (e % K2) / K, a = e % K;
    t.J[e] = a < 6 ? Jp[12 * (s + k) + 6 * i + a] : Jc[2 * P * (s + k) + P * i + a - 6];
  }
  for (int e = tid; e < n * 6; e += bd) t.X[e] = Jx[6 * s + e];
  for (int e = tid; e < n * K; e += bd) {
    const int k = e / K, a = e % K;
    t.rows[e] = a < 6 ? 6 * fids[s + k] + a : 6 * F + P * cids[s + k] + a - 6;
  }
  __syncthreads();
  if (tid < 32) {
    int nz = 0;
    if (tid < n)
      for (int q = 0; q < K2; ++q) nz |= t.J[tid * K2 + q] != 0.0;
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (nz) t.list[__popc(m & ((1u << tid) - 1u))] = tid;
    if (tid == 0) *t.count = __popc(m);
  }
  for (int e = tid; e < n * K * 3; e += bd) {
    const int k = e / (3 * K), a = (e / 3) % K, j = e % 3;
    t.W[e] = t.J[k * K2 + a] * t.X[6 * k + j] + t.J[k * K2 + K + a] * t.X[6 * k + 3 + j];
  }
  __syncthreads();
  for (int e = tid; e < n * K * 3; e += bd) {
    const int j = e % 3;
    const double* w = t.W + (e - j);
    t.Z[e] = w[0] * H[j] + w[1] * H[3 + j] + w[2] * H[6 + j];
  }
  __syncthreads();
  return *t.count;
}

// H (9 doubles, shared) <- (H_pp + diag(lam diag(H_pp) + 1e-12))^-1 of the
// point whose slots start at s0: six threads sum the upper triangle over
// the capp slots, one inverts. Ends with __syncthreads.
__device__ void point_inverse(long long s0, int capp, double lam, const float* __restrict__ Jx,
                              double* hpp, double* H) {
  const int tid = threadIdx.x;
  if (tid < 6) {
    const int i = tid < 3 ? 0 : (tid < 5 ? 1 : 2);
    const int j = tid < 3 ? tid : (tid < 5 ? tid - 2 : 2);
    double acc = 0.0;
    for (int q = 0; q < 2 * capp; ++q) {
      const float* x = Jx + 6 * s0 + 3 * q;
      acc += (double)x[i] * (double)x[j];
    }
    hpp[tid] = acc;  // 00 01 02 11 12 22
  }
  __syncthreads();
  if (tid == 0) {
    const double a = hpp[0] + (lam * hpp[0] + 1e-12), b = hpp[1], c = hpp[2];
    const double d = hpp[3] + (lam * hpp[3] + 1e-12), e = hpp[4];
    const double f = hpp[5] + (lam * hpp[5] + 1e-12);
    const double co00 = d * f - e * e, co01 = c * e - b * f, co02 = b * e - c * d;
    const double co11 = a * f - c * c, co12 = b * c - a * e, co22 = a * d - b * b;
    const double det = a * co00 + b * co01 + c * co02;
    const double s = fabs(det) > 1e-12 ? 1.0 / det : 0.0;
    H[0] = co00 * s; H[1] = co01 * s; H[2] = co02 * s;
    H[3] = co01 * s; H[4] = co11 * s; H[5] = co12 * s;
    H[6] = co02 * s; H[7] = co12 * s; H[8] = co22 * s;
  }
  __syncthreads();
}

__global__ void covariance_kernel(long long N, int capp, int F, int P, int D, double lam,
                                  const float* __restrict__ Jp, const float* __restrict__ Jc,
                                  const float* __restrict__ Jx, const int* __restrict__ fids,
                                  const int* __restrict__ cids, double* __restrict__ S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 6 + P, K2 = 2 * K;
  const CovTile A = cov_carve(smem, K);
  const CovTile B = cov_carve(smem + cov_tile_bytes(K), K);
  double* H = reinterpret_cast<double*>(smem + 2 * cov_tile_bytes(K));  // 3 x 3
  double* hpp = H + 9;                                                  // 6
  int* last = reinterpret_cast<int*>(hpp + 6);  // one past the point's last real slot
  const int tid = threadIdx.x, bd = blockDim.x;
  for (long long pt = blockIdx.x; pt < N; pt += gridDim.x) {
    const long long s0 = pt * capp;
    point_inverse(s0, capp, lam, Jx, hpp, H);
    int n_real = capp;
    if (capp > kCovTile) {
      if (tid == 0) *last = 0;
      __syncthreads();
      for (int k = tid; k < capp; k += bd) {
        bool nz = false;
        for (int q = 0; q < 12 && !nz; ++q) nz = Jp[12 * (s0 + k) + q] != 0.f;
        for (int q = 0; q < 2 * P && !nz; ++q) nz = Jc[2 * P * (s0 + k) + q] != 0.f;
        if (nz) atomicMax(last, k + 1);
      }
      __syncthreads();
      n_real = *last;
    }
    for (int ta = 0; ta < n_real; ta += kCovTile) {
      const int ma =
          cov_stage(A, s0 + ta, min(kCovTile, n_real - ta), F, P, H, Jp, Jc, Jx, fids, cids);
      if (ma == 0) continue;
      for (int tb = 0; tb < n_real; tb += kCovTile) {
        const bool same = tb == ta;
        const int mb = same ? ma
                            : cov_stage(B, s0 + tb, min(kCovTile, n_real - tb), F, P, H, Jp, Jc,
                                        Jx, fids, cids);
        const CovTile& T = same ? A : B;
        const int total = ma * mb * K * K;
        for (int e = tid; e < total; e += bd) {
          const int b = e % K;
          int r = e / K;
          const int a = r % K;
          r /= K;
          const int k = A.list[r / mb], l = T.list[r % mb];
          const double* zk = A.Z + 3 * (k * K + a);
          const double* wl = T.W + 3 * (l * K + b);
          double v = -(zk[0] * wl[0] + zk[1] * wl[1] + zk[2] * wl[2]);
          if (same && k == l) {
            const double h =
                A.J[k * K2 + a] * A.J[k * K2 + b] + A.J[k * K2 + K + a] * A.J[k * K2 + K + b];
            v += a == b ? h + lam * h : h;
          }
          if (v != 0.0) atomicAdd(S + (long long)A.rows[k * K + a] * D + T.rows[l * K + b], v);
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

}  // namespace ctt

// Jp (N capp, 2, 6), Jc (N capp, 2, P), Jx (N capp, 2, 3) float32 in the
// point-major layout; fids / cids (N, capp); S: D x D float64, zeroed by
// the caller; lam the damping (colmap_tpu's `damping`).
extern "C" int ba_covariance_assemble_f64(long long N, int capp, int F, int C, int P, double lam,
                                          const float* Jp, const float* Jc, const float* Jx,
                                          const int* fids, const int* cids, double* S,
                                          int num_sms, cudaStream_t stream) {
  const int D = 6 * F + C * P;
  const size_t smem = 2 * ctt::cov_tile_bytes(6 + P) + sizeof(double) * 15 + sizeof(int) * 2;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    long long blocks = N < 16LL * num_sms ? N : 16LL * num_sms;
    cudaError_t err = cudaFuncSetAttribute(
        ctt::covariance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ctt::covariance_kernel<<<(unsigned)blocks, 128, smem, stream>>>(N, capp, F, P, D, lam, Jp,
                                                                   Jc, Jx, fids, cids, S);
  }
  return (int)cudaGetLastError();
}
