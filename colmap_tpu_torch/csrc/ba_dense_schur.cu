// K4 ba_dense_schur_assemble: the explicit reduced camera matrix
//   S = H_cc - sum_points W Hpp^-1 WT + diag(lam D + 1e-10)   (D x D, D = 6F + CP)
// for the dense Cholesky solve.
//
// Replaces colmap_tpu/estimators/bundle_adjustment.py _dense_schur_solve
// (l.1490-1635) up to the Cholesky, which stays torch.linalg.cholesky_ex /
// cholesky_solve as JAX left it to XLA's library routine. The JAX version
// builds S_corr as a dense (3N x D) QT Q product on the MXU with a bfloat16
// Q (l.1533-1537); this kernel is block-sparse and float32 throughout.
//
// One block per point (grid-stride). The block works on tiles of up to
// kTile slots of the point, staged in shared memory: J = [Jp | Jc] (2 x K per
// slot, K = 6 + P), the coupling blocks W_k = J_kT Jx_k (K x 3),
// Z_k = W_k Hpp^-1, the rows of S each slot's entries go to, and the list of
// the tile's slots whose J row is not zero. For every pair of tiles (A, B)
// and every pair of listed slots (k in A, l in B) and entries (a, b) it adds
// -Z_k[a] . W_l[b] into S at (row(k, a), row(l, b)), where row() is the pose
// entry 6 f + a or the camera entry 6F + P c + a - 6; the pair k == l also
// adds the H_cc term J_kT J_k (pose 6x6 on the frame diagonal, pose-camera
// and camera-camera blocks). A first kernel writes lam D + 1e-10 on the
// diagonal of the zeroed S; without lam_diag it is left out, and S is one
// rank's part of H_cc - S_corr, which a point-sharded solve sums over its
// ranks before it adds the diagonal once (colmap_tpu l.1635). Atomics make
// the order of the sums vary from run to run.
//
// Track length: tiles make any track length fit in shared memory, and the
// work follows each point's own track: slots with a zero J row (padding up
// to capp, constant blocks) are left out of the lists, and a point whose
// track is longer than one tile first finds its last real slot, so tiles of
// padding are never staged.
//
// Bound on the card: at the headline shapes (capp = 6, P = 4) the bytes, the
// Jacobians read once and S written once, about 41 MB; the operations (a
// symmetric S_corr needs (nK)(nK + 1)/2 dot products of 3 per point with n
// slots) take about as long. The kernel is far above both: each point adds
// n^2 K^2 entries (3600 at the headline) into S with global atomics.
#include <cuda_runtime.h>

#include "ba_common.cuh"

namespace ctt {

constexpr int kTile = 32;  // slots per tile: one warp builds a tile's list

// One staged tile in shared memory.
struct Tile {
  float* J;    // kTile x 2 x K
  float* X;    // kTile x 2 x 3
  float* W;    // kTile x K x 3
  float* Z;    // kTile x K x 3
  int* rows;   // kTile x K
  int* list;   // kTile: tile-local indices of slots with a non-zero J row
  int* count;  // 1
};

__host__ __device__ inline size_t tile_words(int K) { return (size_t)kTile * (9 * K + 7) + 1; }

__device__ inline Tile carve(int* base, int K) {
  Tile t;
  float* f = reinterpret_cast<float*>(base);
  t.J = f;
  t.X = t.J + kTile * 2 * K;
  t.W = t.X + kTile * 6;
  t.Z = t.W + kTile * 3 * K;
  t.rows = reinterpret_cast<int*>(t.Z + kTile * 3 * K);
  t.list = t.rows + kTile * K;
  t.count = t.list + kTile;
  return t;
}

// Stage slots [s, s + n) (n <= kTile) of the point whose inverse block is H.
// Every thread of the block calls it; it ends with __syncthreads and returns
// the number of listed slots.
__device__ int stage(const Tile& t, long long s, int n, int F, int P, const float* H,
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
      for (int q = 0; q < K2; ++q) nz |= t.J[tid * K2 + q] != 0.f;
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
    const float* w = t.W + (e - j);
    t.Z[e] = w[0] * H[j] + w[1] * H[3 + j] + w[2] * H[6 + j];
  }
  __syncthreads();
  return *t.count;
}

__global__ void set_diagonal(int D, const float* __restrict__ lam_diag, float* __restrict__ S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < D) S[(long long)i * D + i] = lam_diag[i] + 1e-10f;
}

__global__ void dense_schur_kernel(long long N, int capp, int F, int P, int D,
                                   const float* __restrict__ Jp, const float* __restrict__ Jc,
                                   const float* __restrict__ Jx, const int* __restrict__ fids,
                                   const int* __restrict__ cids, const float* __restrict__ hinv,
                                   float* __restrict__ S) {
  extern __shared__ int sm[];
  const int K = 6 + P, K2 = 2 * K;
  const Tile A = carve(sm, K);
  const Tile B = carve(sm + tile_words(K), K);
  float* H = reinterpret_cast<float*>(sm + 2 * tile_words(K));  // 3 x 3
  int* last = reinterpret_cast<int*>(H + 9);  // one past the point's last real slot
  const int tid = threadIdx.x, bd = blockDim.x;
  for (long long pt = blockIdx.x; pt < N; pt += gridDim.x) {
    const long long s0 = pt * capp;
    if (tid < 9) H[tid] = hinv[9 * pt + tid];
    int n_real = capp;
    if (capp > kTile) {
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
    for (int ta = 0; ta < n_real; ta += kTile) {
      const int ma = stage(A, s0 + ta, min(kTile, n_real - ta), F, P, H, Jp, Jc, Jx, fids, cids);
      if (ma == 0) continue;
      for (int tb = 0; tb < n_real; tb += kTile) {
        const bool same = tb == ta;
        const int mb =
            same ? ma : stage(B, s0 + tb, min(kTile, n_real - tb), F, P, H, Jp, Jc, Jx, fids, cids);
        const Tile& T = same ? A : B;
        const int total = ma * mb * K * K;
        for (int e = tid; e < total; e += bd) {
          const int b = e % K;
          int r = e / K;
          const int a = r % K;
          r /= K;
          const int k = A.list[r / mb], l = T.list[r % mb];
          const float* zk = A.Z + 3 * (k * K + a);
          const float* wl = T.W + 3 * (l * K + b);
          float v = -(zk[0] * wl[0] + zk[1] * wl[1] + zk[2] * wl[2]);
          if (same && k == l)
            v += A.J[k * K2 + a] * A.J[k * K2 + b] + A.J[k * K2 + K + a] * A.J[k * K2 + K + b];
          if (v != 0.f) atomicAdd(S + (long long)A.rows[k * K + a] * D + T.rows[l * K + b], v);
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

}  // namespace ctt

// S: D x D, zeroed by the caller; lam_diag: the D damping terms lam * diag(H_cc),
// or null for no diagonal step.
extern "C" int ba_dense_schur_assemble_f32(long long N, int capp, int F, int C, int P,
                                           const float* Jp, const float* Jc, const float* Jx,
                                           const int* fids, const int* cids, const float* hinv,
                                           const float* lam_diag, float* S, int num_sms,
                                           cudaStream_t stream) {
  const int D = 6 * F + C * P;
  const size_t smem = sizeof(int) * (2 * ctt::tile_words(6 + P) + 10);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (D > 0 && lam_diag != nullptr) ctt::set_diagonal<<<(D + 255) / 256, 256, 0, stream>>>(D, lam_diag, S);
  if (N > 0) {
    long long blocks = N < 16LL * num_sms ? N : 16LL * num_sms;
    cudaFuncSetAttribute(ctt::dense_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    ctt::dense_schur_kernel<<<(unsigned)blocks, 128, smem, stream>>>(N, capp, F, P, D, Jp, Jc, Jx,
                                                                    fids, cids, hinv, S);
  }
  return (int)cudaGetLastError();
}
