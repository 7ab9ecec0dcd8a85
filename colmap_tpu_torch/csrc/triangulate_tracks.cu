// K8 triangulate_tracks: robust triangulation of a batch of tracks.
//
// Replaces colmap_tpu/estimators/triangulation.py estimate_triangulation
// (l.72) with _pair_dlt (l.36) and _angular_errors, vmapped over the rows
// of sfm/incremental_triangulator.py (l.52), and
// geometry/triangulation.py triangulate_multi_view (l.16) and
// triangulation_angle.
//
// One warp per track of V = 8 view slots. Lanes 0-27 take the view pairs
// (i < j) in row-major order, each:
//   - the 4x4 DLT of the pair, solved as the smallest eigenvector of A^T A
//     by Jacobi (the JAX code takes the SVD of A; the null vector is the
//     same up to sign, which the division by w removes);
//   - the pair's triangulation angle at the point (law of cosines);
//   - the angular error of the point against all 8 views (pi behind a
//     camera) and the support, 0 for an invalid pair, a pair below the
//     minimum angle or a non-finite point.
// A warp max on (support, 31 - lane) picks the best pair, the first on
// ties (jnp.argmax). Lanes 0-7 then add their inlier view's term to the
// N-view system sum termᵀ term (term = P - x̂ x̂ᵀ P), reduced over the
// warp; lane 0 takes its smallest eigenvector; lanes 0-7 score the refit,
// which is kept when it has at least as many inliers and is finite. Output:
// xyz, inlier mask, success = (inliers >= 2) & (best support >= 2).
//
// With robust = 0 the kernel is triangulate_multi_view alone, the
// triangulator's creation path without RANSAC (robust_creation=False): the
// pair search is skipped, every valid view enters the N-view system, and the
// output is its point, the valid views as the mask and success = (views >= 2).
//
// Bound on the card: operations, about 28 x (4x4 Jacobi, ~2000 flops, and
// 8 angular errors with an arccos) per track, all in registers; the inputs
// (8 x 14 floats a track) are read once. One warp per track keeps a track's
// pairs in one warp so the best-of and the refit need only shuffles.
#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kV = 8;
constexpr int kPairs = kV * (kV - 1) / 2;
constexpr int kTriWarps = 4;

struct TrackData {
  float P[kV][12];  // [R | t] row-major
  float C[kV][3];   // camera centers -R^T t
  float x[kV][2];
  bool m[kV];
};

__device__ __forceinline__ float angular_error(const TrackData& T, int v, const float* X) {
  const float* P = T.P[v];
  const float xc = P[0] * X[0] + P[1] * X[1] + P[2] * X[2] + P[3];
  const float yc = P[4] * X[0] + P[5] * X[1] + P[6] * X[2] + P[7];
  const float zc = P[8] * X[0] + P[9] * X[1] + P[10] * X[2] + P[11];
  const float u = T.x[v][0], w = T.x[v][1];
  const float no = sqrtf(u * u + w * w + 1.f);
  const float ne = fmaxf(sqrtf(xc * xc + yc * yc + zc * zc), 1e-12f);
  const float cs = (u * xc + w * yc + zc) / (no * ne);
  const float ang = acosf(fminf(fmaxf(cs, -1.f), 1.f));
  return zc > 0.f ? ang : kPiF;
}

__device__ __forceinline__ float tri_angle(const float* c1, const float* c2, const float* X) {
  float b2 = 0.f, r1 = 0.f, r2 = 0.f;
  for (int i = 0; i < 3; ++i) {
    b2 += (c1[i] - c2[i]) * (c1[i] - c2[i]);
    r1 += (X[i] - c1[i]) * (X[i] - c1[i]);
    r2 += (X[i] - c2[i]) * (X[i] - c2[i]);
  }
  const float cs = (r1 + r2 - b2) / (2.f * sqrtf(fmaxf(r1 * r2, 1e-30f)));
  const float a = acosf(fminf(fmaxf(cs, -1.f), 1.f));
  return fminf(a, kPiF - a);
}

__global__ void triangulate_tracks_kernel(int b, int robust, float min_angle, float max_err,
                                          const float* __restrict__ R, const float* __restrict__ t,
                                          const float* __restrict__ x,
                                          const unsigned char* __restrict__ mask,
                                          float* __restrict__ xyz, unsigned char* __restrict__ inl_out,
                                          unsigned char* __restrict__ success) {
  __shared__ TrackData tracks[kTriWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int track = blockIdx.x * kTriWarps + warp;
  if (track >= b) return;  // whole warps leave together
  TrackData& T = tracks[warp];
  if (lane < kV) {
    const long long o = (long long)track * kV + lane;
    float* P = T.P[lane];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) P[i * 4 + j] = R[o * 9 + i * 3 + j];
      P[i * 4 + 3] = t[o * 3 + i];
    }
    for (int j = 0; j < 3; ++j)
      T.C[lane][j] = -(P[j] * P[3] + P[4 + j] * P[7] + P[8 + j] * P[11]);
    T.x[lane][0] = x[o * 2];
    T.x[lane][1] = x[o * 2 + 1];
    T.m[lane] = mask[o] != 0;
  }
  __syncwarp();
  // Lane -> pair (i, j), i < j, row-major.
  int pi = 0, pj = 0;
  {
    int l = lane, i = 0;
    while (i < kV - 1 && l >= kV - 1 - i) {
      l -= kV - 1 - i;
      ++i;
    }
    pi = i;
    pj = i + 1 + l;
  }
  float X[3] = {0.f, 0.f, 0.f};
  int support = 0;
  unsigned inl_bits = 0;
  if (robust && lane < kPairs) {
    const float* P1 = T.P[pi];
    const float* P2 = T.P[pj];
    float A[4][4];
    for (int k = 0; k < 4; ++k) {
      A[0][k] = T.x[pi][0] * P1[8 + k] - P1[k];
      A[1][k] = T.x[pi][1] * P1[8 + k] - P1[4 + k];
      A[2][k] = T.x[pj][0] * P2[8 + k] - P2[k];
      A[3][k] = T.x[pj][1] * P2[8 + k] - P2[4 + k];
    }
    float AtA[16], Xh[4];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c)
        AtA[r * 4 + c] = A[0][r] * A[0][c] + A[1][r] * A[1][c] + A[2][r] * A[2][c] + A[3][r] * A[3][c];
    smallest_eigvec<4>(AtA, Xh, 8);
    const float w = fabsf(Xh[3]) < 1e-12f ? 1.f : Xh[3];
    for (int i = 0; i < 3; ++i) X[i] = Xh[i] / w;
    const bool ok = T.m[pi] && T.m[pj] && tri_angle(T.C[pi], T.C[pj], X) >= min_angle &&
                    all_finite(X, 3);
    for (int v = 0; v < kV; ++v)
      if (T.m[v] && angular_error(T, v, X) <= max_err) {
        ++support;
        inl_bits |= 1u << v;
      }
    if (!ok) support = 0;
  }
  const unsigned key = ((unsigned)support << 8) | (unsigned)(31 - lane);
  const unsigned best_key = __reduce_max_sync(kFull, key);
  const int best = 31 - (int)(best_key & 0xffu);
  const int best_support = (int)(best_key >> 8);
  float Xb[3];
  for (int i = 0; i < 3; ++i) Xb[i] = __shfl_sync(kFull, X[i], best);
  // Without RANSAC every valid view is an inlier of the N-view system.
  const unsigned inl = robust ? __shfl_sync(kFull, inl_bits, best)
                              : __ballot_sync(kFull, lane < kV && T.m[lane]);
  // N-view refit on the best pair's inliers: 10 entries of the 4x4 system.
  float sys[10];
  for (int q = 0; q < 10; ++q) sys[q] = 0.f;
  if (lane < kV && ((inl >> lane) & 1u)) {
    const float* P = T.P[lane];
    const float n = sqrtf(T.x[lane][0] * T.x[lane][0] + T.x[lane][1] * T.x[lane][1] + 1.f);
    const float xh[3] = {T.x[lane][0] / n, T.x[lane][1] / n, 1.f / n};
    float term[12];
    for (int c = 0; c < 4; ++c) {
      const float d = xh[0] * P[c] + xh[1] * P[4 + c] + xh[2] * P[8 + c];  // (x̂ᵀ P)_c
      for (int r = 0; r < 3; ++r) term[r * 4 + c] = P[r * 4 + c] - xh[r] * d;
    }
    int q = 0;
    for (int r = 0; r < 4; ++r)
      for (int c = r; c < 4; ++c)
        sys[q++] = term[r] * term[c] + term[4 + r] * term[4 + c] + term[8 + r] * term[8 + c];
  }
  for (int q = 0; q < 10; ++q) sys[q] = warp_sum(sys[q]);
  float Xr[3] = {0.f, 0.f, 0.f};
  if (lane == 0) {
    float M[16], Xh[4];
    int q = 0;
    for (int r = 0; r < 4; ++r)
      for (int c = r; c < 4; ++c) {
        M[r * 4 + c] = sys[q];
        M[c * 4 + r] = sys[q++];
      }
    smallest_eigvec<4>(M, Xh, 8);
    const float w = fabsf(Xh[3]) < 1e-30f ? 1e-30f : Xh[3];
    for (int i = 0; i < 3; ++i) Xr[i] = Xh[i] / w;
  }
  for (int i = 0; i < 3; ++i) Xr[i] = __shfl_sync(kFull, Xr[i], 0);
  const bool in_ref = lane < kV && T.m[lane] && angular_error(T, lane, Xr) <= max_err;
  const unsigned inl_ref = __ballot_sync(kFull, in_ref);
  if (lane == 0) {
    const bool take = !robust || (__popc(inl_ref) >= __popc(inl) && all_finite(Xr, 3));
    const unsigned bits = robust && take ? inl_ref : inl;
    for (int i = 0; i < 3; ++i) xyz[track * 3 + i] = take ? Xr[i] : Xb[i];
    for (int v = 0; v < kV; ++v) inl_out[track * kV + v] = (bits >> v) & 1u;
    success[track] = __popc(bits) >= 2 && (!robust || best_support >= 2);
  }
}

}  // namespace ctt

extern "C" int triangulate_tracks_f32(int b, int robust, float min_angle, float max_err,
                                      const float* R, const float* t, const float* x,
                                      const unsigned char* mask, float* xyz, unsigned char* inl,
                                      unsigned char* success, void* stream) {
  using namespace ctt;
  const unsigned blocks = (unsigned)((b + kTriWarps - 1) / kTriWarps);
  triangulate_tracks_kernel<<<blocks, 32 * kTriWarps, 0, (cudaStream_t)stream>>>(
      b, robust, min_angle, max_err, R, t, x, mask, xyz, inl, success);
  return (int)cudaGetLastError();
}
