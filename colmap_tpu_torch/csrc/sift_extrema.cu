// K14 sift_extrema: DoG extrema with subpixel refinement, fused.
//
// Replaces colmap_tpu/feature/sift.py _find_extrema (l.144) and
// _refine_candidates (l.181), with the level and sigma of
// _detect_octave_impl (l.602-604). One thread per sample (s, y, x) of the S
// inner DoG scales (grid x over columns, y over rows, z over scales):
//   1. the 3 x 3 x 3 maximum and minimum with colmap_tpu's >= and <= (a tie
//      with a neighbour counts), beyond +-0.8 peak_threshold, nothing on
//      the one-pixel border;
//   2. for an extremum, the gradient and Hessian of the DoG by central
//      differences (l.191-202), the 3 x 3 solve H delta = -g by LU with
//      partial pivoting (as LAPACK's getrf/getrs behind jnp.linalg.solve),
//      guarded by |det| > 1e-12 (identity otherwise), delta clipped to
//      +-1.5; the response, the contrast, edge and in-bounds tests; the
//      level clip(rint(s) + 1, 0, S + 2) and sigma = sigma0 2^((s + 1) / S);
//   3. one atomicAdd on a counter gives the extremum its slot in the output
//      lists (score |DoG|, flat index into (S, H, W), the refined row, the
//      level and the keep flag). A slot at or beyond the capacity is not
//      written, but the counter still counts it: the wrapper reads the
//      count and runs again with lists that large, so nothing is cut.
// The selection of the highest candidates (lax.top_k's order) runs on the
// compacted lists outside this kernel (kernels/sift.py select_candidates).
//
// Bound on the card: bytes, one read of the S + 2 DoG levels (4 B a sample
// of S + 2); almost every thread leaves after its first load (|DoG| at or
// below the threshold), the 26 neighbour loads of the rest hit L1/L2.
#include <cstddef>
#include <cuda_runtime.h>

namespace ctt {
namespace sift {

constexpr int kExtTX = 32, kExtTY = 8;

// LU with partial pivoting of a 3 x 3 (row-major, in place), the
// determinant, and the solve of A z = b.
__device__ __forceinline__ float lu3_det_solve(float* A, const float* b, float* z) {
  int perm[3] = {0, 1, 2};
  float sign = 1.f;
  for (int k = 0; k < 3; ++k) {
    int p = k;
    for (int i = k + 1; i < 3; ++i)
      if (fabsf(A[i * 3 + k]) > fabsf(A[p * 3 + k])) p = i;
    if (p != k) {
      for (int j = 0; j < 3; ++j) {
        const float t = A[k * 3 + j];
        A[k * 3 + j] = A[p * 3 + j];
        A[p * 3 + j] = t;
      }
      const int t = perm[k];
      perm[k] = perm[p];
      perm[p] = t;
      sign = -sign;
    }
    const float piv = A[k * 3 + k];
    for (int i = k + 1; i < 3; ++i) {
      const float l = piv != 0.f ? A[i * 3 + k] / piv : 0.f;
      A[i * 3 + k] = l;
      for (int j = k + 1; j < 3; ++j) A[i * 3 + j] -= l * A[k * 3 + j];
    }
  }
  float w[3];
  for (int i = 0; i < 3; ++i) {
    float v = b[perm[i]];
    for (int j = 0; j < i; ++j) v -= A[i * 3 + j] * w[j];
    w[i] = v;
  }
  for (int i = 2; i >= 0; --i) {
    float v = w[i];
    for (int j = i + 1; j < 3; ++j) v -= A[i * 3 + j] * z[j];
    z[i] = v / A[i * 3 + i];
  }
  return sign * A[0] * A[4] * A[8];
}

__global__ void extrema_kernel(int S, int H, int W, float thr, float peak_threshold,
                               float edge_ratio, float sigma0, int capacity,
                               const float* __restrict__ dog, int* __restrict__ counter,
                               float* __restrict__ score, int* __restrict__ flat,
                               float* __restrict__ rows, int* __restrict__ lvl,
                               unsigned char* __restrict__ keep_out) {
  const int x = blockIdx.x * kExtTX + threadIdx.x;
  const int y = blockIdx.y * kExtTY + threadIdx.y;
  const int ss = blockIdx.z;
  if (x < 1 || y < 1 || x > W - 2 || y > H - 2) return;
  const size_t HW = (size_t)H * W;
  const float* D = dog + (size_t)(ss + 1) * HW + (size_t)y * W + x;  // the centre
  const float c = D[0];
  if (!(c > thr || c < -thr)) return;
  bool is_max = c > thr, is_min = c < -thr;
  for (int ds = -1; ds <= 1; ++ds)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const float v = D[(ptrdiff_t)ds * (ptrdiff_t)HW + dy * W + dx];
        is_max = is_max && c >= v;
        is_min = is_min && c <= v;
      }
  if (!is_max && !is_min) return;

  auto d = [&](int ds, int dy, int dx) {
    return D[(ptrdiff_t)ds * (ptrdiff_t)HW + dy * W + dx];
  };
  const float gx = 0.5f * (d(0, 0, 1) - d(0, 0, -1));
  const float gy = 0.5f * (d(0, 1, 0) - d(0, -1, 0));
  const float gs = 0.5f * (d(1, 0, 0) - d(-1, 0, 0));
  const float dxx = d(0, 0, 1) + d(0, 0, -1) - 2.f * c;
  const float dyy = d(0, 1, 0) + d(0, -1, 0) - 2.f * c;
  const float dss = d(1, 0, 0) + d(-1, 0, 0) - 2.f * c;
  const float dxy = 0.25f * (d(0, 1, 1) - d(0, 1, -1) - d(0, -1, 1) + d(0, -1, -1));
  const float dxs = 0.25f * (d(1, 0, 1) - d(1, 0, -1) - d(-1, 0, 1) + d(-1, 0, -1));
  const float dys = 0.25f * (d(1, 1, 0) - d(1, -1, 0) - d(-1, 1, 0) + d(-1, -1, 0));
  float A[9] = {dxx, dxy, dxs, dxy, dyy, dys, dxs, dys, dss};
  const float g[3] = {gx, gy, gs};
  float z[3];
  const float det = lu3_det_solve(A, g, z);
  const bool ok_det = fabsf(det) > 1e-12f;
  float delta[3];
  for (int k = 0; k < 3; ++k) delta[k] = fminf(fmaxf(-(ok_det ? z[k] : g[k]), -1.5f), 1.5f);
  const float response = c + 0.5f * (g[0] * delta[0] + g[1] * delta[1] + g[2] * delta[2]);
  bool keep = ok_det && fabsf(response) > peak_threshold;
  const float tr = dxx + dyy;
  const float det2 = dxx * dyy - dxy * dxy;
  keep = keep && det2 > 0.f && tr * tr / fmaxf(det2, 1e-20f) < edge_ratio;
  const float x_ref = (float)x + delta[0];
  const float y_ref = (float)y + delta[1];
  const float s_ref = (float)ss + delta[2];
  keep = keep && x_ref >= 1.f && x_ref < (float)(W - 1) && y_ref >= 1.f && y_ref < (float)(H - 1);
  const float sigma = sigma0 * exp2f((s_ref + 1.f) / (float)S);
  const int level = min(max((int)rintf(s_ref) + 1, 0), S + 2);

  const int slot = atomicAdd(counter, 1);
  if (slot >= capacity) return;
  score[slot] = fabsf(c);
  flat[slot] = (int)((size_t)ss * HW + (size_t)y * W + x);
  float* row = rows + (size_t)slot * 5;
  row[0] = x_ref;
  row[1] = y_ref;
  row[2] = s_ref;
  row[3] = sigma;
  row[4] = response;
  lvl[slot] = level;
  keep_out[slot] = keep ? 1 : 0;
}

}  // namespace sift
}  // namespace ctt

extern "C" int sift_extrema_f32(int S, int H, int W, float thr, float peak_threshold,
                                float edge_ratio, float sigma0, int capacity, const float* dog,
                                int* counter, float* score, int* flat, float* rows, int* lvl,
                                unsigned char* keep, void* stream) {
  using namespace ctt::sift;
  if (S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kExtTX, kExtTY), grid((W + kExtTX - 1) / kExtTX, (H + kExtTY - 1) / kExtTY, S);
  extrema_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(S, H, W, thr, peak_threshold,
                                                           edge_ratio, sigma0, capacity, dog,
                                                           counter, score, flat, rows, lvl, keep);
  return (int)cudaGetLastError();
}
