// K20 pm_view_selection: pixelwise view-selection probabilities.
//
// Replaces colmap_tpu/mvs/patch_match.py _update_sel_prob (l.338) with
// _chain_messages (l.306) and _ncc_prob (l.295): along each column (axis 0)
// or row (axis 1) of every view, the hidden Markov chain's forward message
// alpha and backward message beta from the emission
// exp(-c^2 / (2 ncc_sigma^2)) * norm of the cost c, then the posterior
// alpha beta / ((1 - alpha)(1 - beta) + alpha beta), blended with the
// previous map: prev_weight * sel_prob + (1 - prev_weight) * posterior.
//
// One thread per (view, line) walks the line twice: the forward pass stores
// alpha in the output, the backward pass recomputes the emission, carries
// beta and overwrites alpha with the blended posterior. Along H a warp reads
// 32 neighbouring columns, one row at a time (coalesced); along W its lanes
// read 32 rows W floats apart (uncoalesced).
//
// The messages are carried as odds, alpha / (1 - alpha): in float32 a
// probability within 1e-7 of 1 keeps no digit of 1 - alpha, which the
// posterior needs, and long runs of low or high cost drive the messages
// there. In odds the recursions are
//   forward   a' = (a NC + C) e / ((a C + NC) U)
//   backward  b' = (b e NC + U C) / (b e C + U NC)
// (NC = 0.99999, C = 1 - NC, U = 0.5, e the emission), the same function
// as colmap_tpu's, and the posterior is a b / (1 + a b). The emission stays
// at or above ncc_prob's value at the largest cost, so the odds stay within
// about 1e-10 and 1e10.
//
// Bound on the card: bytes. It reads the costs twice and the previous map
// once and writes the map twice, against about 30 f32 operations a sample.
#include <cuda_runtime.h>

#include "pm_common.cuh"

namespace ctt {
namespace pm {

__global__ void __launch_bounds__(kThreads)
view_selection_kernel(int S, int H, int W, int axis, float prev_weight, float inv_2s2, float norm,
                      const float* __restrict__ cost, const float* __restrict__ sel_prob,
                      float* __restrict__ out) {
  const size_t HW = (size_t)H * W;
  const int lines_per_view = axis == 0 ? W : H;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)S * lines_per_view) return;
  const int s = (int)(i / lines_per_view), line = (int)(i % lines_per_view);
  const size_t base = s * HW + (axis == 0 ? (size_t)line : (size_t)line * W);
  const size_t stride = axis == 0 ? (size_t)W : 1;
  const int L = axis == 0 ? H : W;
  float odds = 1.f;  // the initial message 0.5
  for (int k = 0; k < L; ++k) {
    const float c = cost[base + k * stride];
    const float e = expf(-(c * c) * inv_2s2) * norm;
    odds = (odds * kNoChange + kChange) * e / ((odds * kChange + kNoChange) * kUniform);
    out[base + k * stride] = odds;
  }
  odds = 1.f;
  for (int k = L - 1; k >= 0; --k) {
    const size_t q = base + k * stride;
    const float c = cost[q];
    const float e = expf(-(c * c) * inv_2s2) * norm;
    odds = (odds * e * kNoChange + kUniform * kChange) / (odds * e * kChange + kUniform * kNoChange);
    const float ab = out[q] * odds;
    out[q] = prev_weight * sel_prob[q] + (1.f - prev_weight) * (ab / (1.f + ab));
  }
}

}  // namespace pm
}  // namespace ctt

extern "C" int pm_view_selection_f32(int S, int H, int W, int axis, float prev_weight,
                                     float inv_2s2, float norm, const float* cost,
                                     const float* sel_prob, float* out, void* stream) {
  using namespace ctt::pm;
  const size_t n = (size_t)S * (axis == 0 ? W : H);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  view_selection_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      S, H, W, axis, prev_weight, inv_2s2, norm, cost, sel_prob, out);
  return (int)cudaGetLastError();
}
