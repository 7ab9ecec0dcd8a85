// K17 pm_cost: the per-view matching cost of one plane per pixel.
//
// Replaces colmap_tpu/mvs/patch_match.py _per_view_costs (l.155) with
// _bilinear (l.83), _plane_depth_at (l.99) and _geom_consistency_cost
// (l.121): cost_all (S, H, W), 1 - clipped bilaterally weighted NCC of the
// pixel's plane over its (2R+1)^2 window warped into each source view, 2
// where under half of the window's weight lands in bounds, plus
// weight * min(geom, max_cost) when source depth maps are given.
//
// One thread per (view, pixel), pixels fastest, so a warp reads one row of
// the reference and neighbouring samples of one source. The body is
// pm_common.cuh's view_cost, which K18 calls for every candidate plane.
// The window is walked in registers: colmap_tpu's chunked lax.scan over
// the taps, which bounds the TPU's HBM, and its edge-padded copy of the
// reference (clamped reads here) are not carried over.
//
// Bound on the card: operations. A (view, pixel) reads its plane and the
// window's 25 reference pixels and 100 bilinear corners, almost all from
// L1 (neighbouring threads share them); a tap costs the reference weight
// with expf, the homography's offset and its division, the bounds test,
// the bilinear weights and six moments; the homography's set-up and the
// geometric term's round trip, in float64, once a (view, pixel).
#include <cuda_runtime.h>

#include "pm_common.cuh"

namespace ctt {
namespace pm {

__global__ void __launch_bounds__(kThreads)
cost_kernel(int S, int H, int W, Window win, Geom geom, const double* __restrict__ cams_g,
            const float* __restrict__ taps_g, int n_taps, const float* __restrict__ ref,
            const float* __restrict__ src, const float* __restrict__ depth,
            const float* __restrict__ normal, float* __restrict__ out) {
  __shared__ double cams[kCamDoubles];
  __shared__ float taps[kMaxTaps];
  to_shared(cams, cams_g, 18 + kViewDoubles * S);
  to_shared(taps, taps_g, n_taps);
  __syncthreads();
  win.taps = taps;
  const size_t HW = (size_t)H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)S * HW) return;
  const int s = (int)(i / HW);
  const int p = (int)(i % HW);
  const int y = p / W, x = p % W;
  const float d = depth[p];
  out[i] = view_cost(cams, win, geom, ref, src, H, W, s, y, x, d,
                     plane_at(cams, y, x, d, load3(normal, p)));
}

}  // namespace pm
}  // namespace ctt

extern "C" int pm_cost_f32(int S, int H, int W, int R, int step, float inv_2sc2, float geom_weight,
                           float geom_max, const double* cams, const float* taps, const float* ref,
                           const float* src, const float* src_depths, const float* depth,
                           const float* normal, float* out, void* stream) {
  using namespace ctt::pm;
  const int side = 2 * R / step + 1;
  const Window win{R, step, inv_2sc2, nullptr};
  const Geom geom{src_depths, geom_weight, geom_max};
  const size_t n = (size_t)S * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cost_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(S, H, W, win, geom, cams, taps,
                                                             side * side, ref, src, depth, normal,
                                                             out);
  return (int)cudaGetLastError();
}
