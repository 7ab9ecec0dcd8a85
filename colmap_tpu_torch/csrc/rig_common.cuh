// The layout shared by the rig bundle-adjustment reductions (K25, K26).
//
// The camera side of a rig problem has R = F + G + C rows: frames (6
// columns, rotation then translation), sensors (6) and cameras (P), kept in
// (R, W) arrays whose unused columns are 0: W = kW (8) when P <= 8, else
// kWideW (17: the 16 parameters of RAD_TAN_THIN_PRISM_FISHEYE plus the
// model-position column of a problem that mixes models). The kernels take W
// as a template parameter. CSR lists built once per solve
// (colmap_tpu_torch/kernels/rig.py rig_layout) give each point's
// observations and each row's observations cut into chunks; a block sums a
// chunk in a fixed tree and one thread per row adds its chunks in order.
// No float atomics: two runs on the same inputs agree to the bit.
#pragma once

#include <cuda_runtime.h>

#include "global_common.cuh"

namespace ctt {
namespace rigba {

constexpr int kW = 8;
constexpr int kWideW = 17;
using gsfm::kBlock;

struct Layout {
  const int* pt_offsets;   // (N + 1,)
  const int* pt_obs;       // (O,) observation ids by point
  const int* seg_obs;      // (3O,) observation ids by camera-side row
  const int* chunk_row;    // (K,)
  const int* chunk_start;  // (K,) entries of seg_obs
  const int* chunk_end;    // (K,)
  const int* row_chunks;   // (R + 1,) chunks of each row
};

struct Jac {
  const float* jf;  // (O, 2, 6)
  const float* js;  // (O, 2, 6)
  const float* jc;  // (O, 2, P)
  const float* jx;  // (O, 2, 3)
};

// The Jacobian block (2 x width, row-major) of observation o in the family
// of camera-side row `row`.
__device__ __forceinline__ const float* row_block(const Jac& J, int row, int F, int G, int P,
                                                  long long o, int& width) {
  if (row < F) {
    width = 6;
    return J.jf + 12 * o;
  }
  if (row < F + G) {
    width = 6;
    return J.js + 12 * o;
  }
  width = P;
  return J.jc + 2LL * P * o;
}

// Sum of a chunk's NV per-thread values over the block; thread 0 writes
// them to out.
template <int NV>
__device__ __forceinline__ void chunk_sum(float* acc, float* scratch, float* out) {
  gsfm::block_sum<NV>(acc, scratch);
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) out[j] = acc[j];
}

}  // namespace rigba
}  // namespace ctt
