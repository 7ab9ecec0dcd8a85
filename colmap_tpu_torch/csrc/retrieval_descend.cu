// K30 retrieval_descend: vocabulary-tree descent to a leaf word.
//
// Replaces colmap_tpu/retrieval/visual_index.py `_tree_descend` (l.117,
// jitted at l.139), which per level gathers every descriptor's (B, D)
// children into an (N, B, D) block and runs a batched einsum; the host
// pads descriptors into chunks of 65536 rows.
//
// Function: node = 0; at each of L levels child = argmin_j Σ_d (x_d -
// c[l][node, j, d])², the lowest j on exact ties, node = node B + child;
// the output is the leaf id node in [0, B^L).
// Layout: the levels are one (Σ_l B^(l+1), D) float32 tensor, level l's
// rows starting at Σ_{k<l} B^(k+1), node n's children at n B .. n B + B - 1.
// One warp a descriptor for all levels in one launch: lane l holds dims
// 4l..4l+3 of the row, and per child a butterfly of shuffles sums the 32
// partials. Float addition commutes, so every lane holds the same bits and
// takes the same branch.
// Bound on the card: bytes at depth 5, branching 8 and 2M rows (1 GB of rows,
// 0.3 ms; 3 operations x 40 children x 128 dims a row is 3.1e10, 0.46 ms at
// 67 TFLOP/s: the two are close). The children's rows (16 MB at 32 768
// leaves) stay in L2.
#include <cuda_runtime.h>
#include <math.h>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr int kDescendBlock = 256;

__global__ void __launch_bounds__(kDescendBlock)
descend_kernel(int N, int D4, int B, int L, const float4* __restrict__ x,
               const float4* __restrict__ levels, int* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * kDescendBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // the whole warp leaves together
  const bool on = lane < D4;
  const float4 xv = on ? __ldg(x + row * D4 + lane) : zero4();
  long long node = 0, base = 0, level_nodes = 1;
  for (int l = 0; l < L; ++l) {
    const float4* c = levels + (base + node * B) * D4;
    float best = INFINITY;
    int best_j = 0;
    for (int j = 0; j < B; ++j) {
      float4 acc = zero4();
      if (on) acc_sq(xv, __ldg(c + (long long)j * D4 + lane), acc);
      float d = total(acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (d < best) {
        best = d;
        best_j = j;
      }
    }
    base += level_nodes * B;
    level_nodes *= B;
    node = node * B + best_j;
  }
  if (lane == 0) out[row] = (int)node;
}

}  // namespace ret
}  // namespace ctt

// x (N, D) float32, D = 4 * D4 <= 128; levels (Σ_l B^(l+1), D) float32;
// out (N,) int32 leaf ids.
extern "C" int retrieval_descend_f32(int N, int D, int B, int L, const float* x,
                                     const float* levels, int* out, void* stream) {
  using namespace ctt::ret;
  if (N > 0 && L > 0) {
    descend_kernel<<<blocks_for((long long)N * 32, kDescendBlock), kDescendBlock, 0,
                     (cudaStream_t)stream>>>(N, D / 4, B, L, reinterpret_cast<const float4*>(x),
                                             reinterpret_cast<const float4*>(levels), out);
  }
  return (int)cudaGetLastError();
}
