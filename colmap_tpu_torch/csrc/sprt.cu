// K47 sprt: Wald's sequential probability ratio test over RANSAC hypotheses.
//
// Replaces colmap_tpu/optim/sprt.py sprt_evaluate (l.53), an eager jnp
// program: each hypothesis' log likelihood ratio is the running sum over
// its rows of log(delta / epsilon) on an inlier (r <= max_sq), log((1 -
// delta) / (1 - epsilon)) on an outlier and 0 on an invalid row; it is
// rejected at the first row where the sum exceeds log A. colmap_tpu forms
// the whole (M, N) cumulative sum; here one warp per hypothesis walks its
// rows in order, 32 at a time: each lane takes one row's step, an inclusive
// warp scan (shuffles, float64) gives the running sums, one ballot finds
// the first row beyond log A, and the warp stops there. Outputs: accepted
// (1 byte) and the 1-based row of rejection (N for survivors).
//
// Bound on the card: bytes. A hypothesis reads 4 bytes for each row it
// evaluates (the rows up to its rejection, which this run's data decides)
// and the mask once; a row's work is a comparison, a select and a few
// float64 adds of the scan, far less time than its bytes at the float64
// peak.
#include <cuda_runtime.h>

namespace ctt {

constexpr int kSprtWarps = 4;

__global__ void sprt_kernel(int M, int N, double max_sq, double log_A, double log_in,
                            double log_out, const float* __restrict__ res,
                            const unsigned char* __restrict__ mask,
                            unsigned char* __restrict__ accepted, int* __restrict__ num_eval) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kSprtWarps + (threadIdx.x >> 5);
  if (h >= M) return;  // whole warps leave together
  const float* r = res + (size_t)h * N;
  double base = 0.0;
  for (int start = 0; start < N; start += 32) {
    const int i = start + lane;
    double v = 0.0;
    if (i < N && mask[i]) v = (double)r[i] <= max_sq ? log_in : log_out;
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    const unsigned rej = __ballot_sync(0xffffffffu, i < N && base + v > log_A);
    if (rej) {
      if (lane == 0) {
        accepted[h] = 0;
        num_eval[h] = start + __ffs(rej);  // 1-based
      }
      return;
    }
    base += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) {
    accepted[h] = 1;
    num_eval[h] = N;
  }
}

}  // namespace ctt

extern "C" int sprt_f32(int M, int N, double max_sq, double log_A, double log_in, double log_out,
                        const float* res, const unsigned char* mask, unsigned char* accepted,
                        int* num_eval, void* stream) {
  using namespace ctt;
  if (M == 0) return (int)cudaGetLastError();
  const int blocks = (M + kSprtWarps - 1) / kSprtWarps;
  sprt_kernel<<<blocks, 32 * kSprtWarps, 0, (cudaStream_t)stream>>>(
      M, N, max_sq, log_A, log_in, log_out, res, mask, accepted, num_eval);
  return (int)cudaGetLastError();
}
