// K13 sift_pyramid: the SIFT scale stack.
//
// Replaces colmap_tpu/feature/sift.py _upsample2 (l.101), _blur (l.83),
// build_octave (l.127) and _downsample2 (l.107). Four launches:
//   - sift_upsample2: (H, W) -> (2H, 2W) bilinear with half-pixel centres
//     and clamped edges (jax.image.resize "bilinear" at a factor of 2):
//     out[2k] = 0.25 x[k-1] + 0.75 x[k], out[2k+1] = 0.75 x[k] + 0.25 x[k+1]
//     along the rows, then along the columns; one thread per output pixel.
//   - sift_blur_rows: the row pass of a separable Gaussian, (2r+1) taps
//     normalized to sum 1 (as _band_matrix normalizes its rows), edges
//     replicated. A block of 256 threads owns 256 outputs of one row and
//     stages the 256 + 2r inputs it needs in shared memory.
//   - sift_blur_cols: the column pass, same taps; a block of 32 x 8 threads
//     owns a 64-row x 32-column tile and stages (64 + 2r) x 32 inputs. Its
//     epilogue writes the level and, for build_octave, the DoG level - prev
//     (prev is the row pass's input, the level before), so the DoG costs no
//     pass of its own.
//   - sift_downsample2: x[::2, ::2] of gauss[S], the next octave's base.
// colmap_tpu's banded and selection matmuls (an MXU workaround) are not
// carried over: the stencil is direct.
//
// Bound on the card: bytes. A level reads the level before once and writes
// the level and its DoG (12 B a pixel); the row pass's intermediate adds a
// write and a read (8 B) that a fused version would keep on chip. The taps
// cost 2 (2r + 1) flops a pixel per pass (r <= 13 here), below the memory
// time at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace ctt {
namespace sift {

constexpr int kRowThreads = 256;
constexpr int kColTileX = 32, kColTileY = 64, kColThreadsY = 8;

__global__ void upsample2_kernel(int H, int W, const float* __restrict__ in,
                                 float* __restrict__ out) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= 2 * W || oy >= 2 * H) return;
  const int kx = ox >> 1, ky = oy >> 1;
  const int nx = (ox & 1) ? min(kx + 1, W - 1) : max(kx - 1, 0);
  const int ny = (oy & 1) ? min(ky + 1, H - 1) : max(ky - 1, 0);
  // Along the rows first (of input rows ky and ny), then along the columns.
  const float r0 = 0.75f * in[ky * W + kx] + 0.25f * in[ky * W + nx];
  const float r1 = 0.75f * in[ny * W + kx] + 0.25f * in[ny * W + nx];
  out[oy * (2 * W) + ox] = 0.75f * r0 + 0.25f * r1;
}

__global__ void blur_rows_kernel(int H, int W, int r, const float* __restrict__ taps,
                                 const float* __restrict__ in, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* staps = smem;               // 2r + 1
  float* tile = smem + 2 * r + 1;    // 256 + 2r
  const int y = blockIdx.y, x0 = blockIdx.x * kRowThreads;
  for (int i = threadIdx.x; i < 2 * r + 1; i += kRowThreads) staps[i] = taps[i];
  const float* row = in + (size_t)y * W;
  for (int i = threadIdx.x; i < kRowThreads + 2 * r; i += kRowThreads)
    tile[i] = row[min(max(x0 - r + i, 0), W - 1)];
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  float acc = staps[0] * tile[threadIdx.x];
  for (int k = 1; k <= 2 * r; ++k) acc += staps[k] * tile[threadIdx.x + k];
  out[(size_t)y * W + x] = acc;
}

__global__ void blur_cols_kernel(int H, int W, int r, const float* __restrict__ taps,
                                 const float* __restrict__ in, const float* __restrict__ prev,
                                 float* __restrict__ out, float* __restrict__ dog) {
  extern __shared__ float smem[];
  float* staps = smem;                 // 2r + 1
  float* tile = smem + 2 * r + 1;      // (64 + 2r) x 32
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * kColTileX + tx, y0 = blockIdx.y * kColTileY;
  const int tid = ty * kColTileX + tx;
  for (int i = tid; i < 2 * r + 1; i += kColTileX * kColThreadsY) staps[i] = taps[i];
  const int xc = min(x, W - 1);
  for (int i = ty; i < kColTileY + 2 * r; i += kColThreadsY)
    tile[i * kColTileX + tx] = in[(size_t)min(max(y0 - r + i, 0), H - 1) * W + xc];
  __syncthreads();
  if (x >= W) return;
  for (int m = ty; m < kColTileY; m += kColThreadsY) {
    const int y = y0 + m;
    if (y >= H) break;
    float acc = staps[0] * tile[m * kColTileX + tx];
    for (int k = 1; k <= 2 * r; ++k) acc += staps[k] * tile[(m + k) * kColTileX + tx];
    const size_t o = (size_t)y * W + x;
    out[o] = acc;
    if (dog) dog[o] = acc - prev[o];
  }
}

__global__ void downsample2_kernel(int H, int W, const float* __restrict__ in,
                                   float* __restrict__ out) {
  const int Wo = (W + 1) / 2, Ho = (H + 1) / 2;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wo || y >= Ho) return;
  out[(size_t)y * Wo + x] = in[(size_t)(2 * y) * W + 2 * x];
}

}  // namespace sift
}  // namespace ctt

extern "C" int sift_upsample2_f32(int H, int W, const float* in, float* out, void* stream) {
  using namespace ctt::sift;
  const dim3 block(32, 8), grid((2 * W + 31) / 32, (2 * H + 7) / 8);
  upsample2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(H, W, in, out);
  return (int)cudaGetLastError();
}

extern "C" int sift_blur_rows_f32(int H, int W, int r, const float* taps, const float* in,
                                  float* out, void* stream) {
  using namespace ctt::sift;
  const size_t smem = (size_t)(2 * r + 1 + kRowThreads + 2 * r) * sizeof(float);
  const dim3 grid((W + kRowThreads - 1) / kRowThreads, H);
  blur_rows_kernel<<<grid, kRowThreads, smem, (cudaStream_t)stream>>>(H, W, r, taps, in, out);
  return (int)cudaGetLastError();
}

extern "C" int sift_blur_cols_f32(int H, int W, int r, const float* taps, const float* in,
                                  const float* prev, float* out, float* dog, void* stream) {
  using namespace ctt::sift;
  const size_t smem = (size_t)(2 * r + 1 + (kColTileY + 2 * r) * kColTileX) * sizeof(float);
  const dim3 block(kColTileX, kColThreadsY);
  const dim3 grid((W + kColTileX - 1) / kColTileX, (H + kColTileY - 1) / kColTileY);
  blur_cols_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(H, W, r, taps, in, prev, out, dog);
  return (int)cudaGetLastError();
}

extern "C" int sift_downsample2_f32(int H, int W, const float* in, float* out, void* stream) {
  using namespace ctt::sift;
  const dim3 block(32, 8), grid(((W + 1) / 2 + 31) / 32, ((H + 1) / 2 + 7) / 8);
  downsample2_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(H, W, in, out);
  return (int)cudaGetLastError();
}
