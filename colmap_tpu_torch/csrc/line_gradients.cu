// K49 line_gradients: the Scharr gradients of one image and their level-line
// angles, in one pass.
//
// Replaces colmap_tpu/image/lines.py _gradients (l.61-82): a 3 x 3 Scharr
// cross-correlation (taps [[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]] / 32 for
// gx and their transpose for gy, as lax.conv_general_dilated computes it,
// without flipping) of the edge-padded image (jnp.pad mode "edge": the
// window's coordinates clamped to the image), then mag = sqrt(gx^2 + gy^2)
// and the level-line angle atan2(gy, gx) + pi/2 wrapped into [0, pi).
//
// One thread per output pixel, a 32 x 8 tile a block: the 3 x 3 window is
// read through L1 (neighbouring threads share its rows), the six non-zero
// taps a gradient are summed in float32, and the magnitude and the angle
// are written once each.
//
// Bound on the card: bytes. 4 bytes read and 8 written a pixel; a
// 3072 x 2304 view moves about 85 MB, about 25 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace ctt {
namespace lines {

constexpr int kTileX = 32, kTileY = 8;
constexpr float kPi = 3.14159265358979f;
constexpr float kHalfPi = 1.57079632679490f;

__global__ void __launch_bounds__(kTileX * kTileY)
gradients_kernel(int h, int w, const float* __restrict__ img, float* __restrict__ mag,
                 float* __restrict__ angle) {
  const int x = blockIdx.x * kTileX + threadIdx.x, y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int x0 = max(x - 1, 0), x2 = min(x + 1, w - 1);
  const int y0 = max(y - 1, 0), y2 = min(y + 1, h - 1);
  const float* r0 = img + (size_t)y0 * w;
  const float* r1 = img + (size_t)y * w;
  const float* r2 = img + (size_t)y2 * w;
  const float a00 = __ldg(r0 + x0), a01 = __ldg(r0 + x), a02 = __ldg(r0 + x2);
  const float a10 = __ldg(r1 + x0), a12 = __ldg(r1 + x2);
  const float a20 = __ldg(r2 + x0), a21 = __ldg(r2 + x), a22 = __ldg(r2 + x2);
  const float gx = (-3.f * a00 + 3.f * a02 - 10.f * a10 + 10.f * a12 - 3.f * a20 + 3.f * a22) *
                   (1.f / 32.f);
  const float gy = (-3.f * a00 - 10.f * a01 - 3.f * a02 + 3.f * a20 + 10.f * a21 + 3.f * a22) *
                   (1.f / 32.f);
  float a = atan2f(gy, gx) + kHalfPi;
  if (a >= kPi) a -= kPi;
  if (a < 0.f) a += kPi;
  const size_t i = (size_t)y * w + x;
  mag[i] = sqrtf(gx * gx + gy * gy);
  angle[i] = a;
}

}  // namespace lines
}  // namespace ctt

// img (h, w) float32; writes mag and angle (h, w) float32.
extern "C" int line_gradients_f32(int h, int w, const float* img, float* mag, float* angle,
                                  cudaStream_t stream) {
  using namespace ctt::lines;
  if (h > 0 && w > 0) {
    const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
    gradients_kernel<<<grid, dim3(kTileX, kTileY), 0, stream>>>(h, w, img, mag, angle);
  }
  return (int)cudaGetLastError();
}
