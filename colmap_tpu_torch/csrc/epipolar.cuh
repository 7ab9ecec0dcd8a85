// The squared epipolar line distance shared by K11 and K46
// (geometry/essential.py squared_epipolar_line_distance): one definition,
// so that K46's supports and K11's inlier masks agree row for row.
#pragma once

#include <cuda_runtime.h>

namespace ctt {

// Squared distance of (u2, v2) to the line F (u1, v1, 1).
__device__ __forceinline__ float epipolar_line_sq(const float* F, float u1, float v1, float u2,
                                                  float v2) {
  const float a = F[0] * u1 + F[1] * v1 + F[2];
  const float b = F[3] * u1 + F[4] * v1 + F[5];
  const float c = F[6] * u1 + F[7] * v1 + F[8];
  const float r = u2 * a + v2 * b + c;
  return r * r / fmaxf(a * a + b * b, 1e-30f);
}

}  // namespace ctt
