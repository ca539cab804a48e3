// The row-scaled 4x4 inverse shared by the hand-written kernels
// (gbp_slot.cu, ir_slot.cu): the device counterpart of
// magics_tpu_torch/core/linalg.py:inv4_rowscaled, with the Pallas kernels'
// guard that a zero determinant divides by 1 instead (the callers' det
// guards then empty the result).
#pragma once

#include <math.h>

// Lam = D^-1 M with D = diag(1/rowmax), Lam^-1 = M^-1 D. Returns the
// determinant of the scaled matrix.
__device__ __forceinline__ float inv4_rowscaled(const float m[4][4], float inv[4][4]) {
  float d[4], a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float rm = fmaxf(fmaxf(fabsf(m[i][0]), fabsf(m[i][1])),
                     fmaxf(fabsf(m[i][2]), fabsf(m[i][3])));
    d[i] = rm > 0.f ? 1.f / rm : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = m[i][j] * d[i];
  }
  const float c01 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float c02 = a[0][0] * a[1][2] - a[0][2] * a[1][0];
  const float c03 = a[0][0] * a[1][3] - a[0][3] * a[1][0];
  const float c12 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c13 = a[0][1] * a[1][3] - a[0][3] * a[1][1];
  const float c23 = a[0][2] * a[1][3] - a[0][3] * a[1][2];
  const float d01 = a[2][0] * a[3][1] - a[2][1] * a[3][0];
  const float d02 = a[2][0] * a[3][2] - a[2][2] * a[3][0];
  const float d03 = a[2][0] * a[3][3] - a[2][3] * a[3][0];
  const float d12 = a[2][1] * a[3][2] - a[2][2] * a[3][1];
  const float d13 = a[2][1] * a[3][3] - a[2][3] * a[3][1];
  const float d23 = a[2][2] * a[3][3] - a[2][3] * a[3][2];
  const float det = c01 * d23 - c02 * d13 + c03 * d12 + c12 * d03 - c13 * d02 + c23 * d01;
  const float adj[4][4] = {
      {a[1][1] * d23 - a[1][2] * d13 + a[1][3] * d12,
       -a[0][1] * d23 + a[0][2] * d13 - a[0][3] * d12,
       a[3][1] * c23 - a[3][2] * c13 + a[3][3] * c12,
       -a[2][1] * c23 + a[2][2] * c13 - a[2][3] * c12},
      {-a[1][0] * d23 + a[1][2] * d03 - a[1][3] * d02,
       a[0][0] * d23 - a[0][2] * d03 + a[0][3] * d02,
       -a[3][0] * c23 + a[3][2] * c03 - a[3][3] * c02,
       a[2][0] * c23 - a[2][2] * c03 + a[2][3] * c02},
      {a[1][0] * d13 - a[1][1] * d03 + a[1][3] * d01,
       -a[0][0] * d13 + a[0][1] * d03 - a[0][3] * d01,
       a[3][0] * c13 - a[3][1] * c03 + a[3][3] * c01,
       -a[2][0] * c13 + a[2][1] * c03 - a[2][3] * c01},
      {-a[1][0] * d12 + a[1][1] * d02 - a[1][2] * d01,
       a[0][0] * d12 - a[0][1] * d02 + a[0][2] * d01,
       -a[3][0] * c12 + a[3][1] * c02 - a[3][2] * c01,
       a[2][0] * c12 - a[2][1] * c02 + a[2][2] * c01}};
  const float safe_det = det == 0.f ? 1.f : det;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) inv[i][j] = adj[i][j] / safe_det * d[j];
  return det;
}
