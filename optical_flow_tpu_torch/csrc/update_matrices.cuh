// The per-pixel Farnebäck update-matrices arithmetic shared by K1
// (update_blur.cu) and K5a (update_matrices.cu), so that the two paths
// build M by the same instructions and K5a -> K5b equals K1 to the bit.
//
//   1. fetch R1 at (clamp(rint(y + dy)), clamp(rint(x + dx))); when the
//      rounded target leaves the image only R0 terms are used;
//   2. assemble M = (G11, G12, G22, h1, h2), scaled by the 5-px border
//      weights.
//
// Rounding is rintf (half to even, as cvRound); the inside test is taken
// on the rounded coordinates before clamping.  The arithmetic follows the
// plain version (models/farneback/core.py:update_matrices) op for op
// (--fmad=false).  Plane offsets are int64.

#pragma once

#include <cuda_runtime.h>

namespace oft {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// OpenCV's UpdateMatrices border factor along one axis, multiplied in the
// order of border_scale_field (per k: the leading edge, then the trailing).
__device__ __forceinline__ float border_weight(int i, int n) {
  const float bw[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
  float w = 1.0f;
  const int lim = n < 5 ? n : 5;
  for (int k = 0; k < lim; ++k) {
    if (i == k) w *= bw[k];
    if (i == n - 1 - k) w *= bw[k];
  }
  return w;
}

// M at pixel (y, x) of one frame pair: r0, r1 point at (5, H, W) planes,
// fl at the (2, H, W) flow, plane = H * W.
__device__ __forceinline__ void matrices_at(const float* __restrict__ r0,
                                            const float* __restrict__ r1,
                                            const float* __restrict__ fl,
                                            int y, int x, int H, int W,
                                            long long plane, float* m) {
  const long long p = static_cast<long long>(y) * W + x;
  const float dx = fl[p];
  const float dy = fl[plane + p];
  const float fx = rintf(static_cast<float>(x) + dx);
  const float fy = rintf(static_cast<float>(y) + dy);
  const bool inside = fx >= 0.0f && fx <= static_cast<float>(W - 1) &&
                      fy >= 0.0f && fy <= static_cast<float>(H - 1);
  const int xi = static_cast<int>(fminf(fmaxf(fx, 0.0f), static_cast<float>(W - 1)));
  const int yi = static_cast<int>(fminf(fmaxf(fy, 0.0f), static_cast<float>(H - 1)));
  const long long q = static_cast<long long>(yi) * W + xi;
  const float a0 = r0[p], a1 = r0[plane + p], a2 = r0[2 * plane + p];
  const float a3 = r0[3 * plane + p], a4 = r0[4 * plane + p];
  const float d0 = r1[q], d1 = r1[plane + q], d2 = r1[2 * plane + q];
  const float d3 = r1[3 * plane + q], d4 = r1[4 * plane + q];
  float r2 = inside ? d0 : 0.0f;
  float r3 = inside ? d1 : 0.0f;
  float r4 = inside ? (a2 + d2) * 0.5f : a2;
  float r5 = inside ? (a3 + d3) * 0.5f : a3;
  float r6 = inside ? (a4 + d4) * 0.25f : a4 * 0.5f;
  r2 = (a0 - r2) * 0.5f + (r4 * dy + r6 * dx);
  r3 = (a1 - r3) * 0.5f + (r6 * dy + r5 * dx);
  const float sc = border_weight(y, H) * border_weight(x, W);
  r2 = r2 * sc;
  r3 = r3 * sc;
  r4 = r4 * sc;
  r5 = r5 * sc;
  r6 = r6 * sc;
  m[0] = r4 * r4 + r6 * r6;  // G11
  m[1] = (r4 + r5) * r6;     // G12
  m[2] = r5 * r5 + r6 * r6;  // G22
  m[3] = r4 * r2 + r6 * r3;  // h1
  m[4] = r6 * r2 + r5 * r3;  // h2
}

}  // namespace oft
