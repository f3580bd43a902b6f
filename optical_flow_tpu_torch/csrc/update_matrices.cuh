// The per-pixel Farnebäck update-matrices arithmetic shared by K1
// (update_blur.cu), K5a (update_matrices.cu) and K7 (update_blur_poly.cu),
// so that the paths build M by the same instructions and K5a -> K5b and
// K7 equal K1 to the bit.
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

#include "common.cuh"

namespace oft {

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

// The displaced fetch of pixel (y, x) under flow (dx, dy): the rounded,
// clamped target (yi, xi), and whether the rounded target is inside.
__device__ __forceinline__ bool fetch_target(int y, int x, float dx, float dy,
                                             int H, int W, int& yi, int& xi) {
  const float fx = rintf(static_cast<float>(x) + dx);
  const float fy = rintf(static_cast<float>(y) + dy);
  xi = static_cast<int>(fminf(fmaxf(fx, 0.0f), static_cast<float>(W - 1)));
  yi = static_cast<int>(fminf(fmaxf(fy, 0.0f), static_cast<float>(H - 1)));
  return fx >= 0.0f && fx <= static_cast<float>(W - 1) &&
         fy >= 0.0f && fy <= static_cast<float>(H - 1);
}

// Whether pixel (y, x) lies on the 5-px border rows or columns of an H x
// W frame, the only pixels whose border weight is not 1.
__device__ __forceinline__ bool on_border(int y, int x, int H, int W) {
  return y < 5 || y >= H - 5 || x < 5 || x >= W - 5;
}

// M at pixel (y, x) from R0 there (a), R1 at the fetch target (d) and the
// flow (dx, dy).  BORDER_ONLY weighs only the pixels on_border: elsewhere
// the weight is 1.0f and r * 1.0f == r, so skipping it changes no bit.
template <bool BORDER_ONLY = false>
__device__ __forceinline__ void assemble(const float* a, const float* d,
                                         float dx, float dy, bool inside,
                                         int y, int x, int H, int W, float* m) {
  float r2 = inside ? d[0] : 0.0f;
  float r3 = inside ? d[1] : 0.0f;
  float r4 = inside ? (a[2] + d[2]) * 0.5f : a[2];
  float r5 = inside ? (a[3] + d[3]) * 0.5f : a[3];
  float r6 = inside ? (a[4] + d[4]) * 0.25f : a[4] * 0.5f;
  r2 = (a[0] - r2) * 0.5f + (r4 * dy + r6 * dx);
  r3 = (a[1] - r3) * 0.5f + (r6 * dy + r5 * dx);
  if (!BORDER_ONLY || on_border(y, x, H, W)) {
    const float sc = border_weight(y, H) * border_weight(x, W);
    r2 = r2 * sc;
    r3 = r3 * sc;
    r4 = r4 * sc;
    r5 = r5 * sc;
    r6 = r6 * sc;
  }
  m[0] = r4 * r4 + r6 * r6;  // G11
  m[1] = (r4 + r5) * r6;     // G12
  m[2] = r5 * r5 + r6 * r6;  // G22
  m[3] = r4 * r2 + r6 * r3;  // h1
  m[4] = r6 * r2 + r5 * r3;  // h2
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
  int yi, xi;
  const bool inside = fetch_target(y, x, dx, dy, H, W, yi, xi);
  const long long q = static_cast<long long>(yi) * W + xi;
  float a[5], d[5];
  for (int k = 0; k < 5; ++k) {
    a[k] = r0[k * plane + p];
    d[k] = r1[k * plane + q];
  }
  assemble(a, d, dx, dy, inside, y, x, H, W, m);
}

}  // namespace oft
