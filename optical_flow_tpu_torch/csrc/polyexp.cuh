// The per-pixel polynomial-expansion arithmetic shared by K2 (polyexp.cu)
// and K7 (update_blur_poly.cu), so that both expand by the same
// instructions and K7 equals K2 -> K1 to the bit (--fmad=false).
//
//   1. the staged value of a pixel: the raw pixel, or at level 0 the 3-tap
//      REFLECT_101 pre-smooth (vertical 3 taps at each of 3 columns, then
//      horizontal 3 taps);
//   2. per column, the three vertical correlations (g, x*g, x^2*g) in tap
//      order;
//   3. the six horizontal correlations of those, in tap order, and the
//      combine into R = (b_y, b_x, a_yy, a_xx, a_xy) by the inverse-Gram
//      entries.
//
// The replicate border of the expansion repeats the staged value at the
// clamped pixel (the smoothed edge at level 0).  The arithmetic follows
// the plain version (models/farneback/core.py:poly_exp) op for op.  K2's
// tiles use the register-blocked forms of 2 and 3 (vertical_run,
// horizontal_run), which give each output the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace oft {

constexpr int kPolyMaxN = 96;  // the largest n whose K2 tile fits
constexpr int kPolyMaxTaps = 2 * kPolyMaxN + 1;

// The expansion's constants; kernels take them by value in the launch's
// parameters (__grid_constant__), where a tap is a constant-cache load.
struct PolyConsts {
  float g[kPolyMaxTaps];
  float xg[kPolyMaxTaps];
  float xxg[kPolyMaxTaps];
  float pre[3];
  float ig11, ig03, ig33, ig55;
};

// From the wrappers' host array [g, xg, xxg (2n+1 each), pre (3), ig11,
// ig03, ig33, ig55].
inline PolyConsts poly_consts(const float* consts, int n) {
  const int taps = 2 * n + 1;
  PolyConsts c = {};
  for (int k = 0; k < taps; ++k) {
    c.g[k] = consts[k];
    c.xg[k] = consts[taps + k];
    c.xxg[k] = consts[2 * taps + k];
  }
  const float* rest = consts + 3 * taps;
  for (int k = 0; k < 3; ++k) c.pre[k] = rest[k];
  c.ig11 = rest[3];
  c.ig03 = rest[4];
  c.ig33 = rest[5];
  c.ig55 = rest[6];
  return c;
}

__device__ __forceinline__ float load(const uint8_t* p, long long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}

// The staged value at in-image pixel (y, x) of an (H, W) plane.
template <typename T, bool PRE>
__device__ __forceinline__ float staged_value(const T* __restrict__ img, int y,
                                              int x, int H, int W,
                                              const PolyConsts& c) {
  if (!PRE) return load(img, static_cast<long long>(y) * W + x);
  // vertical 3 taps at each of the 3 columns, then horizontal 3 taps
  const long long ym = static_cast<long long>(reflect101(y - 1, H)) * W;
  const long long yc = static_cast<long long>(y) * W;
  const long long yp = static_cast<long long>(reflect101(y + 1, H)) * W;
  float h[3];
  for (int j = 0; j < 3; ++j) {
    const int xx = reflect101(x + j - 1, W);
    float a = c.pre[0] * load(img, ym + xx);
    a = a + c.pre[1] * load(img, yc + xx);
    a = a + c.pre[2] * load(img, yp + xx);
    h[j] = a;
  }
  float v = c.pre[0] * h[0];
  v = v + c.pre[1] * h[1];
  v = v + c.pre[2] * h[2];
  return v;
}

// The three vertical correlations of one column, v(k) its k-th staged
// value from the top of the window (k < taps).
template <typename V>
__device__ __forceinline__ void vertical(V v, int taps, const PolyConsts& c,
                                         float& a0, float& a1, float& a2) {
  float s = v(0);
  a0 = c.g[0] * s;
  a1 = c.xg[0] * s;
  a2 = c.xxg[0] * s;
  for (int k = 1; k < taps; ++k) {
    s = v(k);
    a0 = a0 + c.g[k] * s;
    a1 = a1 + c.xg[k] * s;
    a2 = a2 + c.xxg[k] * s;
  }
}

// The six horizontal correlations, fed one column (r0, r1, r2 = that
// column's vertical correlations) at a time in tap order.
struct HSums {
  float b1, b2, b3, b4, b5, b6;
};

__device__ __forceinline__ void horizontal_first(HSums& s, const PolyConsts& c,
                                                 float r0, float r1, float r2) {
  s.b1 = c.g[0] * r0;
  s.b2 = c.xg[0] * r0;
  s.b3 = c.g[0] * r1;
  s.b4 = c.xxg[0] * r0;
  s.b5 = c.g[0] * r2;
  s.b6 = c.xg[0] * r1;
}

__device__ __forceinline__ void horizontal_step(HSums& s, const PolyConsts& c,
                                                int k, float r0, float r1,
                                                float r2) {
  s.b1 = s.b1 + c.g[k] * r0;
  s.b2 = s.b2 + c.xg[k] * r0;
  s.b3 = s.b3 + c.g[k] * r1;
  s.b4 = s.b4 + c.xxg[k] * r0;
  s.b5 = s.b5 + c.g[k] * r2;
  s.b6 = s.b6 + c.xg[k] * r1;
}

// R = (b_y, b_x, a_yy, a_xx, a_xy).
__device__ __forceinline__ void combine(const HSums& s, const PolyConsts& c,
                                        float* R) {
  R[0] = s.b3 * c.ig11;
  R[1] = s.b2 * c.ig11;
  R[2] = s.b1 * c.ig03 + s.b5 * c.ig33;
  R[3] = s.b1 * c.ig03 + s.b4 * c.ig33;
  R[4] = s.b6 * c.ig55;
}

// Register-blocked forms of `vertical` and of the horizontal steps, for
// tiles (K2): KB adjacent outputs at once from one sliding run of the
// values they read, each output's chains still in tap order, so each
// output gets the bits of the per-pixel helpers above.
//
// NTAPS > 0: the tap count, known at compile time (the loops unroll);
// 0: `taps`.
//
// The three vertical correlations of KB adjacent positions: v(q) the q-th
// staged value from the first window's top, q < taps + KB - 1, read once.
template <int KB, int NTAPS, typename V>
__device__ __forceinline__ void vertical_run(V v, int taps, const PolyConsts& c,
                                             float (&a0)[KB], float (&a1)[KB],
                                             float (&a2)[KB]) {
  const int nt = NTAPS ? NTAPS : taps;
  float w[KB];   // w[j] = v(k + j) at tap k
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    w[j] = v(j);
    a0[j] = c.g[0] * w[j];
    a1[j] = c.xg[0] * w[j];
    a2[j] = c.xxg[0] * w[j];
  }
#pragma unroll
  for (int k = 1; k < nt; ++k) {
#pragma unroll
    for (int j = 0; j < KB - 1; ++j) w[j] = w[j + 1];
    w[KB - 1] = v(k + KB - 1);
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      a0[j] = a0[j] + c.g[k] * w[j];
      a1[j] = a1[j] + c.xg[k] * w[j];
      a2[j] = a2[j] + c.xxg[k] * w[j];
    }
  }
}

// The six horizontal correlations of KB adjacent outputs: r(q, r0, r1, r2)
// gives the q-th column's vertical correlations from the first window's
// left, q < taps + KB - 1, read once.
template <int KB, int NTAPS, typename Rd>
__device__ __forceinline__ void horizontal_run(Rd r, int taps, const PolyConsts& c,
                                               HSums (&s)[KB]) {
  const int nt = NTAPS ? NTAPS : taps;
  float w0[KB], w1[KB], w2[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    r(j, w0[j], w1[j], w2[j]);
    horizontal_first(s[j], c, w0[j], w1[j], w2[j]);
  }
#pragma unroll
  for (int k = 1; k < nt; ++k) {
#pragma unroll
    for (int j = 0; j < KB - 1; ++j) {
      w0[j] = w0[j + 1];
      w1[j] = w1[j + 1];
      w2[j] = w2[j + 1];
    }
    r(k + KB - 1, w0[KB - 1], w1[KB - 1], w2[KB - 1]);
#pragma unroll
    for (int j = 0; j < KB; ++j) horizontal_step(s[j], c, k, w0[j], w1[j], w2[j]);
  }
}

// R of one pixel from its (2n+1)^2 window of staged values, sv(k, j) the
// value k rows and j columns from the window's top-left corner: column by
// column, the vertical correlations then one horizontal step each.
template <typename SV>
__device__ __forceinline__ void expand_at(SV sv, int n, const PolyConsts& c,
                                          float* R) {
  const int taps = 2 * n + 1;
  HSums s;
  for (int j = 0; j < taps; ++j) {
    float a0, a1, a2;
    vertical([&](int k) { return sv(k, j); }, taps, c, a0, a1, a2);
    if (j == 0)
      horizontal_first(s, c, a0, a1, a2);
    else
      horizontal_step(s, c, j, a0, a1, a2);
  }
  combine(s, c, R);
}

}  // namespace oft
