// The window sum and solve of an iterate step.  `term` and `solve_store`
// are shared by K1 (update_blur.cu), K5b (blur_solve.cu) and K7
// (update_blur_poly.cu), and `window_sums` by K1 and K5b, so that they sum
// and solve by the same instructions; `window_sum_solve` is K7's:
// from M on a block's output tile plus its m-pixel halo in shared memory
// to the new flow, with
// the box window (plain adds, then a 1 / winsize^2 scale) or the Gaussian
// one (taps t: a = t[0] * M[x - m] + t[1] * M[x - m + 1] + ...,
// horizontally, then vertically, scale 1), in K5b's order; then the 2x2
// solve, det regularised by +1e-3.  The five channels of a pixel advance
// together: one tap for five independent add chains.

#pragma once

#include <cuda_runtime.h>

namespace oft {

// One term of a window sum: tap x value for the Gaussian window; the box's
// taps are all 1, and 1 * v == v, so the box adds the values themselves.
template <bool GAUSS>
__device__ __forceinline__ float term(float t, float v) {
  return GAUSS ? t * v : v;
}

// The 2x2 solve of one pixel from its five window sums s (G11, G12, G22,
// h1, h2), scaled; the new flow to out[p] (dx) and out[plane + p] (dy).
__device__ __forceinline__ void solve_store(const float* s, float scale,
                                            float* __restrict__ out,
                                            long long p, long long plane) {
  const float g11 = s[0] * scale;
  const float g12 = s[1] * scale;
  const float g22 = s[2] * scale;
  const float h1 = s[3] * scale;
  const float h2 = s[4] * scale;
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  out[p] = (g11 * h2 - g12 * h1) * idet;          // dx
  out[plane + p] = (g22 * h1 - g12 * h2) * idet;  // dy
}

// K adjacent window sums of 2m + 1 taps, a[k][j] = sum_i t[i] v[j + i][k]
// (the box: t = 1), each added in tap order, for C channels k (M's five,
// or one).  load(q, v) gives the C channels of the q-th value, q = 0 ..
// 2m + K - 1, called once each in that order.  Sum j starts at q = j and ends at q = j + 2m: the first K
// and the last K - 1 values are peeled (unrolled), so that the loop
// between them adds to all K sums with no test.  t[i] reads tap i: a
// pointer into shared memory, or a kernel parameter's array.  N > 0 fixes
// the window at N = 2m + 1 taps at compile time: every step is unrolled,
// so load and t see constant q, and the taps' shifts through tw[] are
// register renames; N = 0 reads m at run time.
template <bool GAUSS, int K, int N = 0, int C, typename Load, typename Taps>
__device__ __forceinline__ void window_sums(Load load, Taps t, int m,
                                            float (&a)[C][K]) {
  static_assert(N == 0 || N % 2 == 1, "a window has 2m + 1 taps");
  const int n = N > 0 ? N : 2 * m + 1;
  float v[C];
  float tw[K];   // tw[j] = t[q - j], the tap of value q in sum j
  if (n < K) {   // windows shorter than K: every step tests its sums
#pragma unroll
    for (int j = 0; j < K; ++j) {
      tw[j] = 1.0f;
#pragma unroll
      for (int k = 0; k < C; ++k) a[k][j] = 0.0f;
    }
    for (int q = 0; q < n + K - 1; ++q) {
      load(q, v);
      if (GAUSS) {
#pragma unroll
        for (int j = K - 1; j > 0; --j) tw[j] = tw[j - 1];
        tw[0] = q < n ? t[q] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int i = q - j;
        if (i >= 0 && i < n) {
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const float tv = term<GAUSS>(tw[j], v[k]);
            a[k][j] = i == 0 ? tv : a[k][j] + tv;
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) tw[j] = 1.0f;
#pragma unroll
  for (int q = 0; q < K; ++q) {          // sum q starts; sums j < q go on
    load(q, v);
    if (GAUSS) {
#pragma unroll
      for (int j = K - 1; j > 0; --j) tw[j] = tw[j - 1];
      tw[0] = t[q];
    }
#pragma unroll
    for (int j = 0; j <= q; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float tv = term<GAUSS>(tw[j], v[k]);
        a[k][j] = j == q ? tv : a[k][j] + tv;
      }
  }
  const auto step = [&](int q) {         // all K sums go on
    load(q, v);
    if (GAUSS) {
#pragma unroll
      for (int j = K - 1; j > 0; --j) tw[j] = tw[j - 1];
      tw[0] = t[q];
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) a[k][j] = a[k][j] + term<GAUSS>(tw[j], v[k]);
  };
  // the run-time loop is left to nvcc's own unrolling: any count given
  // to it (1, 2, 4 or 8) changes the code of K5b and of K1's run-time form
  if constexpr (N > 0) {
#pragma unroll
    for (int q = K; q < N; ++q) step(q);
  } else {
    for (int q = K; q < n; ++q) step(q);
  }
#pragma unroll
  for (int e = 1; e < K; ++e) {          // sums j < e have ended
    load(n - 1 + e, v);
    if (GAUSS) {
#pragma unroll
      for (int j = K - 1; j > 0; --j) tw[j] = tw[j - 1];
    }
#pragma unroll
    for (int j = e; j < K; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) a[k][j] = a[k][j] + term<GAUSS>(tw[j], v[k]);
  }
}

// Ms: [5][MH][MW] M on the TX x TY tile at (x0, y0) plus its halo (MH =
// TY + 2m, MW = TX + 2m), complete (the caller synchronised after writing
// it); Hs: [5][MH][TX] scratch; t: the 2m + 1 taps (GAUSS).  Writes the
// new flow of the tile's in-image pixels to out (2, H, W).  A block of TX
// x BY threads; it synchronises once, then threads outside the image
// return.
template <bool GAUSS, int TX, int TY, int BY>
__device__ __forceinline__ void window_sum_solve(const float* Ms, float* Hs,
                                                 const float* t, int m,
                                                 float scale, int x0, int y0,
                                                 int H, int W, long long plane,
                                                 float* __restrict__ out) {
  const int MW = TX + 2 * m;
  const int MH = TY + 2 * m;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // horizontal sums; the five channels advance together: one tap for
  // five independent chains, each in tap order
  for (int e = tid; e < MH * TX; e += TX * BY) {
    const int ly = e / TX;
    const int lx = e - ly * TX;
    const float* p = Ms + ly * MW + lx;   // channel k at p + k * MH * MW
    float a[5];
    const float t0 = GAUSS ? t[0] : 1.0f;   // the box reads no taps
#pragma unroll
    for (int k = 0; k < 5; ++k) a[k] = term<GAUSS>(t0, p[k * MH * MW]);
    for (int i = 1; i <= 2 * m; ++i) {
      const float ti = GAUSS ? t[i] : 1.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) a[k] = a[k] + term<GAUSS>(ti, p[k * MH * MW + i]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) Hs[(k * MH + ly) * TX + lx] = a[k];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ly = threadIdx.y; ly < TY; ly += BY) {
    const int y = y0 + ly;
    if (y >= H) break;
    // vertical sums, the five channels together as above
    const float* h = Hs + ly * TX + threadIdx.x;   // channel k at h + k * MH * TX
    float s[5];
    const float t0 = GAUSS ? t[0] : 1.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k) s[k] = term<GAUSS>(t0, h[k * MH * TX]);
    for (int i = 1; i <= 2 * m; ++i) {
      const float ti = GAUSS ? t[i] : 1.0f;
#pragma unroll
      for (int k = 0; k < 5; ++k) s[k] = s[k] + term<GAUSS>(ti, h[k * MH * TX + i * TX]);
    }
    solve_store(s, scale, out, static_cast<long long>(y) * W + x, plane);
  }
}

}  // namespace oft
