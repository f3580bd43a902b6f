// K2: Farnebäck polynomial expansion (FarnebackPolyExp), with an optional
// 3-tap REFLECT_101 pre-smooth for pyramid level 0.
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/polyexp.py
// (poly_exp_pallas_store and poly_exp_pallas): R = (b_y, b_x, a_yy, a_xx,
// a_xy) per pixel from the (2n+1)^2 neighbourhood under replicate borders,
// via separable g, x*g and x^2*g correlations combined by the inverse-Gram
// entries.
//
// What bounds it: the 20 B/px of R written to device memory (against 1 or
// 4 B/px read), and about 18 (2n+1) multiply-adds per pixel.  A block
// stages its tile plus an n-pixel halo once in shared memory, runs the
// three vertical correlations there, then the six horizontal ones, so the
// input is read about once and R is written once.  Shared memory is sized
// from n, and any poly_n whose tile fits runs (n <= 96, kMaxN).  The taps
// travel by value in the launch's parameters (2.3 KB at kMaxN), where a
// tap is a constant-cache load; from shared memory, as loads beside the
// tile's, K2 took 7 % longer at level 0 (PERF.md).
//
// Border: with the pre-smooth, the replicate border of the expansion
// repeats the *smoothed* edge pixel: a staged entry outside the image holds
// the pre-smoothed value at the clamped pixel; it does not smooth
// replicated raw pixels.  The pre-smooth itself reflects (REFLECT_101).
// The per-pixel arithmetic is polyexp.cuh's, which K7 shares; it follows
// the plain version op for op (--fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyexp.cuh"

namespace {

using oft::PolyConsts;

constexpr int kMaxN = oft::kPolyMaxN;     // the largest n whose tile fits
constexpr int TX = 32;                    // output columns per block
constexpr int TY = 16;                    // output rows per block
constexpr int BY = 8;                     // thread rows per block

template <typename T, bool PRE>
__global__ void polyexp_kernel(const T* __restrict__ src, float* __restrict__ R,
                               int H, int W, int n,
                               const __grid_constant__ PolyConsts c) {
  extern __shared__ float smem[];
  const int taps = 2 * n + 1;
  const int SW = TX + 2 * n;
  const int SH = TY + 2 * n;
  float* S = smem;                 // [SH][SW]   staged (smoothed) input
  float* rows = smem + SH * SW;    // [3][TY][SW] vertical correlations
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const T* img = src + blockIdx.z * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int e = tid; e < SH * SW; e += TX * BY) {
    const int ly = e / SW;
    const int lx = e - ly * SW;
    const int y = oft::clampi(y0 - n + ly, 0, H - 1);
    const int x = oft::clampi(x0 - n + lx, 0, W - 1);
    S[e] = oft::staged_value<T, PRE>(img, y, x, H, W, c);
  }
  __syncthreads();

  for (int e = tid; e < TY * SW; e += TX * BY) {
    const int ly = e / SW;
    const int lx = e - ly * SW;
    const float* col = S + ly * SW + lx;
    float a0, a1, a2;
    oft::vertical([&](int k) { return col[k * SW]; }, taps, c, a0, a1, a2);
    rows[(0 * TY + ly) * SW + lx] = a0;
    rows[(1 * TY + ly) * SW + lx] = a1;
    rows[(2 * TY + ly) * SW + lx] = a2;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ly = threadIdx.y; ly < TY; ly += BY) {
    const int y = y0 + ly;
    if (y >= H) break;
    const float* r0 = rows + (0 * TY + ly) * SW + threadIdx.x;
    const float* r1 = rows + (1 * TY + ly) * SW + threadIdx.x;
    const float* r2 = rows + (2 * TY + ly) * SW + threadIdx.x;
    oft::HSums s;
    oft::horizontal_first(s, c, r0[0], r1[0], r2[0]);
    for (int k = 1; k < taps; ++k) oft::horizontal_step(s, c, k, r0[k], r1[k], r2[k]);
    float rv[5];
    oft::combine(s, c, rv);
    float* out = R + blockIdx.z * 5 * plane + static_cast<long long>(y) * W + x;
    for (int k = 0; k < 5; ++k) out[k * plane] = rv[k];
  }
}

template <typename T, bool PRE>
int launch(const void* src, float* R, int nimg, int H, int W, int n,
           const PolyConsts& c, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((TY + 2 * n) * (TX + 2 * n) + 3 * TY * (TX + 2 * n));
  cudaError_t err = cudaFuncSetAttribute(
      polyexp_kernel<T, PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, nimg);
  polyexp_kernel<T, PRE><<<grid, block, smem, stream>>>(
      static_cast<const T*>(src), R, H, W, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (nimg, H, W) uint8 (src_u8 != 0) or f32; R: (nimg, 5, H, W) f32.
// consts: host array [g, xg, xxg (2n+1 each), pre (3), ig11, ig03, ig33,
// ig55]; pre is used when pre != 0.  Returns a cudaError_t.
extern "C" int oft_polyexp(const void* src, int src_u8, float* R, int nimg,
                           int H, int W, int n, const float* consts, int pre,
                           int device, void* stream) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PolyConsts c = oft::poly_consts(consts, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return pre ? launch<uint8_t, true>(src, R, nimg, H, W, n, c, s)
               : launch<uint8_t, false>(src, R, nimg, H, W, n, c, s);
  return pre ? launch<float, true>(src, R, nimg, H, W, n, c, s)
             : launch<float, false>(src, R, nimg, H, W, n, c, s);
}
