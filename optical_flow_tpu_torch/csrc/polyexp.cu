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
// The arithmetic follows the plain version op for op (--fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 96;                 // the largest n whose tile fits
constexpr int kMaxTaps = 2 * kMaxN + 1;
constexpr int TX = 32;                    // output columns per block
constexpr int TY = 16;                    // output rows per block
constexpr int BY = 8;                     // thread rows per block

struct Consts {
  float g[kMaxTaps];
  float xg[kMaxTaps];
  float xxg[kMaxTaps];
  float pre[3];
  float ig11, ig03, ig33, ig55;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Single reflection (REFLECT_101); the wrapper guarantees n >= 2.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float load(const uint8_t* p, long long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}

template <typename T, bool PRE>
__global__ void polyexp_kernel(const T* __restrict__ src, float* __restrict__ R,
                               int H, int W, int n, Consts c) {
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
    const int y = clampi(y0 - n + ly, 0, H - 1);
    const int x = clampi(x0 - n + lx, 0, W - 1);
    float v;
    if (PRE) {
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
      v = c.pre[0] * h[0];
      v = v + c.pre[1] * h[1];
      v = v + c.pre[2] * h[2];
    } else {
      v = load(img, static_cast<long long>(y) * W + x);
    }
    S[e] = v;
  }
  __syncthreads();

  for (int e = tid; e < TY * SW; e += TX * BY) {
    const int ly = e / SW;
    const int lx = e - ly * SW;
    const float* col = S + ly * SW + lx;
    float v = col[0];
    float a0 = c.g[0] * v, a1 = c.xg[0] * v, a2 = c.xxg[0] * v;
    for (int k = 1; k < taps; ++k) {
      v = col[k * SW];
      a0 = a0 + c.g[k] * v;
      a1 = a1 + c.xg[k] * v;
      a2 = a2 + c.xxg[k] * v;
    }
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
    float b1 = c.g[0] * r0[0], b2 = c.xg[0] * r0[0], b3 = c.g[0] * r1[0];
    float b4 = c.xxg[0] * r0[0], b5 = c.g[0] * r2[0], b6 = c.xg[0] * r1[0];
    for (int k = 1; k < taps; ++k) {
      b1 = b1 + c.g[k] * r0[k];
      b2 = b2 + c.xg[k] * r0[k];
      b3 = b3 + c.g[k] * r1[k];
      b4 = b4 + c.xxg[k] * r0[k];
      b5 = b5 + c.g[k] * r2[k];
      b6 = b6 + c.xg[k] * r1[k];
    }
    float* out = R + blockIdx.z * 5 * plane + static_cast<long long>(y) * W + x;
    out[0] = b3 * c.ig11;                       // b_y
    out[plane] = b2 * c.ig11;                   // b_x
    out[2 * plane] = b1 * c.ig03 + b5 * c.ig33;  // a_yy
    out[3 * plane] = b1 * c.ig03 + b4 * c.ig33;  // a_xx
    out[4 * plane] = b6 * c.ig55;               // a_xy
  }
}

template <typename T, bool PRE>
int launch(const void* src, float* R, int nimg, int H, int W, int n,
           const Consts& c, cudaStream_t stream) {
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
  const int taps = 2 * n + 1;
  Consts c = {};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return pre ? launch<uint8_t, true>(src, R, nimg, H, W, n, c, s)
               : launch<uint8_t, false>(src, R, nimg, H, W, n, c, s);
  return pre ? launch<float, true>(src, R, nimg, H, W, n, c, s)
             : launch<float, false>(src, R, nimg, H, W, n, c, s);
}
