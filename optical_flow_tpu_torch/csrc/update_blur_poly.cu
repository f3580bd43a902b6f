// K7: one Farnebäck iterate step from the level images, with the
// polynomial expansion derived inside the step, so that R never exists in
// device memory.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/update_gather.py
// (fused_update_blur_store_poly, driven by pallas/fused_iterate.py
// update_flow_fused_poly): K1 (update_blur.cu) with R0 and R1 expanded
// from img0 and img1 (uint8 with the 3-tap pre-smooth at level 0, f32 at
// the levels k > 0).  Per block:
//   1. stage img0 (pre-smoothed) over the 32x32 output tile plus the
//      window's m-pixel halo plus the expansion's n-pixel halo;
//   2. for each pixel of the tile + m halo: R0 from the staged values, R1
//      at the rounded, clamped displaced pixel from img1 in device memory
//      (its own (2n+1)^2 window, pre-smoothed at level 0), then M
//      (update_matrices.cuh, shared with K1 and K5a);
//   3. the window sum and solve of K1 (window_solve.cuh).
// The expansion is polyexp.cuh's, shared with K2, so K7 equals K2 -> K1 to
// the bit (--fmad=false).  A staged entry outside the image holds the
// staged value at the clamped pixel: K2's replicate border of the
// smoothed image.  The displaced fetch is a gather from device memory,
// exact for any displacement, so the TPU kernel's bands, anchors, raw
// windows and spill tiers (and its replay of spilled frames through the
// unfused path) have no counterpart.
//
// What bounds it: arithmetic, not bytes.  It reads the two level images
// and the flow and writes the flow (10 B/px at level 0, 16 at k > 0)
// against K2 -> K1's 56 B/px per step plus 40 B/px of R, but derives R1
// once per M evaluation, 2.1 times per output pixel at winsize 15, each
// from a (2n+1)^2 window (121 staged values at poly_n 5, nine loads and
// twelve operations each with the pre-smooth), and R0 from shared memory
// as often.  This first version derives each R1 from device memory
// through the cache; expanding img1 once over the bounding box of a
// block's fetch targets in shared memory is the next step.  The tile's
// shared memory (M on tile + halo, the staged img0, aliased with the
// horizontal sums) bounds winsize and poly_n (k7_fits in
// kernels/update_gather.py).  The grid covers any width; plane offsets
// are int64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyexp.cuh"
#include "update_matrices.cuh"
#include "window_solve.cuh"

namespace {

using oft::PolyConsts;

constexpr int TX = 32;  // output columns per block (one per thread)
constexpr int TY = 32;  // output rows per block
constexpr int BY = 8;   // thread rows per block

__host__ __device__ __forceinline__ int max_i(int a, int b) {
  return a > b ? a : b;
}

template <typename T, bool PRE, bool GAUSS>
__global__ void update_blur_poly_kernel(const T* __restrict__ img0,
                                        const T* __restrict__ img1,
                                        const float* __restrict__ flow_in,
                                        float* __restrict__ flow_out, int H,
                                        int W, int m, int n,
                                        const float* __restrict__ taps_g,
                                        float scale,
                                        const __grid_constant__ PolyConsts c) {
  extern __shared__ float smem[];
  const int MW = TX + 2 * m;
  const int MH = TY + 2 * m;
  const int SW = MW + 2 * n;
  const int SH = MH + 2 * n;
  float* Ms = smem;                  // [5][MH][MW]  M on the tile + halo
  float* U = smem + 5 * MH * MW;     // [SH][SW] staged img0, then
                                     // [5][MH][TX] horizontal window sums
  float* t = U + max_i(SH * SW, 5 * MH * TX);   // [2m + 1] taps (GAUSS)
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const T* i0 = img0 + blockIdx.z * plane;
  const T* i1 = img1 + blockIdx.z * plane;
  const float* fl = flow_in + blockIdx.z * 2 * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  if (GAUSS)
    for (int i = tid; i <= 2 * m; i += TX * BY) t[i] = taps_g[i];

  // staged img0: row 0 is image row y0 - m - n, column 0 column x0 - m - n
  for (int e = tid; e < SH * SW; e += TX * BY) {
    const int ly = e / SW;
    const int lx = e - ly * SW;
    const int y = oft::clampi(y0 - m - n + ly, 0, H - 1);
    const int x = oft::clampi(x0 - m - n + lx, 0, W - 1);
    U[e] = oft::staged_value<T, PRE>(i0, y, x, H, W, c);
  }
  __syncthreads();

  for (int e = tid; e < MH * MW; e += TX * BY) {
    const int ly = e / MW;
    const int lx = e - ly * MW;
    const int y = oft::clampi(y0 - m + ly, 0, H - 1);
    const int x = oft::clampi(x0 - m + lx, 0, W - 1);
    const long long p = static_cast<long long>(y) * W + x;
    const float dx = fl[p];
    const float dy = fl[plane + p];
    int yi, xi;
    const bool inside = oft::fetch_target(y, x, dx, dy, H, W, yi, xi);
    // R0 at (y, x): its window starts at staged row y - n, column x - n
    const float* s0 = U + (y - y0 + m) * SW + (x - x0 + m);
    float a[5], d[5], mv[5];
    oft::expand_at([&](int k, int j) { return s0[k * SW + j]; }, n, c, a);
    // R1 at the fetch target, from img1 in device memory
    oft::expand_at(
        [&](int k, int j) {
          return oft::staged_value<T, PRE>(i1, oft::clampi(yi - n + k, 0, H - 1),
                                           oft::clampi(xi - n + j, 0, W - 1),
                                           H, W, c);
        },
        n, c, d);
    oft::assemble(a, d, dx, dy, inside, y, x, H, W, mv);
    for (int k = 0; k < 5; ++k) Ms[(k * MH + ly) * MW + lx] = mv[k];
  }
  __syncthreads();   // the staged img0 is dead: U holds the row sums next

  oft::window_sum_solve<GAUSS, TX, TY, BY>(Ms, U, t, m, scale, x0, y0, H, W,
                                           plane, flow_out + blockIdx.z * 2 * plane);
}

template <typename T, bool PRE, bool GAUSS>
int launch(const void* img0, const void* img1, const float* flow_in,
           float* flow_out, int B, int H, int W, int m, int n,
           const float* taps, float scale, const PolyConsts& c,
           cudaStream_t stream) {
  const int MH = TY + 2 * m, MW = TX + 2 * m;
  const size_t smem =
      sizeof(float) * (5 * MH * MW + max_i((MH + 2 * n) * (MW + 2 * n), 5 * MH * TX) +
                       (GAUSS ? 2 * m + 1 : 0));
  auto kernel = update_blur_poly_kernel<T, PRE, GAUSS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(img0),
                                        static_cast<const T*>(img1), flow_in,
                                        flow_out, H, W, m, n, taps, scale, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PRE>
int launch_window(const void* img0, const void* img1, const float* flow_in,
                  float* flow_out, int B, int H, int W, int m, int n,
                  const float* taps, float scale, const PolyConsts& c,
                  cudaStream_t stream) {
  if (taps != nullptr)
    return launch<T, PRE, true>(img0, img1, flow_in, flow_out, B, H, W, m, n,
                                taps, scale, c, stream);
  return launch<T, PRE, false>(img0, img1, flow_in, flow_out, B, H, W, m, n,
                               taps, scale, c, stream);
}

}  // namespace

// img0, img1: (B, H, W) uint8 (src_u8 != 0) or f32; flow_in, flow_out:
// distinct (B, 2, H, W) f32.  m = winsize / 2; n = poly_n.  taps: the
// 2m + 1 Gaussian window taps on the device (scale 1), or null for the box
// window (scale 1 / winsize^2).  consts: the expansion's host array, as
// oft_polyexp's; pre != 0 pre-smooths both images.  Returns a cudaError_t.
extern "C" int oft_update_blur_poly(const void* img0, const void* img1,
                                    int src_u8, const float* flow_in,
                                    float* flow_out, int B, int H, int W,
                                    int m, int n, const float* taps,
                                    float scale, const float* consts, int pre,
                                    int device, void* stream) {
  if (m < 0 || n < 1 || n > oft::kPolyMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const PolyConsts c = oft::poly_consts(consts, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return pre ? launch_window<uint8_t, true>(img0, img1, flow_in, flow_out, B, H,
                                              W, m, n, taps, scale, c, s)
               : launch_window<uint8_t, false>(img0, img1, flow_in, flow_out, B, H,
                                               W, m, n, taps, scale, c, s);
  return pre ? launch_window<float, true>(img0, img1, flow_in, flow_out, B, H, W,
                                          m, n, taps, scale, c, s)
             : launch_window<float, false>(img0, img1, flow_in, flow_out, B, H, W,
                                           m, n, taps, scale, c, s);
}
