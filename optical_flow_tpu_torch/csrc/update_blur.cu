// K1: one fused Farnebäck iterate step (update matrices -> window sum ->
// solve), with the box or the Gaussian window.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/update_gather.py
// (fused_update_blur_store, driven by pallas/fused_iterate.py
// update_flow_fused).  For each pixel:
//   1. M = (G11, G12, G22, h1, h2) from the displaced fetch of R1
//      (update_matrices.cuh, shared with K5a);
//   2. sum M over the winsize x winsize window with replicate borders:
//      the box (plain adds, then a 1 / winsize^2 scale) or the Gaussian
//      window (taps t: a = t[0] * M[x - m] + t[1] * M[x - m + 1] + ...,
//      horizontally, then vertically, scale 1), in K5b's order, so that
//      K1 equals K5a -> K5b to the bit with either window;
//   3. solve the 2x2 system, det regularised by +1e-3, for the new flow.
//
// What bounds it: per output pixel it reads 7 f32 (R0 and the flow) plus a
// 5-f32 gather of R1, and writes 2 f32, 56 B/px in all, if M stayed on
// chip; the unfused version (K5a -> K5b) adds 2 x 20 B/px of M round trips
// per step.  So M for a 32x32 output tile plus its (winsize - 1) halo is
// built in shared memory (5 x 46 x 46 f32 at winsize 15), then summed
// horizontally, then vertically, the five channels of a pixel advancing
// together (one tap, five independent add chains), and solved.  The halo
// costs (46/32)^2 =
// 2.1 M evaluations per output pixel; the card's hardware gather makes the
// displaced fetch a plain clamped load, exact by construction.  The tile
// must fit in shared memory, which bounds winsize (<= 61); larger windows
// go to K5a -> K5b.  The grid covers any width (8K frames included, the
// TPU's column-chunked K8); plane offsets are int64.
//
// Border: halo entries outside the image hold M *at the clamped pixel*,
// that pixel's border weight included (replicate border of the box sum).
// The input and output flow must be distinct buffers: a step reads its
// neighbours' flow.  M's arithmetic is update_matrices.cuh's and the
// window sum and solve window_solve.cuh's, both shared with K7
// (update_blur_poly.cu); they follow the plain version op for op
// (--fmad=false).

#include <cuda_runtime.h>

#include "update_matrices.cuh"
#include "window_solve.cuh"

namespace {

constexpr int TX = 32;  // output columns per block (one per thread)
constexpr int TY = 32;  // output rows per block
constexpr int BY = 8;   // thread rows per block

// GAUSS: weighted sums with the window taps; else plain adds (the box).
template <bool GAUSS>
__global__ void update_blur_kernel(const float* __restrict__ R0,
                                   const float* __restrict__ R1,
                                   const float* __restrict__ flow_in,
                                   float* __restrict__ flow_out, int H, int W,
                                   int m, const float* __restrict__ taps_g,
                                   float scale) {
  extern __shared__ float smem[];
  const int MW = TX + 2 * m;
  const int MH = TY + 2 * m;
  float* Ms = smem;                 // [5][MH][MW]  M on the tile + halo
  float* Hs = smem + 5 * MH * MW;   // [5][MH][TX]  horizontal window sums
  float* t = Hs + 5 * MH * TX;      // [2m + 1]     window taps (GAUSS)
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const float* r0 = R0 + blockIdx.z * 5 * plane;
  const float* r1 = R1 + blockIdx.z * 5 * plane;
  const float* fl = flow_in + blockIdx.z * 2 * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  if (GAUSS)
    for (int i = tid; i <= 2 * m; i += TX * BY) t[i] = taps_g[i];

  for (int e = tid; e < MH * MW; e += TX * BY) {
    const int ly = e / MW;
    const int lx = e - ly * MW;
    const int y = oft::clampi(y0 - m + ly, 0, H - 1);
    const int x = oft::clampi(x0 - m + lx, 0, W - 1);
    float mv[5];
    oft::matrices_at(r0, r1, fl, y, x, H, W, plane, mv);
    for (int k = 0; k < 5; ++k) Ms[(k * MH + ly) * MW + lx] = mv[k];
  }
  __syncthreads();

  oft::window_sum_solve<GAUSS, TX, TY, BY>(Ms, Hs, t, m, scale, x0, y0, H, W,
                                           plane, flow_out + blockIdx.z * 2 * plane);
}

template <bool GAUSS>
int launch(const float* R0, const float* R1, const float* flow_in,
           float* flow_out, int B, int H, int W, int m, const float* taps,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (5 * ((TY + 2 * m) * (TX + 2 * m) + (TY + 2 * m) * TX) +
                       (GAUSS ? 2 * m + 1 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      update_blur_kernel<GAUSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  update_blur_kernel<GAUSS><<<grid, block, smem, stream>>>(
      R0, R1, flow_in, flow_out, H, W, m, taps, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R0, R1: (B, 5, H, W) f32; flow_in, flow_out: distinct (B, 2, H, W) f32.
// m = winsize / 2.  taps: the 2m + 1 Gaussian window taps on the device
// (scale 1), or null for the box window (scale 1 / winsize^2).  Returns a
// cudaError_t.
extern "C" int oft_update_blur(const float* R0, const float* R1,
                               const float* flow_in, float* flow_out, int B,
                               int H, int W, int m, const float* taps,
                               float scale, int device, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps != nullptr)
    return launch<true>(R0, R1, flow_in, flow_out, B, H, W, m, taps, scale, s);
  return launch<false>(R0, R1, flow_in, flow_out, B, H, W, m, taps, scale, s);
}
