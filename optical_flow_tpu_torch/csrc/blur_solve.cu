// K5b: window sum of the update matrices + 2x2 solve.
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/blur_solve.py
// (update_flow_blur_solve_pallas, and blur_solve_store for the store
// layout).  Input M = (G11, G12, G22, h1, h2) as K5a writes it, (B, 5, H, W)
// f32; output the new flow (B, 2, H, W) f32.  For each pixel:
//   1. horizontal pass: a = t[0] * M[x - m] + t[1] * M[x - m + 1] + ...,
//   2. vertical pass over those row sums, the same taps, the same order,
//   3. solve with (G, h) scaled by `scale`, det regularised by +1e-3.
// The Gaussian window passes its taps (models/farneback/core.py:
// gaussian_window_kernel) and scale 1; the box window passes 2m + 1 ones
// and 1 / winsize^2.  1 * v == v, so the box sums are the plain additions
// of box_sum_replicate and of K1, to the bit.  Borders are replicate, by
// clamped loads; there is no padded copy of M.
//
// What bounds it: M is read from device memory about once (20 B/px, plus
// the tile's (32 + 2m) / 32 row halo from L2) and the flow written
// (8 B/px); the horizontal pass re-reads its 2m + 1 taps of M from L1, and
// its loads and instructions, not device memory, set the time (PERF.md).
// A 32 x 32 output tile streams its (32 + 2m) window rows through shared
// memory CH rows at a time, and each thread keeps its 4 output rows x 5
// channels of vertical sums in registers, so shared memory does not bound
// m: any winsize >= 1 runs, including those too large for K1's tile.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;          // output columns per block (one per thread)
constexpr int TY = 32;          // output rows per block
constexpr int BY = 8;           // thread rows per block
constexpr int RPT = TY / BY;    // output rows per thread
constexpr int CH = 48;          // window rows staged per pass (one pass
                                // for winsize <= 17)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void blur_solve_kernel(const float* __restrict__ M,
                                  const float* __restrict__ taps,
                                  float* __restrict__ flow, int H, int W,
                                  int m, float scale) {
  __shared__ float Hs[5][CH][TX];  // horizontal sums of CH window rows
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const float* mb = M + blockIdx.z * 5 * plane;
  const int xc = x0 + threadIdx.x;
  const int rows = TY + 2 * m;     // window rows of the tile, from y0 - m
  float acc[RPT][5] = {};

  for (int c0 = 0; c0 < rows; c0 += CH) {
    const int cend = min(c0 + CH, rows);
    for (int j = threadIdx.y; c0 + j < cend; j += BY) {
      const float* row =
          mb + static_cast<long long>(clampi(y0 - m + c0 + j, 0, H - 1)) * W;
      // the five channels' sums advance together: one clamp and one tap
      // per column, five independent add chains, each in tap order
      float a[5];
      const int xl = clampi(xc - m, 0, W - 1);
#pragma unroll
      for (int k = 0; k < 5; ++k) a[k] = taps[0] * row[k * plane + xl];
      for (int i = 1; i <= 2 * m; ++i) {
        const int xi = clampi(xc - m + i, 0, W - 1);
        const float t = taps[i];
#pragma unroll
        for (int k = 0; k < 5; ++k) a[k] = a[k] + t * row[k * plane + xi];
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) Hs[k][j][threadIdx.x] = a[k];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      // output row ly sums window rows ly .. ly + 2m of the tile
      const int ly = threadIdx.y + q * BY;
      const int hi = min(ly + 2 * m, cend - 1);
      for (int c = max(ly, c0); c <= hi; ++c) {
        const int i = c - ly;
        const float t = taps[i];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float term = t * Hs[k][c - c0][threadIdx.x];
          acc[q][k] = i == 0 ? term : acc[q][k] + term;
        }
      }
    }
    __syncthreads();
  }

  if (xc >= W) return;
  float* out = flow + blockIdx.z * 2 * plane;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int y = y0 + threadIdx.y + q * BY;
    if (y >= H) break;
    const float g11 = acc[q][0] * scale;
    const float g12 = acc[q][1] * scale;
    const float g22 = acc[q][2] * scale;
    const float h1 = acc[q][3] * scale;
    const float h2 = acc[q][4] * scale;
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const long long p = static_cast<long long>(y) * W + xc;
    out[p] = (g11 * h2 - g12 * h1) * idet;          // dx
    out[plane + p] = (g22 * h1 - g12 * h2) * idet;  // dy
  }
}

}  // namespace

// M: (B, 5, H, W) f32; taps: 2m + 1 f32 on the device; flow: (B, 2, H, W)
// f32.  Returns a cudaError_t.
extern "C" int oft_blur_solve(const float* M, const float* taps, float* flow,
                              int B, int H, int W, int m, float scale,
                              int device, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  blur_solve_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      M, taps, flow, H, W, m, scale);
  return static_cast<int>(cudaGetLastError());
}
