// K6: full-resolution separable Gaussian blur with REFLECT_101 borders.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/gauss.py
// (gaussian_blur_pallas): cv2.GaussianBlur of (n, H, W) uint8 or f32
// frames with any odd tap count, the vertical pass first, then the
// horizontal one, each acc = t[0] * v[0]; acc = acc + t[i] * v[i] in tap
// order, as the plain version (models/farneback/core.py:
// gaussian_blur_reflect101) sums them; with --fmad=false the two agree to
// the last bit.  The border index is a load through a reflected index
// (any number of reflections, as core._pad_index), so there is no padded
// copy of the frame.
//
// What bounds it: 2 x ntaps multiplies and adds per pixel and pass (4 x 79
// at the 79-tap level: 0.31 ms for a (32, 1080, 1920) batch at 67 TFLOP/s
// of f32), above the 5 B/px of a uint8 read and an f32 write (0.10 ms at
// 3.35 TB/s).  A block covers TY output rows x TX columns.  It blurs
// vertically into shared memory over the TX + 2r columns its horizontal
// taps reach; each thread there owns one column and RPT output rows and
// slides an RPT-row window of the input down the taps, so a column costs
// RPT + 2r loads for RPT outputs and not RPT x ntaps.  Then each thread
// blurs horizontally from shared memory.  Shared memory is
// TY x (TX + 2r) f32 plus the taps and a row table: TY shrinks (to RPT)
// as r grows, so any realistic r fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 128;      // output columns per block
constexpr int RPT = 16;      // output rows per thread in the vertical pass
constexpr int THREADS = 256;

// REFLECT_101 source index of padded position i on an axis of length n.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ float load(const uint8_t* p, long long i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gauss_kernel(const T* __restrict__ src, float* __restrict__ dst, int H, int W,
             const float* __restrict__ taps_g, int ntaps, int TY) {
  extern __shared__ float smem[];
  const int r = ntaps / 2;
  const int NC = TX + 2 * r;             // padded columns of the tile
  const int NR = TY + 2 * r;             // padded rows of the tile
  float* taps = smem;                    // [ntaps]
  int* rows = reinterpret_cast<int*>(smem + ntaps);   // [NR] source rows
  float* V = smem + ntaps + NR;          // [TY][NC] vertical sums
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const T* img = src + static_cast<long long>(blockIdx.z) * H * W;

  for (int i = threadIdx.x; i < ntaps; i += THREADS) taps[i] = taps_g[i];
  for (int i = threadIdx.x; i < NR; i += THREADS)
    rows[i] = reflect101(y0 - r + i, H);
  __syncthreads();

  // vertical pass: item (group g, padded column c) -> V[g*RPT .. +RPT][c]
  const int groups = TY / RPT;
  for (int e = threadIdx.x; e < groups * NC; e += THREADS) {
    const int g = e / NC;
    const int c = e - g * NC;
    const long long col = reflect101(x0 - r + c, W);
    const int* rg = rows + g * RPT;      // padded row of output row j, tap i: rg[j + i]
    float win[RPT], acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) win[j] = load(img, static_cast<long long>(rg[j]) * W + col);
    const float t0 = taps[0];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = t0 * win[j];
    for (int i = 1; i < ntaps; ++i) {
#pragma unroll
      for (int j = 0; j < RPT - 1; ++j) win[j] = win[j + 1];
      win[RPT - 1] = load(img, static_cast<long long>(rg[RPT - 1 + i]) * W + col);
      const float t = taps[i];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = acc[j] + t * win[j];
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) V[(g * RPT + j) * NC + c] = acc[j];
  }
  __syncthreads();

  // horizontal pass from shared memory
  float* out = dst + static_cast<long long>(blockIdx.z) * H * W;
  for (int e = threadIdx.x; e < TY * TX; e += THREADS) {
    const int ly = e / TX;
    const int lx = e - ly * TX;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W) continue;
    const float* v = V + ly * NC + lx;
    float acc = taps[0] * v[0];
    for (int i = 1; i < ntaps; ++i) acc = acc + taps[i] * v[i];
    out[static_cast<long long>(y) * W + x] = acc;
  }
}

template <typename T>
int launch(const void* src, float* dst, int n, int H, int W, const float* taps,
           int ntaps, int TY, cudaStream_t stream) {
  const int r = ntaps / 2;
  const size_t smem = sizeof(float) * (ntaps + (TY + 2 * r) +
                                       static_cast<size_t>(TY) * (TX + 2 * r));
  cudaError_t err = cudaFuncSetAttribute(
      gauss_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, n);
  gauss_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(src), dst, H, W, taps, ntaps, TY);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (n, H, W) uint8 (src_u8 != 0) or f32; dst: (n, H, W) f32, not src.
// taps: ntaps (odd) f32 on the device.  ty: output rows per block, a
// multiple of 16 whose shared memory the wrapper has checked.  Returns a
// cudaError_t.
extern "C" int oft_gauss(const void* src, int src_u8, float* dst, int n,
                         int H, int W, const float* taps, int ntaps, int ty,
                         int device, void* stream) {
  if (ntaps < 1 || ntaps % 2 == 0 || ty < RPT || ty % RPT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return launch<uint8_t>(src, dst, n, H, W, taps, ntaps, ty, s);
  return launch<float>(src, dst, n, H, W, taps, ntaps, ty, s);
}
