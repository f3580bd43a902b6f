// K3: one Farnebäck pyramid level from the full-resolution frame.
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/gauss_resize.py
// (gaussian_blur_resize_multi and gaussian_blur_resize_pallas): for each
// level, a REFLECT_101 Gaussian of the full-resolution frame followed by
// cv2's INTER_LINEAR resize to the level size,
//     out = resize_bilinear_f32(gaussian_blur_reflect101(img, g), ow, oh),
// for any dims (the TPU kernel needs exact division by 2^k).
//
// What bounds it: the read of the frame, 1 B/px (uint8) or 4 B/px (f32)
// from device memory, plus 4 B per output pixel.  Each output pixel reads
// the blurred image at only four points (two source rows x two source
// columns, from the _coeffs_f32 tables), so the block blurs vertically at
// just the source rows its output rows read, for the span of source
// columns its output columns reach (shared memory), and then blurs
// horizontally at the two source columns per output pixel.  The
// arithmetic follows the plain version op for op, in the same order
// (vertical taps, horizontal taps, horizontal lerp, vertical lerp), so
// that with --fmad=false the two agree to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 32;
constexpr int TX = 32;  // output columns per block (one per thread)
constexpr int TY = 8;   // output rows per block (one per thread)

struct Taps {
  float v[kMaxTaps];
};

// Single reflection (REFLECT_101); the wrapper guarantees n > radius.
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

template <typename T>
__global__ void gauss_resize_kernel(const T* __restrict__ src,
                                    float* __restrict__ dst, int H, int W,
                                    int oh, int ow,
                                    const int* __restrict__ sy0,
                                    const int* __restrict__ sy1,
                                    const float* __restrict__ ty,
                                    const int* __restrict__ sx0,
                                    const int* __restrict__ sx1,
                                    const float* __restrict__ tx, Taps taps,
                                    int ntaps, int ncols_max) {
  extern __shared__ float vblur[];  // [2 * TY][ncols_max]
  const int r = ntaps / 2;
  const int ox0 = blockIdx.x * TX;
  const int oy0 = blockIdx.y * TY;
  const int ox_last = min(ox0 + TX, ow) - 1;
  const int rows_out = min(TY, oh - oy0);
  // every source column the tile's horizontal taps reach, reflected
  // indices included, lies in [c_lo, c_hi]
  const int c_lo = max(sx0[ox0] - r, 0);
  const int c_hi = min(sx1[ox_last] + r, W - 1);
  const int ncols = c_hi - c_lo + 1;
  const T* img = src + static_cast<long long>(blockIdx.z) * H * W;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // vertical pass at the source rows sy0/sy1 of each output row
  for (int e = tid; e < 2 * rows_out * ncols; e += TX * TY) {
    const int slot = e / ncols;
    const int c = e - slot * ncols;
    const int oy = oy0 + (slot >> 1);
    const int y = (slot & 1) ? sy1[oy] : sy0[oy];
    const long long col = c_lo + c;
    float acc = taps.v[0] * load(img, static_cast<long long>(reflect101(y - r, H)) * W + col);
    for (int i = 1; i < ntaps; ++i)
      acc = acc + taps.v[i] * load(img, static_cast<long long>(reflect101(y + i - r, H)) * W + col);
    vblur[slot * ncols_max + c] = acc;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x;
  const int oy = oy0 + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const int xs[2] = {sx0[ox], sx1[ox]};
  float b[2][2];
  for (int s = 0; s < 2; ++s) {
    const float* row = vblur + (2 * threadIdx.y + s) * ncols_max;
    for (int q = 0; q < 2; ++q) {
      float acc = taps.v[0] * row[reflect101(xs[q] - r, W) - c_lo];
      for (int i = 1; i < ntaps; ++i)
        acc = acc + taps.v[i] * row[reflect101(xs[q] + i - r, W) - c_lo];
      b[s][q] = acc;
    }
  }
  const float t = tx[ox];
  const float u = ty[oy];
  const float row0 = b[0][0] * (1.0f - t) + b[0][1] * t;
  const float row1 = b[1][0] * (1.0f - t) + b[1][1] * t;
  dst[(static_cast<long long>(blockIdx.z) * oh + oy) * ow + ox] =
      row0 * (1.0f - u) + row1 * u;
}

template <typename T>
int launch(const void* src, float* dst, int n, int H, int W, int oh, int ow,
           const int* sy0, const int* sy1, const float* ty, const int* sx0,
           const int* sx1, const float* tx, const Taps& taps, int ntaps,
           int ncols_max, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * TY * ncols_max;
  cudaError_t err = cudaFuncSetAttribute(
      gauss_resize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, TY);
  const dim3 grid((ow + TX - 1) / TX, (oh + TY - 1) / TY, n);
  gauss_resize_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(src), dst, H, W, oh, ow, sy0, sy1, ty, sx0, sx1,
      tx, taps, ntaps, ncols_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (n, H, W) uint8 (src_u8 != 0) or f32; dst: (n, oh, ow) f32.
// sy0/sy1/ty (oh) and sx0/sx1/tx (ow): device tables of _coeffs_f32.
// taps: host array of ntaps f32.  ncols_max: the widest source-column
// span of any block, computed by the wrapper.  Returns a cudaError_t.
extern "C" int oft_gauss_resize(const void* src, int src_u8, float* dst,
                                int n, int H, int W, int oh, int ow,
                                const int* sy0, const int* sy1,
                                const float* ty, const int* sx0,
                                const int* sx1, const float* tx,
                                const float* taps, int ntaps, int ncols_max,
                                int device, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps t = {};
  for (int i = 0; i < ntaps; ++i) t.v[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return launch<uint8_t>(src, dst, n, H, W, oh, ow, sy0, sy1, ty, sx0, sx1,
                           tx, t, ntaps, ncols_max, s);
  return launch<float>(src, dst, n, H, W, oh, ow, sy0, sy1, ty, sx0, sx1, tx,
                       t, ntaps, ncols_max, s);
}
