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
// columns, from the _coeffs_f32 tables).  A block takes a tile of
// tile_w x tile_h output pixels (sized per level and dtype by the
// wrapper, so that the band fits shared memory for uint8 and f32 frames
// alike) and:
//   1. stages its source band once in shared memory: the reflected rows
//      [sy0(first row) - r, sy1(last row) + r] x the reflected columns
//      [sx0(first column) - r, sx1(last column) + r], with 16-byte vector
//      loads where the frame's rows are 16-byte aligned and a group of
//      columns lies inside the image, scalar loads elsewhere;
//   2. blurs vertically at the two source rows of each output row, from
//      the band, both rows' tap chains in one pass over the ntaps + 1
//      band rows they span (register-blocked);
//   3. blurs horizontally at the two source columns of each output pixel,
//      both chains in one pass, and interpolates.
// Indices into the band are reflected once at staging, so no tap reflects.
// The arithmetic follows the plain version op for op, in the same order
// (vertical taps, horizontal taps, horizontal lerp, vertical lerp), so
// that with --fmad=false the two agree to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 32;
constexpr int kThreads = 256;

struct Taps {
  float v[kMaxTaps];
};

// Single reflection (REFLECT_101); the wrapper guarantees n > radius.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_len() {
  return 16 / static_cast<int>(sizeof(T));
}

// a0 = t[0] v(0) + ... + t[n-1] v(n-1) and a1 the same over v(d), ...,
// v(n-1+d), d in {0, 1}, each in tap order, from one pass over the
// n + d values; for NC columns at once, load(i, v) giving value i of each.
template <int NC, typename Load>
__device__ __forceinline__ void pair_chains(Load load, const Taps& taps, int n,
                                            int d, float (&a0)[NC],
                                            float (&a1)[NC]) {
  float x[NC];
  load(0, x);
#pragma unroll
  for (int j = 0; j < NC; ++j) a0[j] = taps.v[0] * x[j];
  if (d == 0) {
    for (int i = 1; i < n; ++i) {
      load(i, x);
#pragma unroll
      for (int j = 0; j < NC; ++j) a0[j] = a0[j] + taps.v[i] * x[j];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) a1[j] = a0[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) a1[j] = 0.0f;
  for (int i = 1; i < n; ++i) {
    load(i, x);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      a1[j] = (i == 1) ? taps.v[0] * x[j] : a1[j] + taps.v[i - 1] * x[j];
      a0[j] = a0[j] + taps.v[i] * x[j];
    }
  }
  load(n, x);
#pragma unroll
  for (int j = 0; j < NC; ++j)
    a1[j] = (n == 1) ? taps.v[0] * x[j] : a1[j] + taps.v[n - 1] * x[j];
}

// Four adjacent band values at p (4-element aligned) as floats: a uint8
// byte b becomes (2^23 + b) - 2^23, exact, without a conversion
// instruction.
__device__ __forceinline__ void load4(const uint8_t* p, float (&v)[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) - 8388608.0f;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gauss_resize_kernel(const T* __restrict__ src, float* __restrict__ dst,
                    int H, int W, int oh, int ow,
                    const int* __restrict__ sy0, const int* __restrict__ sy1,
                    const float* __restrict__ ty, const int* __restrict__ sx0,
                    const int* __restrict__ sx1, const float* __restrict__ tx,
                    const __grid_constant__ Taps taps, int ntaps,
                    int tile_w, int tile_h, int band_stride,
                    int band_rows_max, int ncols_max, int aligned) {
  constexpr int V = vec_len<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);   // [band_rows_max][band_stride]
  float* vb = reinterpret_cast<float*>(   // [2 * tile_h][ncols_max]
      smem + sizeof(T) * band_rows_max * band_stride);
  const int r = ntaps / 2;
  const int ox0 = blockIdx.x * tile_w;
  const int oy0 = blockIdx.y * tile_h;
  const int cols_out = min(tile_w, ow - ox0);
  const int rows_out = min(tile_h, oh - oy0);
  const int ylo = sy0[oy0] - r;
  const int yhi = sy1[oy0 + rows_out - 1] + r;
  const int xlo = sx0[ox0] - r;
  const int xhi = sx1[ox0 + cols_out - 1] + r;
  // band column k holds image column xs + k: xs is xlo rounded down to a
  // vector boundary, so that vector loads stay aligned
  const int xs = xlo - (((xlo % V) + V) % V);
  const int koff = xlo - xs;                 // band column of xlo
  const int ncols = xhi - xlo + 1;
  const int nrows = yhi - ylo + 1;
  const T* img = src + static_cast<long long>(blockIdx.z) * H * W;
  const int tid = threadIdx.x;

  // 1. the band, reflected
  if (aligned) {
    // four 16-byte groups a thread at a time, their loads issued together
    constexpr int U = 4;
    const int ngroups = (xhi - xs) / V + 1;
    const int total = nrows * ngroups;
    for (int e0 = tid; e0 < total; e0 += U * kThreads) {
      uint4 v[U];
      int j[U], x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = min(e0 + u * kThreads, total - 1);
        j[u] = e / ngroups;
        x[u] = xs + (e - j[u] * ngroups) * V;
        if (x[u] >= 0 && x[u] + V <= W)
          v[u] = *reinterpret_cast<const uint4*>(
              img + static_cast<long long>(reflect101(ylo + j[u], H)) * W + x[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        T* out = band + j[u] * band_stride + (x[u] - xs);
        if (x[u] >= 0 && x[u] + V <= W) {
          *reinterpret_cast<uint4*>(out) = v[u];
        } else {
          const T* row = img + static_cast<long long>(reflect101(ylo + j[u], H)) * W;
          for (int i = 0; i < V; ++i) {
            const int xx = x[u] + i;
            out[i] = (xx >= xlo && xx <= xhi) ? row[reflect101(xx, W)] : T(0);
          }
        }
      }
    }
  } else {
    for (int e = tid; e < nrows * ncols; e += kThreads) {
      const int j = e / ncols;
      const int c = e - j * ncols;
      const T* row = img + static_cast<long long>(reflect101(ylo + j, H)) * W;
      band[j * band_stride + koff + c] = row[reflect101(xlo + c, W)];
    }
  }
  __syncthreads();

  // 2. vertical taps at each output row's two source rows, four adjacent
  // band columns a thread (one 4- or 16-byte read a row); thread e takes
  // items e, e + kThreads, ... of rows_out x ngroups, stepped without a
  // division.  Band columns left of xlo (the alignment slack) are summed
  // and dropped.
  const int ngroups = (koff + ncols + 3) / 4;
  for (int g = tid, oyl = 0;; g += kThreads) {
    while (g >= ngroups) g -= ngroups, ++oyl;
    if (oyl >= rows_out) break;
    const int a = sy0[oy0 + oyl];
    const T* col = band + (a - r - ylo) * band_stride + 4 * g;
    float v0[4], v1[4];
    pair_chains<4>([&](int i, float (&v)[4]) { load4(col + i * band_stride, v); },
                   taps, ntaps, sy1[oy0 + oyl] - a, v0, v1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g + j - koff;
      if (c >= 0 && c < ncols) {
        vb[(2 * oyl) * ncols_max + c] = v0[j];
        vb[(2 * oyl + 1) * ncols_max + c] = v1[j];
      }
    }
  }
  __syncthreads();

  // 3. horizontal taps at each output pixel's two source columns, then
  // the horizontal and the vertical lerp; a thread keeps one output column
  // (tile_w divides kThreads) and its tables
  const int oxl = tid % tile_w;
  if (oxl >= cols_out) return;
  const int ox = ox0 + oxl;
  const int a = sx0[ox];
  const int d = sx1[ox] - a;
  const float t = tx[ox];
  for (int ol = tid / tile_w; ol < rows_out; ol += kThreads / tile_w) {
    const int oy = oy0 + ol;
    // both slots' rows at once: b0 the columns' sums on the row of sy0,
    // b1 on the row of sy1
    const float* row = vb + (2 * ol) * ncols_max + (a - r - xlo);
    float b0[2], b1[2];
    pair_chains<2>(
        [&](int i, float (&v)[2]) {
          v[0] = row[i];
          v[1] = row[ncols_max + i];
        },
        taps, ntaps, d, b0, b1);
    const float u = ty[oy];
    const float row0 = b0[0] * (1.0f - t) + b1[0] * t;
    const float row1 = b0[1] * (1.0f - t) + b1[1] * t;
    dst[(static_cast<long long>(blockIdx.z) * oh + oy) * ow + ox] =
        row0 * (1.0f - u) + row1 * u;
  }
}

template <typename T>
size_t smem_bytes(int tile_h, int band_stride, int band_rows_max, int ncols_max) {
  return sizeof(T) * band_rows_max * band_stride +
         sizeof(float) * 2 * tile_h * ncols_max;
}

template <typename T>
int launch(const void* src, float* dst, int n, int H, int W, int oh, int ow,
           const int* sy0, const int* sy1, const float* ty, const int* sx0,
           const int* sx1, const float* tx, const Taps& taps, int ntaps,
           const int* tile, int aligned, cudaStream_t stream) {
  const int tile_w = tile[0], tile_h = tile[1], band_stride = tile[2],
            band_rows_max = tile[3], ncols_max = tile[4];
  if (band_stride % vec_len<T>() != 0 || tile_w < 1 || kThreads % tile_w != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(tile_h, band_stride, band_rows_max, ncols_max);
  cudaError_t err = cudaFuncSetAttribute(
      gauss_resize_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ow + tile_w - 1) / tile_w, (oh + tile_h - 1) / tile_h, n);
  gauss_resize_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), dst, H, W, oh, ow, sy0, sy1, ty, sx0, sx1,
      tx, taps, ntaps, tile_w, tile_h, band_stride, band_rows_max, ncols_max,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: (n, H, W) uint8 (src_u8 != 0) or f32; dst: (n, oh, ow) f32.
// sy0/sy1/ty (oh) and sx0/sx1/tx (ow): device tables of _coeffs_f32.
// taps: host array of ntaps f32.  tile: host array (tile_w, tile_h,
// band_stride, band_rows_max, ncols_max) from the wrapper: the output
// tile (tile_w a power of two up to 256), the band's row stride in elements (a multiple of 16 bytes), the
// most band rows and the most vertically blurred columns of any block.
// aligned != 0: src and every frame row start on a 16-byte boundary.
// Returns a cudaError_t.
extern "C" int oft_gauss_resize(const void* src, int src_u8, float* dst,
                                int n, int H, int W, int oh, int ow,
                                const int* sy0, const int* sy1,
                                const float* ty, const int* sx0,
                                const int* sx1, const float* tx,
                                const float* taps, int ntaps, const int* tile,
                                int aligned, int device, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps t = {};
  for (int i = 0; i < ntaps; ++i) t.v[i] = taps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8)
    return launch<uint8_t>(src, dst, n, H, W, oh, ow, sy0, sy1, ty, sx0, sx1,
                           tx, t, ntaps, tile, aligned, s);
  return launch<float>(src, dst, n, H, W, oh, ow, sy0, sy1, ty, sx0, sx1, tx,
                       t, ntaps, tile, aligned, s);
}

// Blocks of the kernel resident on one SM with `smem` bytes of dynamic
// shared memory, into *blocks.  Returns a cudaError_t.
extern "C" int oft_gauss_resize_occupancy(int src_u8, int smem, int device,
                                          int* blocks) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (src_u8) {
    err = cudaFuncSetAttribute(gauss_resize_kernel<uint8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gauss_resize_kernel<uint8_t>, kThreads, smem);
  } else {
    err = cudaFuncSetAttribute(gauss_resize_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gauss_resize_kernel<float>, kThreads, smem);
  }
  return static_cast<int>(err);
}
