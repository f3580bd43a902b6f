// X1: separable resampling of f32 planes by per-axis tap tables.
//
// Replaces what optical_flow_tpu leaves to one XLA fusion between its
// Pallas kernels (no pl.pallas_call): the pyramid's x2 flow upsample with
// its scale (models/farneback/flow.py:296-297, resize_bilinear_f32 then
// the multiply), the bilinear resize after the full-resolution Gaussian
// (flow.py:231) and the seed's INTER_AREA downsample with its scale
// (flow.py:290-292).  A table is (d_len, T) source indices (int32) and
// weights (f32); the bilinear one has T = 2, INTER_AREA about
// ceil(scale) + 1 with zero-weight pads, a unit one T = 1 (weight 1).
//
// A thread takes one output pixel of one plane, or of up to PLANES planes
// where the launch has outputs enough.  For each tap of the second axis it makes
// the first axis's sum over its taps (the first-pass value that output
// needs, recomputed, not stored), then adds the weighted sums; every sum
// starts from its first term and adds the others in table order, and the
// scale is one f32 multiply at the end.  With
// --fmad=false that is the plain version's arithmetic op for op, plane by
// plane, so the result is equal to the bit (resample_taps in
// tests/test_torch_resample.py is this loop in PyTorch).
// The source is read through its strides, so the seed's (B, H, W, 2)
// layout is read in place.
//
// What bounds it: device-memory bytes, the source read once (the taps'
// re-reads hit L1/L2) and the output written once, 4 B a pixel each way.
// The thread's table entries and tap offsets are loaded once for its
// planes, whose loads are independent and in flight together; the
// bilinear tables (T = 2) are unrolled at compile time; vertical first
// (INTER_AREA), the columns' sums stay in registers while the rows go by,
// so that a warp reads each row's run contiguously.  No shared-memory
// staging of the source.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
// Threads a launch needs before a thread takes PLANES planes, not one.
constexpr long long MANY_THREADS = 1LL << 19;
constexpr int PLANES = 4;
// Horizontal taps the vertical-first kernel keeps in registers.
constexpr int AREA_COLS = 16;

// The planes [nc0, nc0 + kPlanes) of the source (nc0 < NC), with one
// division; a plane past the last repeats it (its result is not stored).
template <int kPlanes>
__device__ __forceinline__ void plane_ptrs(const float* src, long long sn, long long sc,
                                           int C, int NC, int nc0, const float** p) {
  if constexpr (kPlanes == 1) {
    p[0] = src + static_cast<long long>(nc0 / C) * sn + static_cast<long long>(nc0 % C) * sc;
    return;
  }
  int n = nc0 / C;
  int c = nc0 - n * C;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    if (q == 0 || nc0 + q < NC) {
      p[q] = src + static_cast<long long>(n) * sn + static_cast<long long>(c) * sc;
    } else {
      p[q] = p[q > 0 ? q - 1 : 0];
    }
    if (++c == C) {
      c = 0;
      ++n;
    }
  }
}

// Any tables.  kTaps > 0: both tables have kTaps taps (the bilinear 2),
// unrolled; 0: ty and tx are read at run time.  The second axis's taps
// outside, the first axis's inside.
template <bool kVerticalFirst, int kTaps, int kPlanes>
__global__ void __launch_bounds__(TX * TY)
resample_kernel(const float* __restrict__ src, long long sn, long long sc, long long sh,
                long long sw, int C, int NC, const int* __restrict__ iy,
                const float* __restrict__ wy, int ty, const int* __restrict__ ix,
                const float* __restrict__ wx, int tx, float scale,
                float* __restrict__ out, int dh, int dw) {
  const int ox = blockIdx.x * TX + threadIdx.x;
  const int oy = blockIdx.y * TY + threadIdx.y;
  if (ox >= dw || oy >= dh) return;
  const int nty = kTaps > 0 ? kTaps : ty;
  const int ntx = kTaps > 0 ? kTaps : tx;
  const int* rows = iy + static_cast<long long>(oy) * nty;
  const float* rw = wy + static_cast<long long>(oy) * nty;
  const int* cols = ix + static_cast<long long>(ox) * ntx;
  const float* cw = wx + static_cast<long long>(ox) * ntx;
  const long long plane_out = static_cast<long long>(dh) * dw;
  const long long o = static_cast<long long>(oy) * dw + ox;
  const int* first = kVerticalFirst ? rows : cols;
  const float* fw = kVerticalFirst ? rw : cw;
  const int* second = kVerticalFirst ? cols : rows;
  const float* sw2 = kVerticalFirst ? cw : rw;
  const long long fstride = kVerticalFirst ? sh : sw;
  const long long sstride = kVerticalFirst ? sw : sh;
  const int nfirst = kVerticalFirst ? nty : ntx;
  const int nsecond = kVerticalFirst ? ntx : nty;

  for (int nc0 = blockIdx.z * kPlanes; nc0 < NC; nc0 += gridDim.z * kPlanes) {
    const float* p[kPlanes];
    plane_ptrs<kPlanes>(src, sn, sc, C, NC, nc0, p);
    float acc[kPlanes];
    for (int k = 0; k < nsecond; ++k) {
      const long long so = static_cast<long long>(second[k]) * sstride;
      float v[kPlanes];
      {
        const long long fo = so + static_cast<long long>(first[0]) * fstride;
        const float w = fw[0];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) v[q] = p[q][fo] * w;
      }
      for (int m = 1; m < nfirst; ++m) {
        const long long fo = so + static_cast<long long>(first[m]) * fstride;
        const float w = fw[m];
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) v[q] = v[q] + p[q][fo] * w;
      }
      const float w2 = sw2[k];
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        const float term = v[q] * w2;
        acc[q] = k == 0 ? term : acc[q] + term;
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      if (nc0 + q < NC) out[(nc0 + q) * plane_out + o] = acc[q] * scale;
  }
}

// Vertical first with at most AREA_COLS horizontal taps (INTER_AREA at
// scales up to about 15): the same sums, the rows outside and the columns
// inside, each column's vertical sum kept in a register.  A thread then
// reads its taps' columns of a row together, and the warp a contiguous
// run of the row, where the other order strides across it.
template <int kPlanes>
__global__ void __launch_bounds__(TX * TY)
resample_rows_kernel(const float* __restrict__ src, long long sn, long long sc,
                     long long sh, long long sw, int C, int NC,
                     const int* __restrict__ iy, const float* __restrict__ wy, int ty,
                     const int* __restrict__ ix, const float* __restrict__ wx, int tx,
                     float scale, float* __restrict__ out, int dh, int dw) {
  const int ox = blockIdx.x * TX + threadIdx.x;
  const int oy = blockIdx.y * TY + threadIdx.y;
  if (ox >= dw || oy >= dh) return;
  const int* rows = iy + static_cast<long long>(oy) * ty;
  const float* rw = wy + static_cast<long long>(oy) * ty;
  long long coff[AREA_COLS];
  float cwt[AREA_COLS];
#pragma unroll
  for (int i = 0; i < AREA_COLS; ++i) {
    coff[i] = i < tx ? static_cast<long long>(ix[static_cast<long long>(ox) * tx + i]) * sw : 0;
    cwt[i] = i < tx ? wx[static_cast<long long>(ox) * tx + i] : 0.0f;
  }
  const long long plane_out = static_cast<long long>(dh) * dw;
  const long long o = static_cast<long long>(oy) * dw + ox;

  for (int nc0 = blockIdx.z * kPlanes; nc0 < NC; nc0 += gridDim.z * kPlanes) {
    const float* p[kPlanes];
    plane_ptrs<kPlanes>(src, sn, sc, C, NC, nc0, p);
    float v[AREA_COLS][kPlanes];
    for (int j = 0; j < ty; ++j) {
      const long long ro = static_cast<long long>(rows[j]) * sh;
      const float w = rw[j];
#pragma unroll
      for (int i = 0; i < AREA_COLS; ++i) {
        if (i < tx) {
#pragma unroll
          for (int q = 0; q < kPlanes; ++q) {
            const float term = p[q][ro + coff[i]] * w;
            v[i][q] = j == 0 ? term : v[i][q] + term;
          }
        }
      }
    }
    float acc[kPlanes];
#pragma unroll
    for (int i = 0; i < AREA_COLS; ++i) {
      if (i < tx) {
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          const float term = v[i][q] * cwt[i];
          acc[q] = i == 0 ? term : acc[q] + term;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanes; ++q)
      if (nc0 + q < NC) out[(nc0 + q) * plane_out + o] = acc[q] * scale;
  }
}

template <int kPlanes>
void launch(bool vertical_first, cudaStream_t s, const float* src, long long sn,
            long long sc, long long sh, long long sw, int C, int NC, const int* iy,
            const float* wy, int ty, const int* ix, const float* wx, int tx, float scale,
            float* out, int dh, int dw) {
  const dim3 block(TX, TY);
  const int groups = (NC + kPlanes - 1) / kPlanes;
  const dim3 grid((dw + TX - 1) / TX, (dh + TY - 1) / TY, groups < 65535 ? groups : 65535);
  const bool two_taps = ty == 2 && tx == 2;     // the bilinear tables
  if (vertical_first && tx <= AREA_COLS) {
    resample_rows_kernel<kPlanes><<<grid, block, 0, s>>>(
        src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale, out, dh, dw);
  } else if (vertical_first) {
    resample_kernel<true, 0, kPlanes><<<grid, block, 0, s>>>(
        src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale, out, dh, dw);
  } else if (two_taps) {
    resample_kernel<false, 2, kPlanes><<<grid, block, 0, s>>>(
        src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale, out, dh, dw);
  } else {
    resample_kernel<false, 0, kPlanes><<<grid, block, 0, s>>>(
        src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale, out, dh, dw);
  }
}

}  // namespace

// src: NC = N * C planes of H x W f32, plane (n, c) at n * sn + c * sc,
// element (y, x) at y * sh + x * sw (strides in elements); iy, wy: (dh, ty)
// vertical table; ix, wx: (dw, tx) horizontal table; out: (NC, dh, dw)
// contiguous f32.  vertical_first: 1 for the vertical pass first (INTER_AREA),
// 0 for the horizontal first (bilinear).  Returns a cudaError_t.
extern "C" int oft_resample(const float* src, long long sn, long long sc, long long sh,
                            long long sw, int C, int NC, int H, int W, const int* iy,
                            const float* wy, int ty, const int* ix, const float* wx,
                            int tx, int vertical_first, float scale, float* out,
                            int dh, int dw, int device, void* stream) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0 || NC <= 0 || H <= 0 || W <= 0 || ty <= 0 || tx <= 0 || dh <= 0 || dw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  // PLANES planes a thread (two where there are two or three) where the
  // outputs alone give threads enough
  const bool many = static_cast<long long>(dh) * dw * NC >= MANY_THREADS * PLANES;
  if (many && NC >= PLANES) {
    launch<PLANES>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx,
                   scale, out, dh, dw);
  } else if (many && NC >= 2) {
    launch<2>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale,
              out, dh, dw);
  } else {
    launch<1>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx, tx, scale,
              out, dh, dw);
  }
  return static_cast<int>(cudaGetLastError());
}
