// X2: per-pair sums of the flow magnitude, deterministic, in f64.
//
// Replaces what optical_flow_tpu leaves to one XLA fusion (no
// pl.pallas_call): cart_to_polar's magnitude summed over each pair's
// pixels (pipeline/extractor.py:113-114).  flow: planar (B, 2, H, W) f32;
// sums: (B,) f32.
//
// Each pixel's magnitude is sqrt(x*x + y*y): two f32 products and their
// sum (--fmad=false), then the correctly rounded sqrt (__fsqrt_rn), as the
// plain version (ops/polar.py:magnitude) computes it.  A pair's pixels are
// cut into spans of SPAN; block (s, b) sums span s of pair b: its thread t
// sums, in f64, pixels t, t + THREADS, ... of the span in that order, and
// the block adds its threads' sums by a fixed tree in shared memory.  A
// pair of one span is rounded to f32 there; otherwise each block writes
// its f64 sum, and a second launch adds a pair's span sums in span order
// and rounds once.  No atomics: the order depends on H * W alone, so a
// pair's sum does not depend on the batch or the run, and a frame of any
// size spreads over the card (an 8K pair is 254 blocks).
//
// What bounds it: device-memory bytes, 8 B a pixel read.  Each thread
// keeps UNROLL pixels' loads in flight before it adds them in order.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr long long SPAN = 1 << 17;     // pixels a block sums
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ double magnitude(float x, float y) {
  const float s = x * x + y * y;
  return static_cast<double>(__fsqrt_rn(s));
}

__global__ void __launch_bounds__(THREADS)
span_sum_kernel(const float* __restrict__ flow, long long hw, int spans,
                double* __restrict__ partial, float* __restrict__ sums) {
  __shared__ double part[THREADS];
  const int t = threadIdx.x;
  const float* fx = flow + static_cast<long long>(blockIdx.y) * 2 * hw;
  const float* fy = fx + hw;
  const long long lo = static_cast<long long>(blockIdx.x) * SPAN;
  const long long hi = lo + SPAN < hw ? lo + SPAN : hw;
  double acc = 0.0;
  long long p = lo + t;
  for (; p + (UNROLL - 1) * THREADS < hi; p += UNROLL * THREADS) {
    float x[UNROLL], y[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = fx[p + u * THREADS];
      y[u] = fy[p + u * THREADS];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += magnitude(x[u], y[u]);
  }
  for (; p < hi; p += THREADS) acc += magnitude(fx[p], fy[p]);
  part[t] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) part[t] += part[t + s];
    __syncthreads();
  }
  if (t == 0) {
    if (spans == 1) {
      sums[blockIdx.y] = static_cast<float>(part[0]);
    } else {
      partial[static_cast<long long>(blockIdx.y) * spans + blockIdx.x] = part[0];
    }
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const double* __restrict__ partial, int spans, int B,
               float* __restrict__ sums) {
  const int b = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (b >= B) return;
  const double* row = partial + static_cast<long long>(b) * spans;
  double total = row[0];
  for (int s = 1; s < spans; ++s) total += row[s];
  sums[b] = static_cast<float>(total);
}

}  // namespace

// The spans a pair of hw pixels is cut into; the launches are 1 for one
// span, else 2 (the span sums, then their sum).
extern "C" int oft_magnitude_sum_spans(long long hw) {
  return hw <= SPAN ? 1 : static_cast<int>((hw + SPAN - 1) / SPAN);
}

// flow: (B, 2, H, W) f32 contiguous, hw = H * W; partial: (B, spans) f64
// scratch where spans > 1 (else unused); sums: (B,) f32.  B <= 65535.
// Returns a cudaError_t.
extern "C" int oft_magnitude_sum(const float* flow, int B, long long hw, double* partial,
                                 float* sums, int device, void* stream) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int spans = oft_magnitude_sum_spans(hw);
  auto s = static_cast<cudaStream_t>(stream);
  span_sum_kernel<<<dim3(spans, B), THREADS, 0, s>>>(flow, hw, spans, partial, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess || spans == 1) return static_cast<int>(err);
  combine_kernel<<<(B + COMBINE_THREADS - 1) / COMBINE_THREADS, COMBINE_THREADS, 0, s>>>(
      partial, spans, B, sums);
  return static_cast<int>(cudaGetLastError());
}
