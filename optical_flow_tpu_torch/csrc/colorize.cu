// K4: flow -> BGR colorization of the visualizer.
//
// Replaces optical_flow_tpu/pallas/colorize.py (flow_to_bgr_planar_pallas,
// with the per-frame min/max that the JAX package leaves to XLA):
// planar flow (B, 2, H, W) f32 -> planar BGR (B, 3, H, W) uint8, with the
// reference's quirks (visualize_optical_flow.py:48-55): fastAtan2 hue
// through the f32 deg -> rad -> deg round-trip, floor then mod 256 (the
// hue double-wrap), value = clip(floor(mag * scale + shift), 0, 255) from
// the frame's magnitude range, saturation 255 * f32(1/255), cv2's 8-bit
// HSV -> BGR sector select and floor(x * 255) truncation.
//
// Two launches:
//   minmax_kernel    a (parts, B) grid; block p of frame b writes the min
//                    and max magnitude over its strided share of the
//                    frame to parts[b][p].  No atomics: float min/max do
//                    not depend on order, so the result equals torch's
//                    amin/amax to the bit.
//   colorize_kernel  one thread per pixel; the first warp of each block
//                    folds the frame's parts into (scale, shift).
//
// What bounds it: device memory, 8 B/px read twice (the second read
// mostly from L2 at small batches) and 3 B/px written.  The arithmetic
// follows ops/colorize.py op for op; built with --fmad=false, so products
// are not contracted into the additions that follow them and the bytes
// equal the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 32;  // as _MAX_PARTS in kernels/colorize.py

// fastAtan2 polynomial in degrees, as f32 (ops/polar.py).
constexpr float kP1 = static_cast<float>(0.9997878412794807 * (180.0 / 3.141592653589793));
constexpr float kP3 = static_cast<float>(-0.3258083974640975 * (180.0 / 3.141592653589793));
constexpr float kP5 = static_cast<float>(0.1555786518463281 * (180.0 / 3.141592653589793));
constexpr float kP7 = static_cast<float>(-0.04432655554792128 * (180.0 / 3.141592653589793));
constexpr float kDblEps = static_cast<float>(2.220446049250313e-16);
constexpr float kRadPerDeg = static_cast<float>(3.141592653589793 / 180.0);
constexpr float kDegPerRad = static_cast<float>(180.0 / 3.141592653589793);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kSixOver180 = static_cast<float>(6.0 / 180.0);

__device__ __forceinline__ float magnitude(float fx, float fy) {
  return sqrtf(fx * fx + fy * fy);
}

__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

__global__ void minmax_kernel(const float* __restrict__ flow,
                              float* __restrict__ parts, long long plane,
                              int nparts) {
  const int b = blockIdx.y;
  const float* fx = flow + 2LL * b * plane;
  const float* fy = fx + plane;
  float mn = INFINITY;
  float mx = -INFINITY;
  const long long stride = static_cast<long long>(nparts) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < plane; i += stride) {
    const float m = magnitude(fx[i], fy[i]);
    mn = fminf(mn, m);
    mx = fmaxf(mx, m);
  }
  __shared__ float smn[kThreads / 32];
  __shared__ float smx[kThreads / 32];
  warp_minmax(mn, mx);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    smn[warp] = mn;
    smx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kThreads / 32 ? smn[lane] : INFINITY;
    mx = lane < kThreads / 32 ? smx[lane] : -INFINITY;
    warp_minmax(mn, mx);
    if (lane == 0) {
      float* out = parts + 2LL * (static_cast<long long>(b) * nparts + blockIdx.x);
      out[0] = mn;
      out[1] = mx;
    }
  }
}

__global__ void colorize_kernel(const float* __restrict__ flow,
                                const float* __restrict__ parts, int nparts,
                                uint8_t* __restrict__ bgr, long long plane) {
  const int b = blockIdx.y;
  __shared__ float ss[2];  // scale, shift
  if (threadIdx.x < 32) {
    float mn = INFINITY;
    float mx = -INFINITY;
    const float* pp = parts + 2LL * b * nparts;
    for (int p = threadIdx.x; p < nparts; p += 32) {
      mn = fminf(mn, pp[2 * p]);
      mx = fmaxf(mx, pp[2 * p + 1]);
    }
    warp_minmax(mn, mx);
    if (threadIdx.x == 0) {
      const float rng = mx - mn;
      const float scale = rng > kDblEps ? 255.0f / rng : 0.0f;
      ss[0] = scale;
      ss[1] = -mn * scale;
    }
  }
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= plane) return;

  const float fx = flow[2LL * b * plane + i];
  const float fy = flow[(2LL * b + 1) * plane + i];
  const float mag = magnitude(fx, fy);

  // fastAtan2 (degrees), then the deg -> rad -> deg round-trip
  const float ax = fabsf(fx);
  const float ay = fabsf(fy);
  const float lo = fminf(ax, ay);
  const float hi = fmaxf(ax, ay);
  const float c = lo / (hi + kDblEps);
  const float c2 = c * c;
  const float poly = (((kP7 * c2 + kP5) * c2 + kP3) * c2 + kP1) * c;
  float a = ax >= ay ? poly : 90.0f - poly;
  if (fx < 0.0f) a = 180.0f - a;
  if (fy < 0.0f) a = 360.0f - a;
  const float hue = fmodf(floorf((a * kRadPerDeg) * kDegPerRad), 256.0f);

  float value = floorf(mag * ss[0] + ss[1]);
  value = fminf(fmaxf(value, 0.0f), 255.0f);

  // cv2 8-bit HSV -> BGR (vectorized path), saturation 255
  const float s = 255.0f * kInv255;
  const float v = value * kInv255;
  float hh = hue * kSixOver180;
  if (hh >= 6.0f) hh = hh - 6.0f;
  const float fl = floorf(hh);
  const float hfrac = hh - fl;
  const int sector = static_cast<int>(fminf(fmaxf(fl, 0.0f), 5.0f));
  const float t0 = v;
  const float t1 = v * (1.0f - s);
  const float t2 = v * (-s * hfrac + 1.0f);
  const float t3 = v * (-s * (1.0f - hfrac) + 1.0f);
  float ch[3];
  switch (sector) {  // OpenCV sector_data: (b, g, r) from t0..t3
    case 0: ch[0] = t1; ch[1] = t3; ch[2] = t0; break;
    case 1: ch[0] = t1; ch[1] = t0; ch[2] = t2; break;
    case 2: ch[0] = t3; ch[1] = t0; ch[2] = t1; break;
    case 3: ch[0] = t0; ch[1] = t2; ch[2] = t1; break;
    case 4: ch[0] = t0; ch[1] = t1; ch[2] = t3; break;
    default: ch[0] = t2; ch[1] = t1; ch[2] = t0; break;
  }
  uint8_t* out = bgr + 3LL * b * plane + i;
  for (int k = 0; k < 3; ++k) {
    const float q = fminf(fmaxf(floorf(ch[k] * 255.0f), 0.0f), 255.0f);
    out[k * plane] = static_cast<uint8_t>(q);
  }
}

}  // namespace

// flow: (B, 2, H, W) f32; parts: (B, nparts, 2) f32 scratch;
// bgr: (B, 3, H, W) uint8; plane = H * W.  Returns a cudaError_t.
extern "C" int oft_colorize(const float* flow, float* parts, uint8_t* bgr,
                            int B, long long plane, int nparts, int device,
                            void* stream) {
  if (nparts < 1 || nparts > kMaxParts || B < 1 || plane < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_kernel<<<dim3(nparts, B), kThreads, 0, s>>>(flow, parts, plane, nparts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  colorize_kernel<<<dim3(static_cast<unsigned>(blocks), B), kThreads, 0, s>>>(
      flow, parts, nparts, bgr, plane);
  return static_cast<int>(cudaGetLastError());
}
