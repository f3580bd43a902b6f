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
// What bounds it: device memory, 8 B/px of flow read and 3 B/px written,
// with about 100 f32 instructions a pixel beside it.  The map of a frame
// needs that frame's magnitude range, so a design that reduces in one
// launch and maps in a second reads the flow twice.  This one reads it
// once: a persistent cooperative launch (every block resident) walks the
// frames in order, two blocks an SM.  The blocks form NG groups (two when
// B > 1), group g taking frames g, g + NG, ...; the G blocks of a
// group split each frame into slices of quads (4 pixels).  For its frame a
// block
//   1. loads its slice with 16-byte loads of fx and fy (scalar loads where
//      H * W is not a multiple of 4, whose planes are then not aligned, and
//      for the ragged last quad), a quad ahead of its use, keeps each
//      pixel's magnitude (f32) and hue (the byte it becomes) in shared
//      memory, 5 B/px, and publishes the slice's (min, max) to
//      parts[b][block], counting itself in counters[b];
//   2. waits until all G blocks of the group have published (the launch
//      is cooperative, so they are all resident) and folds the G pairs
//      into (scale, shift);
//   3. maps its slice from shared memory, writing each plane with one
//      4-byte store a quad.
// While one group maps or waits, the other group's block on the same SM
// streams its own frame.
// At 1080p a frame's slice is 3928 quads, 77 KB, so it fits on chip and
// the flow crosses HBM once; a slice past the cache's capacity re-reads
// its overflow when it maps.
// Float min and max do not depend on order, so (scale, shift) equal
// ops/polar.py:minmax_scale_shift's.  The arithmetic follows
// ops/colorize.py op for op; built with --fmad=false, so products are not
// contracted into the additions that follow them and the bytes equal the
// plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerQuad = 20;   // 4 f32 magnitudes + 4 hue bytes
// Dynamic shared memory a block may use with two blocks an SM (228 KB,
// less each block's 1 KB reserve and static arrays).
constexpr int kSmem = 112 * 1024;

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

// Integer-valued floats in [0, 256) to and from bytes without the
// conversion unit: v + 2^23 holds v in its low mantissa bits, exactly.
__device__ __forceinline__ uint32_t byte_of(float v) {
  return __float_as_uint(v + 8388608.0f) & 0xffu;
}
__device__ __forceinline__ float float_of(uint32_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

__device__ __forceinline__ float magnitude(float fx, float fy) {
  return sqrtf(fx * fx + fy * fy);
}

// The uint8 hue: fastAtan2 (degrees), the deg -> rad -> deg round-trip,
// floor, mod 256.
__device__ __forceinline__ uint32_t hue_of(float fx, float fy) {
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
  // fmodf(h, 256) for the h in [0, 360] that reach here
  const float h = floorf((a * kRadPerDeg) * kDegPerRad);
  return byte_of(h >= 256.0f ? h - 256.0f : h);
}

// cv2 8-bit HSV -> BGR (vectorized path), saturation 255: the three bytes
// packed as b | g << 8 | r << 16.
__device__ __forceinline__ uint32_t bgr_of(float hue, float mag, float scale,
                                           float shift) {
  float value = floorf(mag * scale + shift);
  value = fminf(fmaxf(value, 0.0f), 255.0f);
  const float s = 255.0f * kInv255;
  const float v = value * kInv255;
  float hh = hue * kSixOver180;
  if (hh >= 6.0f) hh = hh - 6.0f;
  const float fl = floorf(hh);
  const float hfrac = hh - fl;
  const uint32_t sector = byte_of(fminf(fmaxf(fl, 0.0f), 5.0f));
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
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float q = fminf(fmaxf(floorf(ch[k] * 255.0f), 0.0f), 255.0f);
    out |= byte_of(q) << (8 * k);
  }
  return out;
}

__device__ __forceinline__ void warp_minmax(float& mn, float& mx) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
}

// How a launch cuts the batch (oft_colorize computes it).
struct Plan {
  long long plane;   // P = H * W pixels a frame
  long long quads;   // ceil(P / 4)
  long long slice;   // quads a block takes of each frame: ceil(quads / G)
  int G;             // blocks a group
  int NG;            // groups
  int cap;           // quads of its slice a block keeps in shared memory
  int vec;           // planes 16-byte (flow) and 4-byte (BGR) aligned
};

// Quad q of a frame: up to 4 pixels of fx and fy; n = the valid ones.
__device__ __forceinline__ int load_quad(const float* fx, const float* fy,
                                         long long q, const Plan& p, float (&x)[4],
                                         float (&y)[4]) {
  const long long i = 4 * q;
  const int n = static_cast<int>(min(4LL, p.plane - i));
  if (p.vec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(fx + i));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(fy + i));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = c < n ? __ldcs(fx + i + c) : 0.0f;
      y[c] = c < n ? __ldcs(fy + i + c) : 0.0f;
    }
  }
  return n;
}

// Magnitudes and hue bytes of a quad, and its valid pixels' (min, max).
__device__ __forceinline__ uint32_t quad_polar(const float (&x)[4], const float (&y)[4],
                                               int n, float (&m)[4], float& mn,
                                               float& mx) {
  uint32_t hue = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m[c] = magnitude(x[c], y[c]);
    if (c < n) {
      mn = fminf(mn, m[c]);
      mx = fmaxf(mx, m[c]);
    }
    hue |= hue_of(x[c], y[c]) << (8 * c);
  }
  return hue;
}

// The block's (min, max) of its slice into parts[b][k]; then count the
// block in for frame b.
__device__ __forceinline__ void publish(float mn, float mx, float2* parts,
                                        unsigned int* counters, int b, int k,
                                        const Plan& p, float (&red)[2][kWarps]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  warp_minmax(mn, mx);
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kWarps ? red[0][lane] : INFINITY;
    mx = lane < kWarps ? red[1][lane] : -INFINITY;
    warp_minmax(mn, mx);
    if (lane == 0) {
      parts[static_cast<long long>(b) * p.G + k] = make_float2(mn, mx);
      __threadfence();
      atomicAdd(counters + b, 1u);
    }
  }
}

// Wait until the group's G blocks have published frame b, then fold their
// pairs into (scale, shift) in ss, for every thread of the block.
__device__ __forceinline__ void frame_scale(const float2* parts, unsigned int* counters,
                                            int b, const Plan& p, float (&ss)[2]) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    if (lane == 0) {
      volatile unsigned int* count = counters + b;
      while (*count < static_cast<unsigned int>(p.G)) {
      }
      __threadfence();
    }
    __syncwarp();
    float mn = INFINITY;
    float mx = -INFINITY;
    for (int i = lane; i < p.G; i += 32) {
      const float2 pr = __ldcg(parts + static_cast<long long>(b) * p.G + i);
      mn = fminf(mn, pr.x);
      mx = fmaxf(mx, pr.y);
    }
    warp_minmax(mn, mx);
    if (lane == 0) {
      const float rng = mx - mn;
      const float scale = rng > kDblEps ? 255.0f / rng : 0.0f;
      ss[0] = scale;
      ss[1] = -mn * scale;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
colorize_kernel(const float* __restrict__ flow, float2* parts,
                unsigned int* counters, uint8_t* __restrict__ bgr,
                int B, const Plan p) {
  extern __shared__ float4 smem4[];
  float4* cmag = smem4;                                     // [cap]
  uint32_t* chue = reinterpret_cast<uint32_t*>(smem4 + p.cap);   // [cap]
  __shared__ float red[2][kWarps];
  __shared__ float ss[2];  // scale, shift
  const int grp = blockIdx.x / p.G;
  const int k = blockIdx.x - grp * p.G;
  const long long q0 = k * p.slice;
  const long long q1 = min(q0 + p.slice, p.quads);
  const long long P = p.plane;

  for (int b = grp; b < B; b += p.NG) {
    const float* fx = flow + 2LL * b * P;
    const float* fy = fx + P;

    // 1. magnitudes and hues of the slice on chip, each thread loading its
    //    next quad while it works on this one; the slice's (min, max)
    {
      float mn = INFINITY;
      float mx = -INFINITY;
      float x[4], y[4], nx[4], ny[4];
      long long q = q0 + threadIdx.x;
      int n = q < q1 ? load_quad(fx, fy, q, p, x, y) : 0;
      for (; q < q1; q += kThreads) {
        const int nn = q + kThreads < q1 ? load_quad(fx, fy, q + kThreads, p, nx, ny) : 0;
        float m[4];
        const uint32_t hue = quad_polar(x, y, n, m, mn, mx);
        const long long l = q - q0;
        if (l < p.cap) {
          cmag[l] = make_float4(m[0], m[1], m[2], m[3]);
          chue[l] = hue;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[c] = nx[c];
          y[c] = ny[c];
        }
        n = nn;
      }
      publish(mn, mx, parts, counters, b, k, p, red);
    }

    // 2. wait for the group's other blocks; the frame's (scale, shift)
    frame_scale(parts, counters, b, p, ss);
    const float scale = ss[0];
    const float shift = ss[1];

    // 3. the map of the slice; each thread reads back the quads it wrote
    uint8_t* out = bgr + 3LL * b * P;
    for (long long q = q0 + threadIdx.x; q < q1; q += kThreads) {
      const long long l = q - q0;
      float m[4];
      uint32_t hue;
      int n;
      if (l < p.cap) {
        const float4 c4 = cmag[l];
        m[0] = c4.x; m[1] = c4.y; m[2] = c4.z; m[3] = c4.w;
        hue = chue[l];
        n = static_cast<int>(min(4LL, P - 4 * q));
      } else {  // past the cache: read the frame again
        float x[4], y[4];
        float unused0 = INFINITY, unused1 = -INFINITY;
        n = load_quad(fx, fy, q, p, x, y);
        hue = quad_polar(x, y, n, m, unused0, unused1);
      }
      uint32_t plane[3] = {0, 0, 0};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t px = bgr_of(float_of((hue >> (8 * c)) & 0xffu), m[c],
                                   scale, shift);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) plane[ch] |= ((px >> (8 * ch)) & 0xffu) << (8 * c);
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        uint8_t* o = out + ch * P + 4 * q;
        if (p.vec) {
          __stcs(reinterpret_cast<unsigned int*>(o), plane[ch]);
        } else {
          for (int c = 0; c < n; ++c) o[c] = static_cast<uint8_t>(plane[ch] >> (8 * c));
        }
      }
    }
    __syncthreads();  // red and ss are reused by the next frame
  }
}

struct DeviceInfo {
  int sms = 0;
  int per_sm = 0;   // blocks of colorize_kernel an SM holds at kSmem
};

}  // namespace

// flow: (B, 2, H, W) f32; parts: (B, 2 x SMs) float2 scratch; counters:
// B zeroed uint32 scratch; bgr: (B, 3, H, W) uint8; plane = H * W.
// Returns a cudaError_t.
extern "C" int oft_colorize(const float* flow, float* parts,
                            unsigned int* counters, uint8_t* bgr, int B,
                            long long plane, int device, void* stream) {
  if (B < 1 || plane < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  static DeviceInfo info[64];
  DeviceInfo& di = info[device];
  if (di.sms == 0) {
    err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(colorize_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&di.per_sm, colorize_kernel,
                                                          kThreads, kSmem);
    if (err != cudaSuccess) {
      di.sms = 0;
      return static_cast<int>(err);
    }
  }
  // the plan (and kernels/colorize.py's scratch) holds two blocks an SM
  if (di.per_sm < 2) return static_cast<int>(cudaErrorLaunchOutOfResources);
  Plan p;
  p.plane = plane;
  p.quads = (plane + 3) / 4;
  p.NG = B >= 2 ? 2 : 1;
  p.G = di.sms * 2 / p.NG;
  p.slice = (p.quads + p.G - 1) / p.G;
  const long long fits = kSmem / kBytesPerQuad;
  p.cap = static_cast<int>(p.slice < fits ? p.slice : fits);
  p.vec = plane % 4 == 0 && reinterpret_cast<uintptr_t>(flow) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(bgr) % 4 == 0;
  const size_t smem = static_cast<size_t>(p.cap) * kBytesPerQuad;
  float2* pr = reinterpret_cast<float2*>(parts);
  void* args[] = {const_cast<float**>(&flow), &pr, &counters, &bgr, &B, &p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(colorize_kernel), dim3(di.sms * 2),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream)));
}
