// K1: one fused Farnebäck iterate step (update matrices -> box sum -> solve).
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/update_gather.py
// (fused_update_blur_store, driven by pallas/fused_iterate.py
// update_flow_fused).  For each pixel:
//   1. fetch R1 at (clamp(rint(y + dy)), clamp(rint(x + dx))); when the
//      rounded target leaves the image only R0 terms are used;
//   2. assemble M = (G11, G12, G22, h1, h2), scaled by the 5-px border
//      weights;
//   3. sum M over the winsize x winsize window with replicate borders;
//   4. solve the 2x2 system, det regularised by +1e-3, for the new flow.
//
// What bounds it: per output pixel it reads 7 f32 (R0 and the flow) plus a
// 5-f32 gather of R1, and writes 2 f32, 56 B/px in all, if M stayed on
// chip; the unfused version would add 2 x 20 B/px of M round trips per
// step.  So M for a 32x32 output tile plus its (winsize - 1) halo is
// built in shared memory (5 x 46 x 46 f32 at winsize 15), then summed
// horizontally, then vertically, and solved.  The halo costs (46/32)^2 =
// 2.1 M evaluations per output pixel; the card's hardware gather makes the
// displaced fetch a plain clamped load, exact by construction.
//
// Border: halo entries outside the image hold M *at the clamped pixel*,
// that pixel's border weight included (replicate border of the box sum).
// Rounding is rintf (half to even, as cvRound); the inside test is taken
// on the rounded coordinates before clamping.  The input and output flow
// must be distinct buffers: a step reads its neighbours' flow.  The
// arithmetic follows the plain version op for op (--fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // output columns per block (one per thread)
constexpr int TY = 32;  // output rows per block
constexpr int BY = 8;   // thread rows per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// OpenCV's UpdateMatrices border factor along one axis, multiplied in the
// order of border_scale_field (per k: the leading edge, then the trailing).
__device__ __forceinline__ float border_weight(int i, int n) {
  const float bw[5] = {0.14f, 0.14f, 0.4472f, 0.4472f, 0.4472f};
  float w = 1.0f;
  const int lim = n < 5 ? n : 5;
  for (int k = 0; k < lim; ++k) {
    if (i == k) w *= bw[k];
    if (i == n - 1 - k) w *= bw[k];
  }
  return w;
}

__device__ __forceinline__ void matrices_at(const float* __restrict__ r0,
                                            const float* __restrict__ r1,
                                            const float* __restrict__ fl,
                                            int y, int x, int H, int W,
                                            long long plane, float* m) {
  const long long p = static_cast<long long>(y) * W + x;
  const float dx = fl[p];
  const float dy = fl[plane + p];
  const float fx = rintf(static_cast<float>(x) + dx);
  const float fy = rintf(static_cast<float>(y) + dy);
  const bool inside = fx >= 0.0f && fx <= static_cast<float>(W - 1) &&
                      fy >= 0.0f && fy <= static_cast<float>(H - 1);
  const int xi = static_cast<int>(fminf(fmaxf(fx, 0.0f), static_cast<float>(W - 1)));
  const int yi = static_cast<int>(fminf(fmaxf(fy, 0.0f), static_cast<float>(H - 1)));
  const long long q = static_cast<long long>(yi) * W + xi;
  const float a0 = r0[p], a1 = r0[plane + p], a2 = r0[2 * plane + p];
  const float a3 = r0[3 * plane + p], a4 = r0[4 * plane + p];
  const float d0 = r1[q], d1 = r1[plane + q], d2 = r1[2 * plane + q];
  const float d3 = r1[3 * plane + q], d4 = r1[4 * plane + q];
  float r2 = inside ? d0 : 0.0f;
  float r3 = inside ? d1 : 0.0f;
  float r4 = inside ? (a2 + d2) * 0.5f : a2;
  float r5 = inside ? (a3 + d3) * 0.5f : a3;
  float r6 = inside ? (a4 + d4) * 0.25f : a4 * 0.5f;
  r2 = (a0 - r2) * 0.5f + (r4 * dy + r6 * dx);
  r3 = (a1 - r3) * 0.5f + (r6 * dy + r5 * dx);
  const float sc = border_weight(y, H) * border_weight(x, W);
  r2 = r2 * sc;
  r3 = r3 * sc;
  r4 = r4 * sc;
  r5 = r5 * sc;
  r6 = r6 * sc;
  m[0] = r4 * r4 + r6 * r6;  // G11
  m[1] = (r4 + r5) * r6;     // G12
  m[2] = r5 * r5 + r6 * r6;  // G22
  m[3] = r4 * r2 + r6 * r3;  // h1
  m[4] = r6 * r2 + r5 * r3;  // h2
}

__global__ void update_blur_kernel(const float* __restrict__ R0,
                                   const float* __restrict__ R1,
                                   const float* __restrict__ flow_in,
                                   float* __restrict__ flow_out, int H, int W,
                                   int m, float inv_area) {
  extern __shared__ float smem[];
  const int MW = TX + 2 * m;
  const int MH = TY + 2 * m;
  float* Ms = smem;                 // [5][MH][MW]  M on the tile + halo
  float* Hs = smem + 5 * MH * MW;   // [5][MH][TX]  horizontal window sums
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const float* r0 = R0 + blockIdx.z * 5 * plane;
  const float* r1 = R1 + blockIdx.z * 5 * plane;
  const float* fl = flow_in + blockIdx.z * 2 * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int e = tid; e < MH * MW; e += TX * BY) {
    const int ly = e / MW;
    const int lx = e - ly * MW;
    const int y = clampi(y0 - m + ly, 0, H - 1);
    const int x = clampi(x0 - m + lx, 0, W - 1);
    float mv[5];
    matrices_at(r0, r1, fl, y, x, H, W, plane, mv);
    for (int k = 0; k < 5; ++k) Ms[(k * MH + ly) * MW + lx] = mv[k];
  }
  __syncthreads();

  for (int e = tid; e < 5 * MH * TX; e += TX * BY) {
    const int row = e / TX;  // k * MH + ly
    const int lx = e - row * TX;
    const float* p = Ms + row * MW + lx;
    float acc = p[0];
    for (int i = 1; i <= 2 * m; ++i) acc = acc + p[i];
    Hs[row * TX + lx] = acc;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  float* out = flow_out + blockIdx.z * 2 * plane;
  for (int ly = threadIdx.y; ly < TY; ly += BY) {
    const int y = y0 + ly;
    if (y >= H) break;
    float s[5];
    for (int k = 0; k < 5; ++k) {
      const float* p = Hs + (k * MH + ly) * TX + threadIdx.x;
      float acc = p[0];
      for (int i = 1; i <= 2 * m; ++i) acc = acc + p[i * TX];
      s[k] = acc;
    }
    const float g11 = s[0] * inv_area;
    const float g12 = s[1] * inv_area;
    const float g22 = s[2] * inv_area;
    const float h1 = s[3] * inv_area;
    const float h2 = s[4] * inv_area;
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const long long p = static_cast<long long>(y) * W + x;
    out[p] = (g11 * h2 - g12 * h1) * idet;          // dx
    out[plane + p] = (g22 * h1 - g12 * h2) * idet;  // dy
  }
}

}  // namespace

// R0, R1: (B, 5, H, W) f32; flow_in, flow_out: distinct (B, 2, H, W) f32.
// m = winsize / 2; inv_area = 1 / winsize^2.  Returns a cudaError_t.
extern "C" int oft_update_blur(const float* R0, const float* R1,
                               const float* flow_in, float* flow_out, int B,
                               int H, int W, int m, float inv_area,
                               int device, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * 5 *
                      ((TY + 2 * m) * (TX + 2 * m) + (TY + 2 * m) * TX);
  err = cudaFuncSetAttribute(update_blur_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  update_blur_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      R0, R1, flow_in, flow_out, H, W, m, inv_area);
  return static_cast<int>(cudaGetLastError());
}
