// K5a: the Farnebäck update matrices alone (displaced fetch + M).
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/update_gather.py
// update_matrices_pallas_batched_stats (and its _build_chunked variant for
// frames wider than the TPU's window, and update_matrices_store for the
// store layout).  One thread per pixel computes M = (G11, G12, G22, h1, h2)
// by the arithmetic K1 uses (update_matrices.cuh) and writes it to a
// (B, 5, H, W) f32 array, which K5b (blur_solve.cu) then sums and solves.
//
// What bounds it: device-memory traffic, 48 B/px read (R0, the flow and a
// 5-f32 gather of R1) and 20 B/px written.  Nothing is recomputed; the
// TPU kernel's candidate blocks, anchors, spill tiers and column chunks
// exist because the TPU has no fast gather, and the card's clamped load is
// exact at any width, so none of that is ported.

#include <cuda_runtime.h>

#include "update_matrices.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__global__ void update_matrices_kernel(const float* __restrict__ R0,
                                       const float* __restrict__ R1,
                                       const float* __restrict__ flow,
                                       float* __restrict__ M, int H, int W) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long plane = static_cast<long long>(H) * W;
  const long long b = blockIdx.z;
  float mv[5];
  oft::matrices_at(R0 + b * 5 * plane, R1 + b * 5 * plane, flow + b * 2 * plane,
                   y, x, H, W, plane, mv);
  float* out = M + b * 5 * plane + static_cast<long long>(y) * W + x;
  for (int k = 0; k < 5; ++k) out[k * plane] = mv[k];
}

}  // namespace

// R0, R1: (B, 5, H, W) f32; flow: (B, 2, H, W) f32; M: (B, 5, H, W) f32.
// Returns a cudaError_t.
extern "C" int oft_update_matrices(const float* R0, const float* R1,
                                   const float* flow, float* M, int B, int H,
                                   int W, int device, void* stream) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  update_matrices_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      R0, R1, flow, M, H, W);
  return static_cast<int>(cudaGetLastError());
}
