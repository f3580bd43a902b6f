// K1: one fused Farnebäck iterate step (update matrices -> window sum ->
// solve), with the box or the Gaussian window.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/update_gather.py
// (fused_update_blur_store, driven by pallas/fused_iterate.py
// update_flow_fused).  For each pixel:
//   1. M = (G11, G12, G22, h1, h2) from the displaced fetch of R1
//      (update_matrices.cuh, shared with K5a and K7);
//   2. sum M over the winsize x winsize window with replicate borders:
//      the box (plain adds, then a 1 / winsize^2 scale) or the Gaussian
//      window (taps t: a = t[0] * M[x - m] + t[1] * M[x - m + 1] + ...,
//      horizontally, then vertically, scale 1), in K5b's order, so that
//      K1 equals K5a -> K5b (and K7 equals K2 -> K1) to the bit;
//   3. solve the 2x2 system, det regularised by +1e-3 (window_solve.cuh).
//
// What bounds it: per output pixel it reads 7 f32 (R0 and the flow) plus a
// 5-f32 gather of R1, and writes 2 f32, 56 B/px in all, if M stays on
// chip.  The design keeps M on chip and builds it about once per pixel:
//   - A block owns a strip of SW = 32 output columns and walks down
//     rows_per_block output rows (32 to 256, chosen by the wrapper so that
//     the grid fills the card).  It builds M on G = 32 new rows at a time,
//     over the strip plus the m-column halo on each side, into shared
//     memory (a warp per row); the rows above and below the strip's
//     output rows are built once per block, so the halo costs
//     (SW + 2m) / SW x (rows + 2m) / rows evaluations per output pixel,
//     1.5 at winsize 15 with 256-row blocks (the former 32 x 32 tile:
//     2.07).  Each thread keeps the loads of U = 3 pixels in flight (the
//     flow, then R0 and the gathered R1): building M is the larger part
//     of the kernel's time (below).
//   - The horizontal sums of each new row go to a ring of the last 2m + G
//     rows; each output row's vertical sum is taken from the ring once its
//     m rows below are in.
//   - Both window sums are register-blocked: a thread keeps a sliding run
//     of the values it reads and produces K = 4 adjacent sums (along the
//     row horizontally, down the column vertically), so each value is read
//     from shared memory (2m + K) / K times instead of 2m + 1 times.  Each
//     sum still adds its taps left to right, in K5b's order; a running box
//     sum would round differently.  Lanes take rows in the horizontal pass
//     (the M rows' stride is odd) and columns in the vertical pass (the
//     ring's row stride is SW + 1), so neither pass has bank conflicts.
// Two instantiations share this source and its arithmetic.  The run-time
// one reads m as an argument: its tap loops cannot unroll, so each step
// shifts the taps through registers, loads one from shared memory, steps
// its addresses and tests the loop, and the build divides by the run-time
// strip width and weighs every pixel for the border.  The fixed one,
// M = kFixedM = 7 (winsize 15, the reference's and every benchmark
// cell's; the wrapper picks it), unrolls both sums whole: the taps are
// kernel parameters (operands of their multiplies), every shared-memory
// offset an immediate, the ring's wrap one select a step; the build's
// strides and the split of its pixel index are constants, and only the
// frame's 5-px border rows and columns are weighed (elsewhere the weight
// is 1.0f, so the bits do not change).  Measured at the 1080p B = 16
// levels, one step, on a panning flow (PERF.md, K1): the run-time kernel
// takes 1.55 ms (box) and 1.81 ms (Gaussian), the build alone (the sums
// cut to a load) 1.32 and 1.33, the sums and solve alone (M filled with
// no loads) 0.70 and 1.03.  So the build's loads bound K1, and the sums
// add the time their instructions do not hide under it; the fixed kernel cuts
// the sums alone by 25 % (box) and 27 % (Gaussian), the build alone by
// 7 %, and the whole step by 12 % and 16 %.
// The shared memory, 4 x (5 G (SW + 2m + 1) + 5 (2m + G)(SW + 1) + 2m + 1)
// bytes (60.5 KB at winsize 15, three blocks of 256 threads an SM), bounds
// winsize; the route keeps K1 to winsize <= 61 (k1_fits in
// kernels/update_gather.py).  The displaced fetch is the card's clamped
// gather, exact by construction.  The grid covers any width (8K frames
// included, the TPU's column-chunked K8); plane offsets are int64.
//
// Border: rows and columns of M outside the image hold M *at the clamped
// pixel*, that pixel's border weight included (replicate border of the
// window sum).  The input and output flow must be distinct buffers: a step
// reads its neighbours' flow.  The arithmetic follows the plain version op
// for op (--fmad=false).

#include <cuda_runtime.h>

#include "update_matrices.cuh"
#include "window_solve.cuh"

namespace {

constexpr int SW = 32;        // output columns per block: one per lane
constexpr int G = 32;         // M rows built per pass: one per lane
constexpr int K = 4;          // adjacent sums per thread
constexpr int kWarps = 8;     // SW / K column groups, G / K row groups
constexpr int kThreads = 32 * kWarps;
constexpr int HS = SW + 1;    // ring row stride (floats)
constexpr int U = 3;          // M evaluations a thread keeps in flight
constexpr int kFixedM = 7;    // the window built in: winsize 15 (and 14)

static_assert(SW == K * kWarps && G == K * kWarps, "one sum group per warp");

// The fixed window's Gaussian taps, passed by value: a kernel parameter,
// so each tap is an operand of its multiply, with no load and no register.
struct FixedTaps {
  float v[2 * kFixedM + 1];
  __device__ float operator[](int i) const { return v[i]; }
};

__host__ __device__ constexpr int m_row_stride(int m) { return SW + 2 * m + 1; }

__host__ __device__ constexpr int ring_rows(int m) { return 2 * m + G; }

__host__ __device__ constexpr size_t smem_floats(int m) {
  return 5 * G * m_row_stride(m) + 5 * ring_rows(m) * HS + 2 * m + 1;
}

// GAUSS: weighted sums with the window taps; else plain adds (the box).
// M: the window's half-width fixed at compile time (kFixedM), its taps
// taken from taps_k; 0: read from m_arg at run time, the taps from taps_g.
template <bool GAUSS, int M>
__global__ void __launch_bounds__(kThreads, 3)
update_blur_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                   const float* __restrict__ flow_in,
                   float* __restrict__ flow_out, int H, int W, int m_arg,
                   const float* __restrict__ taps_g, FixedTaps taps_k,
                   float scale, int rows_per_block) {
  static_assert(M == 0 || M == kFixedM, "one fixed window");
  const int m = M > 0 ? M : m_arg;
  extern __shared__ float smem[];
  const int MWp = m_row_stride(m);
  const int R = ring_rows(m);
  float* Mb = smem;                  // [5][G][MWp]  M on new rows + halo
  float* Hr = Mb + 5 * G * MWp;      // [5][R][HS]   ring of horizontal sums
  float* t = Hr + 5 * R * HS;        // [2m + 1]     window taps (GAUSS)
  const int x0 = blockIdx.x * SW;
  const int y0 = blockIdx.y * rows_per_block;
  const int y_end = min(y0 + rows_per_block, H);   // output rows [y0, y_end)
  const long long plane = static_cast<long long>(H) * W;
  const float* r0 = R0 + blockIdx.z * 5 * plane;
  const float* r1 = R1 + blockIdx.z * 5 * plane;
  const float* fl = flow_in + blockIdx.z * 2 * plane;
  float* out = flow_out + blockIdx.z * 2 * plane;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (GAUSS && M == 0)
    for (int i = tid; i <= 2 * m; i += kThreads) t[i] = taps_g[i];

  // M on image rows [ya, ya + n), n <= G, then their horizontal sums into
  // the ring (row y at slot (y - y0 + m) mod R).  Rows go in increasing
  // order, so the ring holds the last R rows built.
  auto build_rows = [&](int ya, int n) {
    const int mw = SW + 2 * m;
    const int total = n * mw;
    // U pixels a thread at a time, their loads issued together (the flow,
    // then R0 and the gathered R1), so that their latencies overlap; past
    // the end a thread repeats the last pixel, storing the same values
    for (int e0 = tid; e0 < total; e0 += U * kThreads) {
      int at[U], y[U], x[U];
      long long p[U];
      float dx[U], dy[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = min(e0 + u * kThreads, total - 1);
        const int r = e / mw;
        const int c = e - r * mw;
        at[u] = r * MWp + c;
        y[u] = oft::clampi(ya + r, 0, H - 1);
        x[u] = oft::clampi(x0 - m + c, 0, W - 1);
        p[u] = static_cast<long long>(y[u]) * W + x[u];
        dx[u] = fl[p[u]];
        dy[u] = fl[plane + p[u]];
      }
      float a[U][5], d[U][5];
      bool inside[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        int yi, xi;
        inside[u] = oft::fetch_target(y[u], x[u], dx[u], dy[u], H, W, yi, xi);
        const long long q = static_cast<long long>(yi) * W + xi;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          a[u][k] = r0[k * plane + p[u]];
          d[u][k] = r1[k * plane + q];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float mv[5];
        oft::assemble<(M > 0)>(a[u], d[u], dx[u], dy[u], inside[u], y[u], x[u],
                               H, W, mv);
#pragma unroll
        for (int k = 0; k < 5; ++k) Mb[k * G * MWp + at[u]] = mv[k];
      }
    }
    __syncthreads();
    if (lane < n) {   // lane: the row; warp: K adjacent output columns
      const float* p = Mb + lane * MWp + K * warp;
      const auto load = [&](int q, float* v) {
#pragma unroll
        for (int k = 0; k < 5; ++k) v[k] = p[k * G * MWp + q];
      };
      float a[5][K];
      if constexpr (M > 0)
        oft::window_sums<GAUSS, K, 2 * M + 1>(load, taps_k, m, a);
      else
        oft::window_sums<GAUSS, K>(load, t, m, a);
      const int slot = (ya + lane - y0 + m) % R;
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int j = 0; j < K; ++j) Hr[(k * R + slot) * HS + K * warp + j] = a[k][j];
    }
    __syncthreads();
  };

  for (int ya = y0 - m; ya < y0 + m; ya += G) build_rows(ya, min(G, y0 + m - ya));
  for (int yg = y0; yg < y_end; yg += G) {
    build_rows(yg + m, min(G, y_end - yg));
    // lane: the column; warp: K adjacent output rows from ybase
    const int x = x0 + lane;
    const int ybase = yg + K * warp;
    if (x >= W || ybase >= y_end) continue;
    int slot = (ybase - y0) % R;     // ring slot of row ybase - m
    float s[5][K];
    if constexpr (M > 0) {
      // value q is at slot + q, or past the ring's end at slot + q - R: the
      // wrap point is worked out once, and each load's base is picked by
      // its constant q against it (a branch to a copy without the pick,
      // for the passes that do not wrap, measured no faster)
      const float* h0 = Hr + slot * HS + lane;
      const float* h1 = h0 - R * HS;
      const int wrap = R - slot;
      oft::window_sums<GAUSS, K, 2 * M + 1>(
          [&](int q, float* v) {
            const float* h = (q < wrap ? h0 : h1) + q * HS;
#pragma unroll
            for (int k = 0; k < 5; ++k) v[k] = h[k * R * HS];
          },
          taps_k, m, s);
    } else {
      oft::window_sums<GAUSS, K>(
          [&](int, float* v) {
#pragma unroll
            for (int k = 0; k < 5; ++k) v[k] = Hr[(k * R + slot) * HS + lane];
            slot = slot + 1 == R ? 0 : slot + 1;
          },
          t, m, s);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int y = ybase + j;
      if (y >= y_end) break;
      const float sj[5] = {s[0][j], s[1][j], s[2][j], s[3][j], s[4][j]};
      oft::solve_store(sj, scale, out, static_cast<long long>(y) * W + x, plane);
    }
  }
}

// The instantiation for the box or Gaussian window, with the half-width
// fixed (kFixedM) or read at run time.
using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                        int, int, const float*, FixedTaps, float, int);

Kernel kernel_for(bool gauss, bool fixed) {
  if (fixed)
    return gauss ? update_blur_kernel<true, kFixedM> : update_blur_kernel<false, kFixedM>;
  return gauss ? update_blur_kernel<true, 0> : update_blur_kernel<false, 0>;
}

}  // namespace

// R0, R1: (B, 5, H, W) f32; flow_in, flow_out: distinct (B, 2, H, W) f32.
// m = winsize / 2.  taps: the 2m + 1 Gaussian window taps on the device
// (scale 1), or null for the box window (scale 1 / winsize^2).
// rows_per_block: output rows each block walks, a positive multiple of
// 32.  fixed: launch the instantiation with m built in, which takes only
// m == 7 and, with the Gaussian window, the same taps in host memory
// (host_taps; else null).  Returns a cudaError_t.
extern "C" int oft_update_blur(const float* R0, const float* R1,
                               const float* flow_in, float* flow_out, int B,
                               int H, int W, int m, const float* taps,
                               const float* host_taps, float scale,
                               int rows_per_block, int fixed, int device,
                               void* stream) {
  if (m < 0 || rows_per_block < G || rows_per_block % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fixed && (m != kFixedM || (taps != nullptr && host_taps == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  FixedTaps taps_k{};
  if (fixed && taps != nullptr)
    for (int i = 0; i <= 2 * kFixedM; ++i) taps_k.v[i] = host_taps[i];
  const Kernel kernel = kernel_for(taps != nullptr, fixed != 0);
  const size_t smem = sizeof(float) * smem_floats(m);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + SW - 1) / SW, (H + rows_per_block - 1) / rows_per_block, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      R0, R1, flow_in, flow_out, H, W, m, taps, taps_k, scale, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel resident on one SM at window half-width m, into
// *blocks, and its dynamic shared memory per block, into *smem, for the
// box or Gaussian instantiation, the fixed one (m == 7 only) or the
// run-time one.  Returns a cudaError_t.
extern "C" int oft_update_blur_occupancy(int m, int gauss, int fixed,
                                         int device, int* blocks, int* smem) {
  if (m < 0 || (fixed && m != kFixedM))
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = static_cast<int>(sizeof(float) * smem_floats(m));
  const Kernel kernel = kernel_for(gauss != 0, fixed != 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, *smem));
}
