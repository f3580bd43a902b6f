// K5b: window sum of the update matrices + 2x2 solve.
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/blur_solve.py
// (update_flow_blur_solve_pallas, and blur_solve_store for the store
// layout).  Input M = (G11, G12, G22, h1, h2) as K5a writes it, (B, 5, H, W)
// f32; output the new flow (B, 2, H, W) f32.  For each pixel:
//   1. horizontal pass: a = t[0] * M[x - m] + t[1] * M[x - m + 1] + ...,
//   2. vertical pass over those row sums, the same taps, the same order,
//   3. solve with (G, h) scaled by `scale`, det regularised by +1e-3.
// The Gaussian window passes its taps (models/farneback/core.py:
// gaussian_window_kernel) and scale 1; the box window adds the values
// themselves (1 * v == v: the plain additions of box_sum_replicate) and
// scales by 1 / winsize^2.  Borders are replicate: rows and columns of M
// are clamped where they are staged; there is no padded copy of M.
//
// What bounds it: the window sums, 20 m adds per pixel for the box (10 (4m
// + 1) operations for the Gaussian), 630 at winsize 63 against 28 B/px of
// device memory (M read, the flow written): operations, not bytes.  The
// design spends each operation once per pixel and keeps the loads of M
// and of the sums out of their way (the strip kernel, winsize <= 261):
//   - A block owns a strip of SW = 32 output columns and walks down
//     rows_per_block output rows (chosen by the wrapper from the waves of
//     blocks and the 2m-row halo each block sums above its rows).  It
//     stages M on G = 32 new rows at a time, over the strip plus the
//     m-column halo on each side, one channel at a time, in shared memory:
//     16-byte loads of whole groups of 4 columns from a 4-aligned start
//     (clamped scalar loads at the image's edges), the next channel's
//     loads in flight in registers while this one is summed.  Each row's
//     horizontal sums go to a ring of the last 2m + G rows, so every window
//     row is summed horizontally once per strip (the former 32 x 32 tile
//     summed (32 + 2m) / 32 rows per output row: 2.9x at m = 31).  Each
//     output row's vertical sum is taken from the ring once its m rows
//     below are in.
//   - Both sums are register-blocked as K1's (window_solve.cuh:window_sums,
//     shared with K1): a thread makes K = 4 adjacent sums, each still added
//     in tap order, reading each value (2m + K) / K times instead of 2m + 1.
//     Lanes take rows in the horizontal pass (odd M row stride) and
//     columns in the vertical one (ring stride SW + 1): no bank conflicts.
//     The taps sit in shared memory.
//   - Eight warps a block, three blocks an SM at winsize 63 (73 KB each,
//     80 registers a thread): staging one channel at a time keeps the
//     ring's 61 KB and a 12 KB buffer of M on chip for 24 warps an SM.
// The shared memory, 4 x (G ((SW + 2m + 3) | 1) + 5 (2m + G) (SW + 1) +
// 2m + 1) bytes, bounds the strip kernel to winsize <= 261
// (k5b_strip_fits in kernels/blur_solve.py); larger windows take the tile
// kernel below, which streams a 32 x 32 tile's window rows through a fixed
// buffer, so any winsize >= 1 runs.  Both give the same bits (the same
// chains, the same solve).  The arithmetic follows the plain version op for
// op (--fmad=false), and K5a -> K5b equals K1 to the bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "window_solve.cuh"

namespace {

// ---- the strip kernel ----

constexpr int SW = 32;          // output columns per block
constexpr int G = 32;           // M rows staged per pass: one per lane
constexpr int K = 4;            // adjacent sums per thread
constexpr int kWarps = 8;       // SW / K column groups; G / K row groups
constexpr int kThreads = 32 * kWarps;
constexpr int HS = SW + 1;      // ring row stride (floats)
constexpr int U = G / kWarps;   // staged rows a warp loads per channel

static_assert(SW == K * kWarps && G == K * kWarps && G == 32,
              "lane the row and warp the column group, then the reverse");

// 16-byte groups of M a staged row loads: the strip and its halo, from
// the 4-aligned column at or left of x0 - m.
__host__ __device__ constexpr int m_groups(int m) { return (SW + 2 * m + 6) / 4; }

// The staged rows' stride: odd, and at least the d + SW + 2m columns read.
__host__ __device__ constexpr int m_row_stride(int m) { return (SW + 2 * m + 3) | 1; }

__host__ __device__ constexpr int ring_rows(int m) { return 2 * m + G; }

__host__ __device__ constexpr size_t smem_floats(int m) {
  return G * m_row_stride(m) + 5 * ring_rows(m) * HS + 2 * m + 1;
}

// GAUSS: weighted sums with the window taps; else plain adds (the box).
// aligned: M and each of its rows start on a 16-byte boundary.
template <bool GAUSS>
__global__ void __launch_bounds__(kThreads, 3)
blur_solve_strip_kernel(const float* __restrict__ M,
                        const float* __restrict__ taps_g,
                        float* __restrict__ flow, int H, int W, int m,
                        float scale, int rows_per_block, int aligned) {
  extern __shared__ float smem[];
  const int MWp = m_row_stride(m);
  const int R = ring_rows(m);
  float* Mb = smem;                  // [G][MWp]     one channel of M, new rows + halo
  float* Hr = Mb + G * MWp;          // [5][R][HS]   ring of horizontal sums
  float* t = Hr + 5 * R * HS;        // [2m + 1]     window taps (GAUSS)
  const int x0 = blockIdx.x * SW;
  const int y0 = blockIdx.y * rows_per_block;
  const int y_end = min(y0 + rows_per_block, H);   // output rows [y0, y_end)
  const long long plane = static_cast<long long>(H) * W;
  const float* mb = M + blockIdx.z * 5 * plane;
  float* out = flow + blockIdx.z * 2 * plane;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // staged column c holds image column xs + c; x0 - m is column d
  const int d = ((x0 - m) % 4 + 4) % 4;
  const int xs = x0 - m - d;
  const int ngroups = m_groups(m);

  if (GAUSS)
    for (int i = tid; i <= 2 * m; i += kThreads) t[i] = taps_g[i];

  // Staging channel k of image rows [ya, ya + n) (clamped): warp w takes
  // rows w, w + kWarps, ..., lane the 16-byte group.  load() brings group
  // `lane` of the warp's U rows into registers, so that the loads of the
  // next channel fly while this one is summed; store() puts them in Mb and
  // stages any groups past the 32nd directly.
  float4 pf[U];
  auto fetch = [&](int k, int ya, int r, int gi) {
    const float* row =
        mb + k * plane + static_cast<long long>(oft::clampi(ya + r, 0, H - 1)) * W;
    const int x = xs + 4 * gi;
    if (aligned && x >= 0 && x + 4 <= W) return *reinterpret_cast<const float4*>(row + x);
    return make_float4(row[oft::clampi(x, 0, W - 1)], row[oft::clampi(x + 1, 0, W - 1)],
                       row[oft::clampi(x + 2, 0, W - 1)], row[oft::clampi(x + 3, 0, W - 1)]);
  };
  auto put = [&](int r, int gi, float4 v) {
    float* p = Mb + r * MWp + 4 * gi;
    const int c = MWp - 4 * gi;      // columns of the group inside the row
    p[0] = v.x;
    if (c > 1) p[1] = v.y;
    if (c > 2) p[2] = v.z;
    if (c > 3) p[3] = v.w;
  };
  auto load = [&](int k, int ya, int n) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = warp + kWarps * u;
      if (r < n && lane < ngroups) pf[u] = fetch(k, ya, r, lane);
    }
  };
  auto store = [&](int k, int ya, int n) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = warp + kWarps * u;
      if (r < n && lane < ngroups) put(r, lane, pf[u]);
    }
    for (int gi = lane + 32; gi < ngroups; gi += 32)
      for (int r = warp; r < n; r += kWarps) put(r, gi, fetch(k, ya, r, gi));
  };

  // The horizontal sums of rows [ya, ya + n), channel by channel, into the
  // ring (row y at slot (y - y0 + m) mod R; rows go in increasing order, so
  // the ring holds the last R rows).  pf holds channel 0 of these rows on
  // entry, and channel 0 of rows [next_ya, next_ya + next_n) on exit.
  auto horizontal = [&](int ya, int n, int next_ya, int next_n) {
    for (int k = 0; k < 5; ++k) {
      store(k, ya, n);
      __syncthreads();
      if (k < 4)
        load(k + 1, ya, n);
      else if (next_n > 0)
        load(0, next_ya, next_n);
      if (lane < n) {   // lane: the row; warp: K adjacent output columns
        const float* p = Mb + lane * MWp + d + K * warp;
        float a[1][K];
        oft::window_sums<GAUSS, K>([&](int q, float* v) { v[0] = p[q]; }, t, m, a);
        const int slot = (ya + lane - y0 + m) % R;
#pragma unroll
        for (int j = 0; j < K; ++j) Hr[(k * R + slot) * HS + K * warp + j] = a[0][j];
      }
      __syncthreads();
    }
  };

  // passes: the 2m rows above the first output row, G at a time, then
  // the rows m below each G output rows
  const int npre = (2 * m + G - 1) / G;
  const int npass = npre + (y_end - y0 + G - 1) / G;
  auto rows_of = [&](int i, int& ya, int& n) {
    if (i >= npass) {
      ya = n = 0;
    } else if (i < npre) {
      ya = y0 - m + i * G;
      n = min(G, y0 + m - ya);
    } else {
      const int yg = y0 + (i - npre) * G;
      ya = yg + m;
      n = min(G, y_end - yg);
    }
  };
  int ya, n;
  rows_of(0, ya, n);
  load(0, ya, n);
  for (int i = 0; i < npass; ++i) {
    int next_ya, next_n;
    rows_of(i + 1, next_ya, next_n);
    horizontal(ya, n, next_ya, next_n);
    ya = next_ya;
    n = next_n;
    if (i < npre) continue;
    // lane: the column; warp: K adjacent output rows from ybase
    const int yg = y0 + (i - npre) * G;
    const int x = x0 + lane;
    const int ybase = yg + K * warp;
    if (x >= W || ybase >= y_end) continue;
    int slot = (ybase - y0) % R;     // ring slot of row ybase - m
    float s[5][K];
    oft::window_sums<GAUSS, K>(
        [&](int, float* v) {
#pragma unroll
          for (int k = 0; k < 5; ++k) v[k] = Hr[(k * R + slot) * HS + lane];
          slot = slot + 1 == R ? 0 : slot + 1;
        },
        t, m, s);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int y = ybase + j;
      if (y >= y_end) break;
      const float sj[5] = {s[0][j], s[1][j], s[2][j], s[3][j], s[4][j]};
      oft::solve_store(sj, scale, out, static_cast<long long>(y) * W + x, plane);
    }
  }
}

template <bool GAUSS>
int launch_strip(const float* M, const float* taps, float* flow, int B, int H,
                 int W, int m, float scale, int rows_per_block, int aligned,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(m);
  cudaError_t err = cudaFuncSetAttribute(
      blur_solve_strip_kernel<GAUSS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + SW - 1) / SW, (H + rows_per_block - 1) / rows_per_block, B);
  blur_solve_strip_kernel<GAUSS><<<grid, kThreads, smem, stream>>>(
      M, taps, flow, H, W, m, scale, rows_per_block, aligned);
  return static_cast<int>(cudaGetLastError());
}

// ---- the tile kernel, for windows beyond the strip's shared memory ----
//
// A 32 x 32 output tile streams its (32 + 2m) window rows through shared
// memory CH rows at a time (horizontal sums by clamped loads of M, the taps
// from device memory), and each thread keeps its 4 output rows x 5
// channels of vertical sums in registers, so shared memory does not bound
// m.

constexpr int TX = 32;          // output columns per block (one per thread)
constexpr int TY = 32;          // output rows per block
constexpr int BY = 8;           // thread rows per block
constexpr int RPT = TY / BY;    // output rows per thread
constexpr int CH = 48;          // window rows staged per pass

__global__ void blur_solve_tile_kernel(const float* __restrict__ M,
                                       const float* __restrict__ taps,
                                       float* __restrict__ flow, int H, int W,
                                       int m, float scale) {
  __shared__ float Hs[5][CH][TX];  // horizontal sums of CH window rows
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const float* mb = M + blockIdx.z * 5 * plane;
  const int xc = x0 + threadIdx.x;
  const int rows = TY + 2 * m;     // window rows of the tile, from y0 - m
  float acc[RPT][5] = {};

  for (int c0 = 0; c0 < rows; c0 += CH) {
    const int cend = min(c0 + CH, rows);
    for (int j = threadIdx.y; c0 + j < cend; j += BY) {
      const float* row =
          mb + static_cast<long long>(oft::clampi(y0 - m + c0 + j, 0, H - 1)) * W;
      // the five channels' sums advance together: one clamp and one tap
      // per column, five independent add chains, each in tap order
      float a[5];
      const int xl = oft::clampi(xc - m, 0, W - 1);
#pragma unroll
      for (int k = 0; k < 5; ++k) a[k] = taps[0] * row[k * plane + xl];
      for (int i = 1; i <= 2 * m; ++i) {
        const int xi = oft::clampi(xc - m + i, 0, W - 1);
        const float t = taps[i];
#pragma unroll
        for (int k = 0; k < 5; ++k) a[k] = a[k] + t * row[k * plane + xi];
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) Hs[k][j][threadIdx.x] = a[k];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      // output row ly sums window rows ly .. ly + 2m of the tile
      const int ly = threadIdx.y + q * BY;
      const int hi = min(ly + 2 * m, cend - 1);
      for (int c = max(ly, c0); c <= hi; ++c) {
        const int i = c - ly;
        const float t = taps[i];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const float term = t * Hs[k][c - c0][threadIdx.x];
          acc[q][k] = i == 0 ? term : acc[q][k] + term;
        }
      }
    }
    __syncthreads();
  }

  if (xc >= W) return;
  float* out = flow + blockIdx.z * 2 * plane;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int y = y0 + threadIdx.y + q * BY;
    if (y >= H) break;
    oft::solve_store(acc[q], scale, out, static_cast<long long>(y) * W + xc, plane);
  }
}

}  // namespace

// The strip kernel.  M: (B, 5, H, W) f32; taps: the 2m + 1 Gaussian window
// taps on the device (scale 1), or null for the box window (scale
// 1 / winsize^2); flow: (B, 2, H, W) f32.  rows_per_block: output rows
// each block walks, a positive multiple of 32.  aligned != 0: M and each
// of its rows start on a 16-byte boundary.  Returns a cudaError_t
// (cudaErrorInvalidValue where the window outgrows the shared memory).
extern "C" int oft_blur_solve(const float* M, const float* taps, float* flow,
                              int B, int H, int W, int m, float scale,
                              int rows_per_block, int aligned, int device,
                              void* stream) {
  if (m < 0 || rows_per_block < G || rows_per_block % G != 0 ||
      sizeof(float) * smem_floats(m) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taps != nullptr)
    return launch_strip<true>(M, taps, flow, B, H, W, m, scale, rows_per_block,
                              aligned, s);
  return launch_strip<false>(M, taps, flow, B, H, W, m, scale, rows_per_block,
                             aligned, s);
}

// The tile kernel, any m >= 0.  taps: the 2m + 1 taps on the device (ones
// for the box).  Returns a cudaError_t.
extern "C" int oft_blur_solve_tile(const float* M, const float* taps, float* flow,
                                   int B, int H, int W, int m, float scale,
                                   int device, void* stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, BY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  blur_solve_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      M, taps, flow, H, W, m, scale);
  return static_cast<int>(cudaGetLastError());
}
