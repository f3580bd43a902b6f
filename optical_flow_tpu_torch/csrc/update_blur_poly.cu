// K7: one Farnebäck iterate step from the level images, with the
// polynomial expansion derived inside the step, so that R never exists in
// device memory.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/update_gather.py
// (fused_update_blur_store_poly, driven by pallas/fused_iterate.py
// update_flow_fused_poly): K1 (update_blur.cu) with R0 and R1 expanded
// from img0 and img1 (uint8 with the 3-tap pre-smooth at level 0, f32 at
// the levels k > 0).  A block of TX x 8 threads takes a TX x 32 output
// tile: TX 64 by default where its plan fits (winsize <= 37 at poly_n 5),
// else 32.  M is needed on the tile plus the window's m-pixel halo; its
// in-image part is the block's unique rows ylo..yhi and columns
// xlo..xhi, and an M entry outside the image is M at the clamped pixel
// (the window's replicate border).  Per block:
//   1. stage img0 (pre-smoothed) over the unique rows and columns plus
//      the expansion's n-pixel halo, clamped into the image (the raw
//      band loaded once, many loads a thread in flight, the pre-smooth
//      in shared memory); read the flow of the unique pixels and reduce
//      the fetch targets of those whose rounded target is inside the
//      image (the others use no R1) to their bounding box;
//   2. R0 separably: the three vertical correlations of each unique row
//      at every staged column (polyexp.cuh:vertical_run, four rows a
//      thread), then the six horizontal ones, four columns a thread
//      (horizontal_run), combined into R0 on M's place in shared memory;
//      in bands of rows where the vertical sums of all rows do not fit;
//   3. R1 over a fetch box: the box is cut to what the region holds
//      (fit_box: the whole bounding box when it fits, else a box around
//      the tile centre's target), img1 staged over it plus the n halo,
//      and its vertical correlations taken once;
//   4. M per unique pixel whose target lies in the box, or that needs no
//      R1 (update_matrices.cuh, shared with K1 and K5a), overwriting R0
//      in place, R1 from the 2n + 1 vertical sums at the target (the
//      horizontal correlations and the combine); the targets left bound
//      the next box, and 3-4 repeat, up to three boxes; a pass without a
//      box takes R1 of every target left from img1 in device memory, its
//      own (2n+1)^2 window (polyexp.cuh:expand_at): two exact paths;
//      then the out-of-image entries copied from their clamped pixels;
//   5. the window sum and solve of K1 (window_solve.cuh).
// The expansion is polyexp.cuh's, shared with K2: each output's chains in
// tap order, the staged value at the clamped pixel past the border (K2's
// replicate border of the smoothed image), so K7 equals K2 -> K1 to the
// bit (--fmad=false).  The displaced fetch is exact for any displacement,
// so the TPU kernel's bands, anchors, raw windows and spill tiers (and
// its replay of spilled frames through the unfused path) have no
// counterpart.
//
// What bounds it: the least work is arithmetic, K2's on both images plus
// K1's, 649 operations a pixel at level 0 (chip_smoke.py:work_step_poly),
// against 10 B/px of images and flow at level 0.  The block expands img0
// over its (32 + 2m) x (TX + 2m) M pixels (1.75 per output at winsize 15
// and TX 64; 2.07 at TX 32) and img1's vertical sums over the fetch box,
// and takes a horizontal correlation per M pixel: about 1,300 operations
// per output.  The former kernel derived R0 and R1 per M pixel from their
// (2n+1)^2 windows, about 8,800.  What holds it above that is, as far as
// measured, latency: one block of 16 warps an SM at TX 64 (two of 8 at
// TX 32), its steps between barriers, each starting on loads (PERF.md).
//
// Shared memory (floats; kernels/update_gather.py:_k7_plan mirrors
// `plan`): M [5][32 + 2m][TX + 2m], the window taps, then one region X
// used in turn by the staged img0 and its vertical sums, the staged img1
// and its vertical sums, and the window's row sums; X's last floats hold
// a bit per M pixel done and the bounds a pass leaves.  A launch takes the
// two-blocks-an-SM share where R0's sums fit it in one band, else the
// whole 227 KB; what X holds beyond R0's needs caps the fetch box.
// Where X cannot hold one row of R0's vertical sums (windows of far more
// than cv2's poly_n), R0 is derived per pixel from the staged img0, as
// before.  The grid covers any width; plane offsets are int64.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "polyexp.cuh"
#include "update_matrices.cuh"
#include "window_solve.cuh"

namespace {

using oft::PolyConsts;

constexpr int TY = 32;                        // output rows per block
constexpr int BY = 8;                         // thread rows per block
constexpr int kDefaultTile = 64;              // output columns per block
constexpr int kSmemPerSM = 228 * 1024;
constexpr int kTwoBlocks = kSmemPerSM / 2 - 1024;   // 1 KB reserved a block
constexpr int kMaxSmem = 227 * 1024;
constexpr int kTail = 8;        // ints at X's end: a pass's leftover bounds
constexpr int kPasses = 4;      // fetch-box passes of a block, at most 3 boxes
constexpr int kMinBoxed = 64;   // targets left that are worth another box

__host__ __device__ __forceinline__ int min_i(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int max_i(int a, int b) { return a > b ? a : b; }

// The launch's shared memory in bytes and the floats of region X, for TX
// output columns, window radius m and expansion radius n; false where
// even the fallback's needs do not fit a block.
struct Plan {
  int bytes;
  int xc;
};

__host__ __device__ inline bool plan(int tx, int m, int n, Plan* p) {
  const long long mh = TY + 2 * m, mw = tx + 2 * m;
  const long long ms = 5 * mh * mw + 2 * m + 1;            // M and the taps
  const long long u0 = (mh + 2 * n) * (mw + 2 * n);         // staged img0
  const long long hs = 5 * mh * tx;                         // row sums
  const long long full = u0 + 3 * (mw + 2 * n + 3) * mh;    // R0 in one band
  if (4 * (ms + (u0 > hs ? u0 : hs)) > kMaxSmem) return false;
  const long long want = 4 * (ms + (full > hs ? full : hs));
  p->bytes = want <= kTwoBlocks ? kTwoBlocks : kMaxSmem;
  p->xc = static_cast<int>(p->bytes / 4 - ms);
  return true;
}

// Floats of the staged img1 and its vertical sums over a bh x bw box.
__host__ __device__ __forceinline__ int r1_floats(int bh, int bw, int n) {
  return (bw + 2 * n) * (4 * bh + 2 * n);
}

// The fetch box [y0, y0 + h) x [x0, x0 + w): the bounding box
// [lo_y, hi_y] x [lo_x, hi_x] of the targets where r1_floats fits xc;
// else the largest square that fits, grown along the axis it still cuts
// while the other keeps its side, placed around the anchor (ay, ax) and
// inside the bounding box.  h = 0: no box.
struct Box {
  int y0, x0, h, w;
};

__host__ __device__ inline Box fit_box(int lo_y, int hi_y, int lo_x, int hi_x,
                                       int ay, int ax, int xc, int n) {
  Box b = {0, 0, 0, 0};
  if (hi_y < lo_y || hi_x < lo_x) return b;   // no target inside the image
  const int eh = hi_y - lo_y + 1, ew = hi_x - lo_x + 1;
  int bh = eh, bw = ew;
  if (r1_floats(bh, bw, n) > xc) {
    int s = 0;
    while (r1_floats(s + 1, s + 1, n) <= xc) ++s;
    bh = min_i(eh, s);
    bw = min_i(ew, s);
    if (bh < eh) {
      const int t = xc / (bw + 2 * n) - 2 * n;
      bh = t > 0 ? min_i(eh, t / 4) : 0;
    } else if (bw < ew) {
      const int t = xc / (4 * bh + 2 * n) - 2 * n;
      bw = t > 0 ? min_i(ew, t) : 0;
    }
  }
  if (bh <= 0 || bw <= 0) return b;
  b.h = bh;
  b.w = bw;
  b.y0 = bh == eh ? lo_y : min_i(max_i(ay - bh / 2, lo_y), hi_y - bh + 1);
  b.x0 = bw == ew ? lo_x : min_i(max_i(ax - bw / 2, lo_x), hi_x - bw + 1);
  return b;
}

// The items (r, q) of a rows x cols grid that thread `start` takes,
// `step` apart in row-major order, stepped without a division.
struct Walk {
  int r, q, dr, dq, cols;
  __device__ __forceinline__ Walk(int start, int step, int cols_) : cols(cols_) {
    r = start / cols;
    q = start - r * cols;
    dr = step / cols;
    dq = step - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    q += dq;
    if (q >= cols) {
      q -= cols;
      ++r;
    }
  }
};

// B[j * bcols + k] = img[row(j)][col(k)] for a brows x bcols band, kLoads
// loads a thread in flight (a 1080p block's band in one round trip).
constexpr int kLoads = 16;

template <typename T, typename S, typename Row, typename Col>
__device__ __forceinline__ void load_band(const T* __restrict__ img, int W, int brows,
                                          int bcols, Row row, Col col, S* B, int tid,
                                          int nth) {
  const int total = brows * bcols;
  for (int e0 = tid; e0 < total; e0 += kLoads * nth) {
    T v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nth;
      if (e < total) {
        const int j = e / bcols;
        v[u] = img[static_cast<long long>(row(j)) * W + col(e - j * bcols)];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (e0 + u * nth < total) B[e0 + u * nth] = static_cast<S>(v[u]);
  }
}

// Stage rows x cols values: U[r * cols + q] = the staged value at
// (clamp(ys + r), clamp(xs + q)).  Without the pre-smooth, the pixels.
// With it, where `room` floats at P hold them: the raw band of the unique
// rows and columns plus the reflected ring (R, after P), then the
// vertical taps once per unique row and band column (P), then the
// horizontal ones, in staged_value's order; else staged_value per entry.
// Synchronises the block in the second case; the caller synchronises
// after it.
template <typename T, bool PRE>
__device__ __forceinline__ void stage(const T* __restrict__ img, int ys, int xs,
                                      int rows, int cols, int H, int W,
                                      const PolyConsts& c, float* U, float* P,
                                      int room, int tid, int nth) {
  if (!PRE) {
    load_band(img, W, rows, cols, [&](int r) { return oft::clampi(ys + r, 0, H - 1); },
              [&](int q) { return oft::clampi(xs + q, 0, W - 1); }, U, tid, nth);
    return;
  }
  const int cy0 = oft::clampi(ys, 0, H - 1);
  const int ny = oft::clampi(ys + rows - 1, 0, H - 1) - cy0 + 1;
  const int cx0 = oft::clampi(xs, 0, W - 1);
  const int pw = oft::clampi(xs + cols - 1, 0, W - 1) - cx0 + 3;
  const int p_floats = ny * pw;
  if (p_floats + ((ny + 2) * pw * static_cast<int>(sizeof(T)) + 3) / 4 <= room) {
    // R row j, column k: image row reflect101(cy0 - 1 + j), column
    // reflect101(cx0 - 1 + k); P row i: image row cy0 + i
    T* R = reinterpret_cast<T*>(P + p_floats);
    load_band(img, W, ny + 2, pw, [&](int j) { return oft::reflect101(cy0 - 1 + j, H); },
              [&](int k) { return oft::reflect101(cx0 - 1 + k, W); }, R, tid, nth);
    __syncthreads();
    for (Walk it(tid, nth, pw); it.r < ny; it.next()) {
      const T* b = R + it.r * pw + it.q;
      float a = c.pre[0] * static_cast<float>(b[0]);
      a = a + c.pre[1] * static_cast<float>(b[pw]);
      a = a + c.pre[2] * static_cast<float>(b[2 * pw]);
      P[it.r * pw + it.q] = a;
    }
    __syncthreads();
    for (Walk it(tid, nth, cols); it.r < rows; it.next()) {
      const float* h = P + (oft::clampi(ys + it.r, 0, H - 1) - cy0) * pw +
                       (oft::clampi(xs + it.q, 0, W - 1) - cx0);
      float v = c.pre[0] * h[0];
      v = v + c.pre[1] * h[1];
      v = v + c.pre[2] * h[2];
      U[it.r * cols + it.q] = v;
    }
    return;
  }
  for (Walk it(tid, nth, cols); it.r < rows; it.next())
    U[it.r * cols + it.q] = oft::staged_value<T, PRE>(
        img, oft::clampi(ys + it.r, 0, H - 1), oft::clampi(xs + it.q, 0, W - 1), H, W, c);
}

// The three vertical correlations of rows i0 .. i0 + rows - 1 at columns
// 0 .. cols - 1 of U (stride us; row i's window is U rows i .. i + 2n):
// V[k * vplane + (i - i0) * vs + col].  kVRows rows a thread from one
// sliding run where that many remain, one at a time in the last group.
constexpr int kVRows = 4;

template <int NTAPS>
__device__ __forceinline__ void vertical_pass(const float* U, int us, int i0,
                                              int rows, int cols, float* V,
                                              int vs, int vplane, int taps,
                                              const PolyConsts& c, int tid,
                                              int nth) {
  const int groups = (rows + kVRows - 1) / kVRows;
  for (Walk it(tid, nth, cols); it.r < groups; it.next()) {
    const int col = it.q;
    const int i = kVRows * it.r;
    const float* p = U + (i0 + i) * us + col;
    float* v = V + i * vs + col;
    if (i + kVRows <= rows) {
      float a0[kVRows], a1[kVRows], a2[kVRows];
      oft::vertical_run<kVRows, NTAPS>([&](int q) { return p[q * us]; }, taps, c, a0,
                                       a1, a2);
#pragma unroll
      for (int j = 0; j < kVRows; ++j) {
        v[j * vs] = a0[j];
        v[vplane + j * vs] = a1[j];
        v[2 * vplane + j * vs] = a2[j];
      }
    } else {
      for (int j = 0; i + j < rows; ++j) {
        float a0[1], a1[1], a2[1];
        oft::vertical_run<1, NTAPS>([&](int q) { return p[(j + q) * us]; }, taps, c,
                                    a0, a1, a2);
        v[j * vs] = a0[0];
        v[vplane + j * vs] = a1[0];
        v[2 * vplane + j * vs] = a2[0];
      }
    }
  }
}

// At most 128 registers a thread: two blocks of 256 threads, or one of
// 512, an SM.
template <typename T, bool PRE, bool GAUSS, int TX, int NT>
__global__ void __launch_bounds__(TX * BY, 512 / (TX * BY))
update_blur_poly_kernel(const void* __restrict__ img0_v,
                        const void* __restrict__ img1_v,
                        const float* __restrict__ flow_in,
                        float* __restrict__ flow_out, int H, int W, int m,
                        int n_arg, const float* __restrict__ taps_g,
                        float scale, int xc,
                        unsigned long long* __restrict__ counts,
                        const __grid_constant__ PolyConsts c) {
  constexpr int NTH = TX * BY;
  constexpr int NTAPS = NT ? 2 * NT + 1 : 0;
  extern __shared__ float smem[];
  const int n = NT ? NT : n_arg;
  const int taps = 2 * n + 1;
  const int MW = TX + 2 * m;
  const int MH = TY + 2 * m;
  float* Ms = smem;                   // [5][MH][MW]: R0, then M
  float* t = Ms + 5 * MH * MW;        // [2m + 1] window taps (GAUSS)
  float* X = t + 2 * m + 1;           // [xc]: staging, sums, row sums
  // the fetch targets' bounds and the anchor (lo_y, hi_y, lo_x, hi_x,
  // y, x), in M's place until the first box is known; at X's end, the M
  // pixels done (a bit each) and the bounds and count of the targets a
  // pass leaves; the fetch boxes take X's first xcb floats
  int* red = reinterpret_cast<int*>(Ms);
  const int xcb = xc - kTail - (MH * MW + 31) / 32;
  unsigned* done = reinterpret_cast<unsigned*>(X + xcb);
  int* left = reinterpret_cast<int*>(X + xc - kTail);
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const long long plane = static_cast<long long>(H) * W;
  const T* i0 = static_cast<const T*>(img0_v) + blockIdx.z * plane;
  const T* i1 = static_cast<const T*>(img1_v) + blockIdx.z * plane;
  const float* fl = flow_in + blockIdx.z * 2 * plane;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // the block's unique M rows and columns (the tile plus the m halo, in
  // the image) and the pixel whose target anchors a cut box
  const int ylo = max_i(y0 - m, 0), yhi = min_i(y0 + TY + m - 1, H - 1);
  const int xlo = max_i(x0 - m, 0), xhi = min_i(x0 + TX + m - 1, W - 1);
  const int nr = yhi - ylo + 1, nc = xhi - xlo + 1;
  const int cy = min_i(y0 + TY / 2, yhi), cx = min_i(x0 + TX / 2, xhi);

  if (tid == 0) {
    red[0] = INT_MAX;
    red[1] = INT_MIN;
    red[2] = INT_MAX;
    red[3] = INT_MIN;
    red[4] = -1;
  }
  if (GAUSS)
    for (int i = tid; i <= 2 * m; i += NTH) t[i] = taps_g[i];
  __syncthreads();

  // 1. img0 staged: X row r is image row clamp(ylo - n + r), column q
  // image column clamp(xlo - n + q)
  const int us0 = nc + 2 * n;
  const int u0 = (nr + 2 * n) * us0;
  stage<T, PRE>(i0, ylo - n, xlo - n, nr + 2 * n, us0, H, W, c, X, X + u0, xc - u0,
                tid, NTH);
  {
    int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN;
    constexpr int kFlows = 8;    // flow pixels a thread in flight
    for (int e0 = tid; e0 < nr * nc; e0 += kFlows * NTH) {
      float fx[kFlows], fy[kFlows];
      int ys[kFlows], xs[kFlows];
#pragma unroll
      for (int u = 0; u < kFlows; ++u) {
        const int e = e0 + u * NTH;
        if (e < nr * nc) {
          ys[u] = ylo + e / nc;
          xs[u] = xlo + e % nc;
          const long long p = static_cast<long long>(ys[u]) * W + xs[u];
          fx[u] = fl[p];
          fy[u] = fl[plane + p];
        }
      }
#pragma unroll
      for (int u = 0; u < kFlows; ++u) {
        int yi, xi;
        if (e0 + u * NTH < nr * nc &&
            oft::fetch_target(ys[u], xs[u], fx[u], fy[u], H, W, yi, xi)) {
          lo_y = min_i(lo_y, yi);
          hi_y = max_i(hi_y, yi);
          lo_x = min_i(lo_x, xi);
          hi_x = max_i(hi_x, xi);
          if (ys[u] == cy && xs[u] == cx) {
            red[4] = yi;
            red[5] = xi;
          }
        }
      }
    }
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    if ((tid & 31) == 0) {
      atomicMin(&red[0], lo_y);
      atomicMax(&red[1], hi_y);
      atomicMin(&red[2], lo_x);
      atomicMax(&red[3], hi_x);
    }
  }
  __syncthreads();
  Box bx = fit_box(red[0], red[1], red[2], red[3],
                   red[4] >= 0 ? red[4] : (red[0] + red[1]) / 2,
                   red[4] >= 0 ? red[5] : (red[2] + red[3]) / 2, xcb, n);
  __syncthreads();   // every thread has read red[]: M's place is free

  // 2. R0 on the unique pixels, into M's place
  const int vs0 = us0 + 3;   // horizontal_run's last group reads 3 past nc + 2n
  const int rb = min_i(nr, (xc - u0) / (3 * vs0));
  if (rb >= 1) {
    float* V = X + u0;
    const int vplane = rb * vs0;
    const int groups = (nc + 3) / 4;
    for (int b0 = 0; b0 < nr; b0 += rb) {
      const int rows = min_i(rb, nr - b0);
      vertical_pass<NTAPS>(X, us0, b0, rows, us0, V, vs0, vplane, taps, c, tid, NTH);
      __syncthreads();
      for (Walk it(tid, NTH, groups); it.r < rows; it.next()) {
        const int i = it.r;
        const int g = it.q;
        const float* v0 = V + i * vs0 + 4 * g;
        oft::HSums s[4];
        oft::horizontal_run<4, NTAPS>(
            [&](int q, float& r0, float& r1, float& r2) {
              r0 = v0[q];
              r1 = v0[vplane + q];
              r2 = v0[2 * vplane + q];
            },
            taps, c, s);
        float* o = Ms + (ylo + b0 + i - y0 + m) * MW + (xlo + 4 * g - x0 + m);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * g + j >= nc) break;
          float R[5];
          oft::combine(s[j], c, R);
#pragma unroll
          for (int k = 0; k < 5; ++k) o[k * MH * MW + j] = R[k];
        }
      }
      __syncthreads();
    }
  } else {
    for (Walk it(tid, NTH, nc); it.r < nr; it.next()) {
      const int i = it.r;
      const int j = it.q;
      const float* s0 = X + i * us0 + j;
      float R[5];
      oft::expand_at([&](int k, int q) { return s0[k * us0 + q]; }, n_arg, c, R);
      float* o = Ms + (ylo + i - y0 + m) * MW + (xlo + j - x0 + m);
      for (int k = 0; k < 5; ++k) o[k * MH * MW] = R[k];
    }
    __syncthreads();
  }

  // 3-4. passes over the unique pixels: img1 staged over the pass's
  // fetch box plus the n halo and its vertical sums taken; M of every
  // pixel whose target lies in the box (or that needs no R1) over R0,
  // marked in `done`; the bounds of the targets left give the next box,
  // placed at their top-left corner.  A pass with no box (none fits, few
  // targets left, or the last of kPasses) takes R1 of every pixel left
  // from device memory.
  const int total = nr * nc;
  const int lane = tid & 31;
  unsigned int per_pixel = 0, boxed = 0;
  for (int pass = 0;; ++pass) {
    const int us1 = bx.w + 2 * n;
    const int vplane1 = bx.h * us1;
    const float* V1 = X + (bx.h + 2 * n) * us1;
    if (bx.h > 0) {
      const int u1 = (bx.h + 2 * n) * us1;
      stage<T, PRE>(i1, bx.y0 - n, bx.x0 - n, bx.h + 2 * n, us1, H, W, c, X, X + u1,
                    xcb - u1, tid, NTH);
      __syncthreads();
      vertical_pass<NTAPS>(X, us1, 0, bx.h, us1, X + (bx.h + 2 * n) * us1, us1,
                           vplane1, taps, c, tid, NTH);
    }
    if (tid == 0) {
      left[0] = INT_MAX;
      left[1] = INT_MIN;
      left[2] = INT_MAX;
      left[3] = INT_MIN;
      left[4] = 0;
    }
    __syncthreads();
    int lo_y = INT_MAX, hi_y = INT_MIN, lo_x = INT_MAX, hi_x = INT_MIN, n_left = 0;
    Walk it(tid, NTH, nc);
    float next_dx = 0.0f, next_dy = 0.0f;   // the flow of the thread's next pixel
    if (tid < total) {
      const long long p = static_cast<long long>(ylo + it.r) * W + xlo + it.q;
      next_dx = fl[p];
      next_dy = fl[plane + p];
    }
    for (int base = tid - lane; base < total; base += NTH, it.next()) {
      const int e = base + lane;
      const int y = ylo + it.r;
      const int x = xlo + it.q;
      const float dx = next_dx;
      const float dy = next_dy;
      if (e + NTH < total) {
        Walk nx = it;
        nx.next();
        const long long p = static_cast<long long>(ylo + nx.r) * W + xlo + nx.q;
        next_dx = fl[p];
        next_dy = fl[plane + p];
      }
      const bool was = pass > 0 && e < total && ((done[base >> 5] >> lane) & 1u);
      bool now = false;
      if (e < total && !was) {
        int yi, xi;
        const bool inside = oft::fetch_target(y, x, dx, dy, H, W, yi, xi);
        const bool in_box = inside && yi >= bx.y0 && yi < bx.y0 + bx.h &&
                            xi >= bx.x0 && xi < bx.x0 + bx.w;
        if (!inside || in_box || bx.h == 0) {
          float* o = Ms + (y - y0 + m) * MW + (x - x0 + m);
          float a[5], d[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, mv[5];
          for (int k = 0; k < 5; ++k) a[k] = o[k * MH * MW];
          if (in_box) {
            const float* v0 = V1 + (yi - bx.y0) * us1 + (xi - bx.x0);
            oft::HSums hs[1];
            oft::horizontal_run<1, NTAPS>(
                [&](int q, float& r0, float& r1, float& r2) {
                  r0 = v0[q];
                  r1 = v0[vplane1 + q];
                  r2 = v0[2 * vplane1 + q];
                },
                taps, c, hs);
            oft::combine(hs[0], c, d);
            ++boxed;
          } else if (inside) {
            oft::expand_at(
                [&](int k, int j) {
                  return oft::staged_value<T, PRE>(i1, oft::clampi(yi - n + k, 0, H - 1),
                                                   oft::clampi(xi - n + j, 0, W - 1),
                                                   H, W, c);
                },
                n_arg, c, d);
            ++per_pixel;
          }
          oft::assemble(a, d, dx, dy, inside, y, x, H, W, mv);
          for (int k = 0; k < 5; ++k) o[k * MH * MW] = mv[k];
          now = true;
        } else {
          lo_y = min_i(lo_y, yi);
          hi_y = max_i(hi_y, yi);
          lo_x = min_i(lo_x, xi);
          hi_x = max_i(hi_x, xi);
          ++n_left;
        }
      }
      const unsigned word = __ballot_sync(0xffffffffu, was || now);
      if (lane == 0) done[base >> 5] = word;
    }
    if (__any_sync(0xffffffffu, n_left > 0)) {
      lo_y = __reduce_min_sync(0xffffffffu, lo_y);
      hi_y = __reduce_max_sync(0xffffffffu, hi_y);
      lo_x = __reduce_min_sync(0xffffffffu, lo_x);
      hi_x = __reduce_max_sync(0xffffffffu, hi_x);
      n_left = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(n_left));
      if (lane == 0) {
        atomicMin(&left[0], lo_y);
        atomicMax(&left[1], hi_y);
        atomicMin(&left[2], lo_x);
        atomicMax(&left[3], hi_x);
        atomicAdd(&left[4], n_left);
      }
    }
    __syncthreads();
    if (left[4] == 0) break;
    bx = left[4] >= kMinBoxed && pass + 2 < kPasses
             ? fit_box(left[0], left[1], left[2], left[3], left[0], left[2], xcb, n)
             : Box{0, 0, 0, 0};
    __syncthreads();   // left[] read by every thread before the next pass
  }
  if (counts != nullptr) {
    per_pixel = __reduce_add_sync(0xffffffffu, per_pixel);
    boxed = __reduce_add_sync(0xffffffffu, boxed);
    if (lane == 0) {
      atomicAdd(&counts[0], static_cast<unsigned long long>(per_pixel));
      atomicAdd(&counts[1], static_cast<unsigned long long>(boxed));
    }
    if (tid == 0) atomicAdd(&counts[2], static_cast<unsigned long long>(total));
  }
  // the entries outside the image: M at the clamped pixel
  if (nr < MH || nc < MW) {
    for (int e = tid; e < MH * MW; e += NTH) {
      const int ly = e / MW;
      const int lx = e - ly * MW;
      const int sy = oft::clampi(y0 - m + ly, 0, H - 1) - y0 + m;
      const int sx = oft::clampi(x0 - m + lx, 0, W - 1) - x0 + m;
      if (sy != ly || sx != lx)
        for (int k = 0; k < 5; ++k)
          Ms[(k * MH + ly) * MW + lx] = Ms[(k * MH + sy) * MW + sx];
    }
    __syncthreads();
  }

  // 5. the window sum and solve; X holds the row sums
  oft::window_sum_solve<GAUSS, TX, TY, BY>(Ms, X, t, m, scale, x0, y0, H, W,
                                           plane, flow_out + blockIdx.z * 2 * plane);
}

using KernelFn = void (*)(const void*, const void*, const float*, float*, int, int,
                          int, int, const float*, float, int, unsigned long long*,
                          const PolyConsts);

// cv2's poly_n 5 compiled with its n (the correlation runs unroll with
// the taps as constant operands) for the pyramid's launches at the
// default tile: uint8 with the pre-smooth at level 0, f32 without above;
// any other launch reads n at run time.  (The per-pixel expansions take
// n at run time throughout: unrolled, they only lengthen the build.)
template <typename T, bool PRE, bool GAUSS, int TX>
KernelFn pick_n(int n) {
  if constexpr (TX == kDefaultTile && (sizeof(T) == 1) == PRE)
    if (n == 5) return update_blur_poly_kernel<T, PRE, GAUSS, TX, 5>;
  return update_blur_poly_kernel<T, PRE, GAUSS, TX, 0>;
}

template <typename T, bool PRE, bool GAUSS>
KernelFn pick_tile(int tx, int n) {
  return tx == 64 ? pick_n<T, PRE, GAUSS, 64>(n) : pick_n<T, PRE, GAUSS, 32>(n);
}

template <typename T>
KernelFn pick_window(bool pre, bool gauss, int tx, int n) {
  if (pre)
    return gauss ? pick_tile<T, true, true>(tx, n) : pick_tile<T, true, false>(tx, n);
  return gauss ? pick_tile<T, false, true>(tx, n) : pick_tile<T, false, false>(tx, n);
}

KernelFn pick(int src_u8, int pre, int gauss, int tx, int n) {
  return src_u8 ? pick_window<uint8_t>(pre != 0, gauss != 0, tx, n)
                : pick_window<float>(pre != 0, gauss != 0, tx, n);
}

// The kernel, its plan and its shared-memory attribute; 0 or a cudaError_t.
int prepare(int src_u8, int pre, int gauss, int tx, int m, int n, KernelFn* fn,
            Plan* p) {
  if (m < 0 || n < 1 || n > oft::kPolyMaxN || (tx != 32 && tx != 64) ||
      !plan(tx, m, n, p))
    return static_cast<int>(cudaErrorInvalidValue);
  *fn = pick(src_u8, pre, gauss, tx, n);
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(*fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
      p->bytes));
}

int run(const void* img0, const void* img1, int src_u8, const float* flow_in,
        float* flow_out, int B, int H, int W, int m, int n, const float* taps,
        float scale, const float* consts, int pre, int tx,
        unsigned long long* counts, int device, void* stream) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  KernelFn fn;
  Plan p;
  const int rc = prepare(src_u8, pre, taps != nullptr, tx, m, n, &fn, &p);
  if (rc != 0) return rc;
  const PolyConsts c = oft::poly_consts(consts, n);
  const dim3 grid((W + tx - 1) / tx, (H + TY - 1) / TY, B);
  int xc = p.xc;
  void* args[] = {&img0, &img1, &flow_in, &flow_out, &H,     &W,      &m,
                  &n,    &taps, &scale,   &xc,       &counts, const_cast<PolyConsts*>(&c)};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid,
                                           dim3(tx, BY), args, p.bytes,
                                           static_cast<cudaStream_t>(stream)));
}

// The default tile where its plan fits, else 32 columns.
int default_tile(int m, int n) {
  Plan p;
  return plan(kDefaultTile, m, n, &p) ? kDefaultTile : 32;
}

}  // namespace

// img0, img1: (B, H, W) uint8 (src_u8 != 0) or f32; flow_in, flow_out:
// distinct (B, 2, H, W) f32.  m = winsize / 2; n = poly_n.  taps: the
// 2m + 1 Gaussian window taps on the device (scale 1), or null for the box
// window (scale 1 / winsize^2).  consts: the expansion's host array, as
// oft_polyexp's; pre != 0 pre-smooths both images.  Returns a cudaError_t.
extern "C" int oft_update_blur_poly(const void* img0, const void* img1,
                                    int src_u8, const float* flow_in,
                                    float* flow_out, int B, int H, int W,
                                    int m, int n, const float* taps,
                                    float scale, const float* consts, int pre,
                                    int device, void* stream) {
  if (m < 0 || n < 1 || n > oft::kPolyMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(img0, img1, src_u8, flow_in, flow_out, B, H, W, m, n, taps, scale,
             consts, pre, default_tile(m, n), nullptr, device, stream);
}

// oft_update_blur_poly at a tile of tile_w (32 or 64) output columns,
// adding to counts[0] the M pixels whose R1 came from device memory (the
// per-pixel path), to counts[1] those whose R1 came from a fetch box
// and to counts[2] every M pixel the blocks evaluated (device array of 3).
extern "C" int oft_update_blur_poly_counted(
    const void* img0, const void* img1, int src_u8, const float* flow_in,
    float* flow_out, int B, int H, int W, int m, int n, const float* taps,
    float scale, const float* consts, int pre, int tile_w,
    unsigned long long* counts, int device, void* stream) {
  if (m < 0 || n < 1 || n > oft::kPolyMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(img0, img1, src_u8, flow_in, flow_out, B, H, W, m, n, taps, scale,
             consts, pre, tile_w, counts, device, stream);
}

// The launch's dynamic shared memory (bytes) and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at tile_w output
// columns.  Returns a cudaError_t.
extern "C" int oft_update_blur_poly_occupancy(int m, int n, int gauss, int src_u8,
                                              int pre, int tile_w, int device,
                                              int* blocks, int* smem) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  KernelFn fn;
  Plan p;
  const int rc = prepare(src_u8, pre, gauss, tile_w, m, n, &fn, &p);
  if (rc != 0) return rc;
  *smem = p.bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(fn), tile_w * BY, p.bytes));
}
