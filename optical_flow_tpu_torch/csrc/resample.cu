// X1: separable resampling of f32 planes by per-axis tap tables.
//
// Replaces what optical_flow_tpu leaves to one XLA fusion between its
// Pallas kernels (no pl.pallas_call): the pyramid's x2 flow upsample with
// its scale (models/farneback/flow.py:296-297, resize_bilinear_f32 then
// the multiply), the bilinear resize after the full-resolution Gaussian
// (flow.py:231) and the seed's INTER_AREA downsample with its scale
// (flow.py:290-292).  A table is (d_len, T) source indices (int32) and
// weights (f32); the bilinear one has T = 2, INTER_AREA about
// ceil(scale) + 1 with zero-weight pads at index 0, a unit one T = 1
// (weight 1).
//
// Every output makes, for each tap of the second axis, the first axis's
// sum over its taps (the first-pass value), then adds the weighted sums;
// every sum starts from its first term and adds the others in table
// order, and the scale is one f32 multiply at the end.  With
// --fmad=false that is the plain version's arithmetic op for op, plane by
// plane, so the result is equal to the bit (resample_taps in
// tests/test_torch_resample.py is this loop in PyTorch).
//
// What bounds it: device-memory bytes, the source read once and the
// output written once, 4 B a pixel each way.  The host
// (kernels/resample.py:plan) picks one of three kernels by the tables'
// spans, before the launch:
//
// - band (the horizontal pass first, both tables bilinear: the
//   upsamples, the halo's row blocks, the milder downsamples).  A block
//   makes an output tile of TH = 8 or 16 rows x TILE_W columns for the
//   planes it is given.  The tile's table entries go to shared memory
//   once, with source indices made relative to the band they reach, and
//   each thread keeps its own in registers (bilinear tables); the band
//   of source rows and columns the tile's taps reach is staged a plane at
//   a time with cp.async (16-byte copies where the rows are 16-byte
//   aligned), the next plane's band in flight while the current one is
//   read.  A thread makes 4 consecutive outputs of a row and writes them
//   with one 16-byte store where the row allows.
// - columns (the vertical pass first: INTER_AREA on the seed's
//   (B, H, W, 2) layout).  The vertical pass needs no gather along a
//   row, so its source rows stream through registers with 16-byte loads
//   (two pixels' (x, y) a load, both channels at once) into the vertical sums
//   of the tile's source columns, kept in shared memory split into
//   planes; then each thread makes 4 consecutive outputs of a row from
//   them, as above.
// - generic: any tables, an output a thread, the taps read through L1;
//   for the tables and layouts the others do not take (a unit table, a
//   growing axis's pair of launches, INTER_AREA on planar rows), and
//   where the band would not fit the shared memory the host allows a
//   block (a bilinear downsample past about 2x, whose taps skip rows and
//   columns: the levels=5 resizes), or where the tiles would mostly lie
//   past the frame (a 129-wide frame's second column of tiles).
//
// The source is read through its strides, so the seed's (B, H, W, 2)
// layout is read in place.

#include <climits>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_W = 128;        // band and columns kernels: output columns a tile
constexpr int GROUPS = TILE_W / 4;  // 4 consecutive outputs a thread: a warp a row
constexpr int LOADS = 8;            // columns kernel: row loads in flight a thread
// generic kernel
constexpr int TX = 32;
constexpr int TY = 8;
// Threads a launch needs before a thread takes PLANES planes, not one.
constexpr long long MANY_THREADS = 1LL << 19;
constexpr int PLANES = 4;
// The dynamic shared memory a band or columns block may take: the 48 KB a
// block has without an opt-in, less the 16 bytes those kernels declare
// statically (their s_lo).
constexpr int SMEM = 48 * 1024 - 16;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Plane q's first element: plane (q / C, q % C).
__device__ __forceinline__ const float* plane_ptr(const float* src, long long sn,
                                                  long long sc, int C, int q) {
  const int n = q / C;
  return src + static_cast<long long>(n) * sn + static_cast<long long>(q - n * C) * sc;
}

// Stages a tile's table entries (rows [t0, t0 + nt) of a (d_len, T)
// table, `tile` rows staged) into shared memory as they are: output o's
// tap t at o * T + t, or, tap-major, at t * tile + o (a lane's 4
// consecutive outputs' tap t then lie in one 16-byte word).  The entries
// of outputs past the frame's edge repeat the tile's first with weight 0
// (their results are not stored).  Where lo is given, the entries' least
// index goes to *lo (the band's first row or column), from the same read
// of the table.
__device__ __forceinline__ void stage_table(const int* __restrict__ idx,
                                            const float* __restrict__ wt, int t0, int nt,
                                            int tile, int T, bool tap_major, int* s_idx,
                                            float* s_wt, int* lo) {
  const long long e = static_cast<long long>(t0) * T;
  for (int k = threadIdx.x; k < tile * T; k += THREADS) {
    const bool in = k < nt * T;
    const int v = idx[e + (in ? k : 0)];
    const int o = k / T;
    const int at = tap_major ? (k - o * T) * tile + o : k;
    s_idx[at] = v;
    s_wt[at] = in ? wt[e + k] : 0.0f;
    if (lo != nullptr && in) atomicMin(lo, v);
  }
}

// A column's place in the columns kernel's vertical sums: one word of
// padding every 32, so that lanes 32 columns apart (an 8x downsample's
// outputs, 4 a lane) fall in different banks.
__device__ __forceinline__ int skew(int c) { return c + (c >> 5); }

// 4 consecutive outputs of row oy from column ox on, of a contiguous
// (., dh, dw) plane: one 16-byte store where the row is 16-byte aligned
// (dw % 4 == 0) and the 4 lie in it, else one store each inside it.
__device__ __forceinline__ void store4(float* __restrict__ plane, int oy, int ox, int dh,
                                       int dw, const float (&o)[4]) {
  float* p = plane + static_cast<long long>(oy) * dw + ox;
  if ((dw & 3) == 0 && ox + 4 <= dw) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ox + e < dw) p[e] = o[e];
  }
}

// ---------------------------------------------------------------- band

// Horizontal pass first, both tables bilinear (2 taps: unrolled, each
// thread's entries in registers).  kLoad: 4 copies the band 16 bytes at a
// time (unit column stride, 16-byte aligned rows), 1 an element at a
// time through any strides.  kRows: the tile's rows over 8 (a thread's
// rows).  Dynamic shared memory: the band twice (band_h x band_w floats
// each, from source row rlo and column clo), then the tile's column table
// (tap-major) and row table.
template <int kLoad, int kRows>
__global__ void __launch_bounds__(THREADS)
resample_band_kernel(const float* __restrict__ src, long long sn, long long sc,
                     long long sh, long long sw, int C, int NC, int H, int W,
                     const int* __restrict__ iy, const float* __restrict__ wy,
                     const int* __restrict__ ix, const float* __restrict__ wx,
                     float scale, float* __restrict__ out, int dh, int dw, int band_h,
                     int band_w) {
  constexpr int TH = 8 * kRows;
  constexpr int T = 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo[2];
  const int band = band_h * band_w;
  float* bufs = smem;
  int* s_cx = reinterpret_cast<int*>(smem + 2 * band);      // tap-major
  float* s_wx = reinterpret_cast<float*>(s_cx + TILE_W * T);
  int* s_ry = reinterpret_cast<int*>(s_wx + TILE_W * T);
  float* s_wy = reinterpret_cast<float*>(s_ry + TH * T);

  const int tid = threadIdx.x;
  const int lx = tid % GROUPS;   // the thread's 4 columns: 4 lx .. 4 lx + 3
  const int ly = tid / GROUPS;   // its rows: ly, ly + 8, ...
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TILE_W;
  const int nrows = min(TH, dh - oy0);
  const int ncols = min(TILE_W, dw - ox0);
  if (tid < 2) s_lo[tid] = INT_MAX;
  __syncthreads();
  stage_table(iy, wy, oy0, nrows, TH, T, false, s_ry, s_wy, &s_lo[0]);
  stage_table(ix, wx, ox0, ncols, TILE_W, T, true, s_cx, s_wx, &s_lo[1]);
  __syncthreads();  // the tables and the band's origin (rlo, clo)
  const int rlo = s_lo[0];
  const int clo = kLoad == 4 ? (s_lo[1] & ~3) : s_lo[1];

  const int rows = min(band_h, H - rlo);
  const int cols = min(band_w, W - clo);
  auto stage = [&](int q, float* buf) {
    const float* base = plane_ptr(src, sn, sc, C, q) + rlo * sh;
    if constexpr (kLoad == 4) {
      const int per_row = (cols + 3) / 4;
      for (int k = tid; k < rows * per_row; k += THREADS) {
        const int r = k / per_row;
        const int c = 4 * (k - r * per_row);
        const float* g = base + r * sh + clo + c;
        float* d = buf + r * band_w + c;
        if (c + 4 <= cols) {
          cp_async16(d, g);
        } else {
          for (int e = 0; c + e < cols; ++e) cp_async4(d + e, g + e);
        }
      }
    } else {
      for (int k = tid; k < rows * cols; k += THREADS) {
        const int r = k / cols;
        const int c = k - r * cols;
        cp_async4(buf + r * band_w + c, base + r * sh + (clo + c) * sw);
      }
    }
    cp_async_commit();
  };

  // planes blockIdx.z, + gridDim.z, ... of the NC
  const int dq = gridDim.z;
  stage(blockIdx.z, bufs);

  // the thread's own entries, made relative to the band, the same for
  // every plane
  int ry[kRows][T], cx[4][T];
  float fy[kRows][T], fx[4][T];
#pragma unroll
  for (int g = 0; g < kRows; ++g)
#pragma unroll
    for (int k = 0; k < T; ++k) {
      ry[g][k] = (s_ry[(ly + 8 * g) * T + k] - rlo) * band_w;
      fy[g][k] = s_wy[(ly + 8 * g) * T + k];
    }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < T; ++k) {
      cx[e][k] = s_cx[k * TILE_W + 4 * lx + e] - clo;
      fx[e][k] = s_wx[k * TILE_W + 4 * lx + e];
    }

  for (int q = blockIdx.z, i = 0; q < NC; q += dq, ++i) {
    const float* buf = bufs + (i & 1) * band;
    if (q + dq < NC) {
      stage(q + dq, bufs + ((i + 1) & 1) * band);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* plane = out + static_cast<long long>(q) * dh * dw;
    const int ox = ox0 + 4 * lx;
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const int r = ly + 8 * g;
      if (r >= nrows || ox >= dw) continue;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* b0 = buf + ry[g][0];
        const float* b1 = buf + ry[g][1];
        const float h0 = b0[cx[e][0]] * fx[e][0] + b0[cx[e][1]] * fx[e][1];
        const float h1 = b1[cx[e][0]] * fx[e][0] + b1[cx[e][1]] * fx[e][1];
        o[e] = (h0 * fy[g][0] + h1 * fy[g][1]) * scale;
      }
      store4(plane, oy0 + r, ox, dh, dw, o);
    }
    __syncthreads();  // the buffer is staged again two planes on
  }
}

// ------------------------------------------------------------- columns

// Vertical pass first.  kLoad: 2 loads 2 pixels of both channels of a
// (B, H, W, 2) layout (C == 2, channel stride 1, column stride 2: the
// seed), an item being a pair of planes; 1 an element of a plane through
// any strides.  Dynamic shared memory: the tile's column table
// (tap-major), the vertical sums (tile_h rows x band_w columns a
// channel, a word of padding every 32), then the row table.
template <int kLoad>
__global__ void __launch_bounds__(THREADS)
resample_columns_kernel(const float* __restrict__ src, long long sn, long long sc,
                        long long sh, long long sw, int C, int NC, int W,
                        const int* __restrict__ iy, const float* __restrict__ wy, int ty,
                        const int* __restrict__ ix, const float* __restrict__ wx, int tx,
                        float scale, float* __restrict__ out, int dh, int dw, int tile_h,
                        int band_w) {
  constexpr int NCH = kLoad;                     // planes an item, source columns a load
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_lo;
  const int pitch = band_w + (band_w >> 5);     // a row of sums, skewed
  const int vplane = tile_h * pitch;
  int* s_cx = reinterpret_cast<int*>(smem);     // tap-major
  float* s_wx = reinterpret_cast<float*>(s_cx + TILE_W * tx);
  float* s_v = s_wx + TILE_W * tx;
  int* s_ry = reinterpret_cast<int*>(s_v + NCH * vplane);
  float* s_wy = reinterpret_cast<float*>(s_ry + tile_h * ty);

  const int tid = threadIdx.x;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * TILE_W;
  const int nrows = min(tile_h, dh - oy0);
  const int ncols = min(TILE_W, dw - ox0);
  if (tid == 0) s_lo = INT_MAX;
  __syncthreads();
  stage_table(iy, wy, oy0, nrows, tile_h, ty, false, s_ry, s_wy, nullptr);
  stage_table(ix, wx, ox0, ncols, TILE_W, tx, true, s_cx, s_wx, &s_lo);
  __syncthreads();  // the tables and the band's first column
  const int clo = s_lo & ~(kLoad - 1);

  const int cols = min(band_w, W - clo);
  const int per_row = (cols + kLoad - 1) / kLoad;
  const int items = kLoad == 2 ? NC / 2 : NC;
  for (int q = blockIdx.z; q < items; q += gridDim.z) {
    const float* base = kLoad == 2 ? src + static_cast<long long>(q) * sn
                                   : plane_ptr(src, sn, sc, C, q);
    // the vertical sums of the band's columns, each from its first row
    for (int k = tid; k < nrows * per_row; k += THREADS) {
      const int r = k / per_row;
      const int c = kLoad * (k - r * per_row);
      const int* rows = s_ry + r * ty;
      const float* rw = s_wy + r * ty;
      float v[4];
      if constexpr (kLoad == 1) {
        const float* g = base + static_cast<long long>(clo + c) * sw;
        v[0] = g[rows[0] * sh] * rw[0];
        for (int j = 1; j < ty; ++j) v[0] = v[0] + g[rows[j] * sh] * rw[j];
        s_v[r * pitch + skew(c)] = v[0];
      } else {
        // W is even, so both pixels lie in the row.  LOADS rows' loads are
        // in flight before their terms are added in order.
        const float* g = base + static_cast<long long>(clo + c) * 2;
        for (int j0 = 0; j0 < ty; j0 += LOADS) {
          float4 x[LOADS];
#pragma unroll
          for (int u = 0; u < LOADS; ++u)
            if (j0 + u < ty)
              x[u] = __ldg(reinterpret_cast<const float4*>(g + rows[j0 + u] * sh));
#pragma unroll
          for (int u = 0; u < LOADS; ++u) {
            if (j0 + u >= ty) break;
            const float w = rw[j0 + u];
            if (j0 + u == 0) {
              v[0] = x[u].x * w; v[1] = x[u].y * w; v[2] = x[u].z * w; v[3] = x[u].w * w;
            } else {
              v[0] = v[0] + x[u].x * w; v[1] = v[1] + x[u].y * w;
              v[2] = v[2] + x[u].z * w; v[3] = v[3] + x[u].w * w;
            }
          }
        }
        // (x, y) of pixels c and c + 1 -> channel planes 0 and 1
        float* d = s_v + r * pitch + skew(c);      // c is even: c + 1 is beside it
        d[0] = v[0];
        d[vplane] = v[1];
        d[1] = v[2];
        d[vplane + 1] = v[3];
      }
    }
    __syncthreads();
    // the horizontal sums from them: a warp a (channel, row), 4 outputs a lane
    for (int k = tid; k < NCH * tile_h * GROUPS; k += THREADS) {
      const int g4 = k % GROUPS;
      const int rc = k / GROUPS;
      const int r = rc % tile_h;
      const int ch = rc / tile_h;
      const int ox = ox0 + 4 * g4;
      if (r >= nrows || ox >= dw) continue;
      const float* vr = s_v + ch * vplane + r * pitch;
      float o[4];
      for (int i = 0; i < tx; ++i) {
        const int4 c = *reinterpret_cast<const int4*>(s_cx + i * TILE_W + 4 * g4);
        const float4 w = *reinterpret_cast<const float4*>(s_wx + i * TILE_W + 4 * g4);
        const float t[4] = {vr[skew(c.x - clo)] * w.x, vr[skew(c.y - clo)] * w.y,
                            vr[skew(c.z - clo)] * w.z, vr[skew(c.w - clo)] * w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = i == 0 ? t[e] : o[e] + t[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = o[e] * scale;
      store4(out + (static_cast<long long>(q) * NCH + ch) * dh * dw, oy0 + r, ox, dh, dw, o);
    }
    __syncthreads();  // the sums are made again for the next item
  }
}

// ------------------------------------------------------------- generic

// The planes [nc0, nc0 + kPlanes) of the source (nc0 < NC), with one
// division; a plane past the last repeats it (its result is not stored).
template <int kPlanes>
__device__ __forceinline__ void plane_ptrs(const float* src, long long sn, long long sc,
                                           int C, int NC, int nc0, const float** p) {
  if constexpr (kPlanes == 1) {
    p[0] = plane_ptr(src, sn, sc, C, nc0);
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

// Any tables, one output pixel a thread of one plane, or of up to kPlanes
// planes where the launch has outputs enough.  kTaps > 0: both tables
// have kTaps taps (the bilinear 2), unrolled; 0: ty and tx are read at
// run time.  The second axis's taps outside, the first axis's inside.
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

template <int kPlanes>
void launch_generic(bool vertical_first, cudaStream_t s, const float* src, long long sn,
                    long long sc, long long sh, long long sw, int C, int NC, const int* iy,
                    const float* wy, int ty, const int* ix, const float* wx, int tx,
                    float scale, float* out, int dh, int dw) {
  const dim3 block(TX, TY);
  const int groups = (NC + kPlanes - 1) / kPlanes;
  const dim3 grid((dw + TX - 1) / TX, (dh + TY - 1) / TY, groups < 65535 ? groups : 65535);
  const bool two_taps = ty == 2 && tx == 2;     // the bilinear tables
  if (vertical_first) {
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

// Blocks of `kernel` (THREADS threads, smem bytes of dynamic shared
// memory) the current card holds at once, at least one an SM; asked of
// the runtime once per (card, kernel, smem) and kept (a launch's host
// time is what bounds the small frames).
long long resident_blocks(const void* kernel, int smem) {
  struct Entry {
    const void* kernel;
    int device, smem;
    long long blocks;
  };
  static std::mutex mutex;
  static std::vector<Entry> known;
  int device = 0;
  cudaGetDevice(&device);
  const std::lock_guard<std::mutex> lock(mutex);
  for (const Entry& e : known)
    if (e.kernel == kernel && e.device == device && e.smem == smem) return e.blocks;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const long long blocks =
      static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  known.push_back({kernel, device, smem, blocks});
  return blocks;
}

// The plane groups of a band or columns launch (its grid's z; a block
// walks its group's planes, the next one's band in flight, the tables
// staged once).  Of 1 to `items` groups, the one that minimises the
// waves of resident blocks times (planes a block + SETUP), SETUP being a
// block's staging of its tables in planes' time: enough blocks to fill
// the card, no ragged last wave where a block walks many planes.
template <typename Kernel>
unsigned plane_groups(Kernel kernel, int smem, dim3 grid, int items) {
  constexpr long long SETUP = 2;
  const long long resident = resident_blocks(reinterpret_cast<const void*>(kernel), smem);
  const long long tiles = static_cast<long long>(grid.x) * grid.y;
  // past 4 waves of one-plane blocks the cost only grows
  const long long cap = (4 * resident + tiles - 1) / tiles;
  const int most = static_cast<int>(items < cap ? items : cap);
  long long best = -1;
  int groups = 1;
  for (int g = 1; g <= most; ++g) {
    const long long waves = (tiles * g + resident - 1) / resident;
    const long long cost = waves * ((items + g - 1) / g + SETUP);
    if (best < 0 || cost < best) {
      best = cost;
      groups = g;
    }
  }
  return static_cast<unsigned>(groups);
}

template <int kLoad>
void launch_band(int tile_h, dim3 grid, int smem, cudaStream_t s, const float* src,
                 long long sn, long long sc, long long sh, long long sw, int C, int NC,
                 int H, int W, const int* iy, const float* wy, const int* ix,
                 const float* wx, float scale, float* out, int dh, int dw, int band_h,
                 int band_w) {
  auto kernel = tile_h == 16 ? resample_band_kernel<kLoad, 2> : resample_band_kernel<kLoad, 1>;
  grid.z = plane_groups(kernel, smem, grid, NC);
  kernel<<<grid, THREADS, smem, s>>>(src, sn, sc, sh, sw, C, NC, H, W, iy, wy, ix, wx, scale,
                                     out, dh, dw, band_h, band_w);
}

template <int kLoad>
void launch_columns(dim3 grid, int smem, cudaStream_t s, const float* src, long long sn,
                    long long sc, long long sh, long long sw, int C, int NC, int W,
                    const int* iy, const float* wy, int ty, const int* ix, const float* wx,
                    int tx, float scale, float* out, int dh, int dw, int tile_h,
                    int band_w) {
  auto kernel = resample_columns_kernel<kLoad>;
  grid.z = plane_groups(kernel, smem, grid, NC / kLoad);
  kernel<<<grid, THREADS, smem, s>>>(src, sn, sc, sh, sw, C, NC, W, iy, wy, ty, ix, wx, tx,
                                     scale, out, dh, dw, tile_h, band_w);
}

}  // namespace

// The launch plan's paths (kernels/resample.py:PATHS).
enum { GENERIC = 0, BAND = 1, COLUMNS = 2 };

// src: NC = N * C planes of H x W f32, plane (n, c) at n * sn + c * sc,
// element (y, x) at y * sh + x * sw (strides in elements); iy, wy: (dh, ty)
// vertical table; ix, wx: (dw, tx) horizontal table; out: (NC, dh, dw)
// contiguous f32.  vertical_first: 1 for the vertical pass first (INTER_AREA),
// 0 for the horizontal first (bilinear).  The plan (kernels/resample.py:
// plan): path (GENERIC, BAND, COLUMNS), load (floats a load moves: 4, 2
// for the (B, H, W, 2) pairs, 1), tile_h (output rows a tile), band_h and
// band_w (the staged band's rows and columns), smem (dynamic shared memory
// bytes).  Returns a cudaError_t.
extern "C" int oft_resample(const float* src, long long sn, long long sc, long long sh,
                            long long sw, int C, int NC, int H, int W, const int* iy,
                            const float* wy, int ty, const int* ix, const float* wx,
                            int tx, int vertical_first, float scale, float* out,
                            int dh, int dw, int path, int load, int tile_h, int band_h,
                            int band_w, int smem, int device, void* stream) {
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0 || NC <= 0 || H <= 0 || W <= 0 || ty <= 0 || tx <= 0 || dh <= 0 || dw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (path == GENERIC) {
    // PLANES planes a thread (two where there are two or three) where the
    // outputs alone give threads enough
    const bool many = static_cast<long long>(dh) * dw * NC >= MANY_THREADS * PLANES;
    if (many && NC >= PLANES) {
      launch_generic<PLANES>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix,
                             wx, tx, scale, out, dh, dw);
    } else if (many && NC >= 2) {
      launch_generic<2>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx,
                        tx, scale, out, dh, dw);
    } else {
      launch_generic<1>(vertical_first, s, src, sn, sc, sh, sw, C, NC, iy, wy, ty, ix, wx,
                        tx, scale, out, dh, dw);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (tile_h <= 0 || band_w <= 0 || smem <= 0 || smem > SMEM ||
      (load == 2 && (C != 2 || NC % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared memory the kernel lays out, which the plan must give
  const long long tables = 8LL * (static_cast<long long>(tile_h) * ty + TILE_W * tx);
  const long long need =
      path == BAND ? 8LL * band_h * band_w + tables
                   : 4LL * (load == 2 ? 2 : 1) * tile_h * (band_w + (band_w >> 5)) + tables;
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((dw + TILE_W - 1) / TILE_W, (dh + tile_h - 1) / tile_h, 1);
  if (path == BAND && !vertical_first && (tile_h == 8 || tile_h == 16) && band_h > 0 &&
      ty == 2 && tx == 2 && (load == 4 || load == 1)) {
    if (load == 4) {
      launch_band<4>(tile_h, grid, smem, s, src, sn, sc, sh, sw, C, NC, H, W, iy, wy, ix, wx,
                     scale, out, dh, dw, band_h, band_w);
    } else {
      launch_band<1>(tile_h, grid, smem, s, src, sn, sc, sh, sw, C, NC, H, W, iy, wy, ix, wx,
                     scale, out, dh, dw, band_h, band_w);
    }
  } else if (path == COLUMNS && vertical_first && (load == 2 || load == 1)) {
    if (load == 2) {
      launch_columns<2>(grid, smem, s, src, sn, sc, sh, sw, C, NC, W, iy, wy, ty, ix, wx, tx,
                        scale, out, dh, dw, tile_h, band_w);
    } else {
      launch_columns<1>(grid, smem, s, src, sn, sc, sh, sw, C, NC, W, iy, wy, ty, ix, wx, tx,
                        scale, out, dh, dw, tile_h, band_w);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
