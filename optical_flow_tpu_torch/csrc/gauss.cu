// K6: full-resolution separable Gaussian blur with REFLECT_101 borders.
//
// Replaces the Pallas kernel of optical_flow_tpu/pallas/gauss.py
// (gaussian_blur_pallas): cv2.GaussianBlur of (n, H, W) uint8 or f32
// frames with any odd tap count, the vertical pass first, then the
// horizontal one, each acc = t[0] * v[0]; acc = acc + t[i] * v[i] in tap
// order, as the plain version (models/farneback/core.py:
// gaussian_blur_reflect101) sums them; with --fmad=false the two agree to
// the last bit.  The border index is a load through a reflected index
// (any number of reflections, as core._pad_index), so there is no padded
// copy of the frame.
//
// What bounds it: f32 instruction issue.  Each pixel needs 2 x ntaps
// multiplies and adds a pass, unfused (4 x 118 at the two levels of a
// five-level 1080p pyramid: 0.93 ms for a (32, 1080, 1920) batch at the
// card's 33.5e12 unfused f32 instructions a second), far above the 5 B/px
// a uint8 frame reads and writes.  So the design spends as few other
// instructions as it can on each multiply-add:
//
// - A block covers TY = 32 output rows (16 at radii past about 870) and
//   a column span TX chosen per frame width and tap count
//   (kernels/gauss.py:tile): as wide as two blocks an SM allow, so the
//   vertical sums over the columns the horizontal taps reach recompute 14 %
//   more than TX at 79 taps on a 1920 frame (8 % at 39), not 61 % (30 %).
// - Vertical pass, into shared memory: each thread makes CV = 4 columns x
//   KV = 8 rows, loading the 4 columns of a row with one 32-bit (uint8) or
//   16-byte (f32) load where the frame's rows are aligned (a scalar
//   reflected load per column at the borders), into a ring of KV rows in
//   registers whose slots are compile-time indices (the tap loop runs in
//   chunks of 8, unrolled), so there is no register shifting.  Row indices
//   are computed in registers, without a branch away from the borders.
//   uint8 rows are fetched a chunk ahead of their use.
// - Horizontal pass, from shared memory: each lane of a warp takes one
//   row (an odd pitch keeps the 32 rows on 32 banks) and KH = 8 adjacent
//   outputs from one sliding run of vertical sums, so a tap costs one
//   shared load for 8 multiply-adds.  Outputs leave in 16-byte stores.
// - Taps are read from shared memory a chunk of 8 at a time, two 16-byte
//   loads, and kept in registers for the chunk.  For uint8 frames every
//   value is >= 0, so each chain starts at +0 and runs whole chunks (zero
//   taps past the count) with the same bits: one loop body a run, which
//   keeps the unrolled code small enough for the instruction cache (a
//   first version with an unrolled first and last chunk ran slower than
//   the kernel it replaced).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KV = 8;   // output rows a thread, vertical pass
constexpr int CV = 4;   // output columns a thread, vertical pass
constexpr int KH = 8;   // output columns a thread, horizontal pass

// REFLECT_101 source index of padded position i on an axis of length n,
// any number of reflections.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = abs(i) % period;
  return i >= n ? period - i : i;
}

// The raw vector of C = 4 adjacent columns: a uint8 word, an f32 vector.
template <typename T, int C>
struct Vec;
template <>
struct Vec<uint8_t, 4> {
  using type = unsigned int;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};

// C columns of one row: one vector load at column x (in the frame, rows
// aligned), or one scalar load per reflected column.
template <int C>
__device__ __forceinline__ void load_cols(const float* row, int x, float (&v)[C]) {
  union {
    typename Vec<float, C>::type q;
    float f[C];
  } u;
  u.q = __ldg(reinterpret_cast<const typename Vec<float, C>::type*>(row + x));
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = u.f[c];
}
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* row, const int (&cols)[C],
                                          float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = static_cast<float>(__ldg(row + cols[c]));
}

// Source row of padded row i on an axis of n rows.  ROWS 0: i lies in the
// frame; 1: at most one reflection (-(n-1) <= i <= 2(n-1), n >= 2),
// without a branch; 2: any number of reflections.  Branch-free row
// indices let the compiler issue a chunk's loads ahead of its arithmetic.
template <int ROWS>
__device__ __forceinline__ int source_row(int i, int n) {
  if (ROWS == 0) return i;
  if (ROWS == 1) {
    i = abs(i);
    return min(i, 2 * (n - 1) - i);
  }
  return reflect101(i, n);
}

// Taps i0 .. i0 + K - 1 from shared memory into registers, K / 4 16-byte
// loads (taps 16-byte aligned, zero-padded past the count).
template <int K>
__device__ __forceinline__ void tap_chunk(const float* taps, int i0, float (&tk)[K]) {
  static_assert(K % 4 == 0, "a chunk is whole float4 loads");
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 t4 = *reinterpret_cast<const float4*>(taps + i0 + k);
    tk[k] = t4.x;
    tk[k + 1] = t4.y;
    tk[k + 2] = t4.z;
    tk[k + 3] = t4.w;
  }
}

// Loaders of x(m) for corr_run: fetch(m) issues the load of x(m) and
// returns it raw, unpack(raw, v) gives its values.  A loader with
// kPrefetch fetches a chunk of taps' values one chunk ahead of their use,
// into registers (a 32-bit word a row), so a load's latency hides behind a
// chunk of multiply-adds and not one tap's.

// C uint8 columns at x, in the frame: raw = the word.
template <int ROWS, int C>
struct WordLoader {
  using Raw = typename Vec<uint8_t, C>::type;
  static constexpr bool kPrefetch = true;
  const uint8_t* img;
  int H, W, x, yb;
  __device__ __forceinline__ Raw fetch(int m) const {
    const uint8_t* row = img + static_cast<long long>(source_row<ROWS>(yb + m, H)) * W;
    return __ldg(reinterpret_cast<const Raw*>(row + x));
  }
  __device__ __forceinline__ void unpack(Raw q, float (&v)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = static_cast<float>((q >> (8 * c)) & 0xffu);
  }
};

// C f32 columns at x (VEC) or C reflected columns of either type.
template <typename T, bool VEC, int ROWS, int C>
struct ColumnLoader {
  struct Raw {
    float v[C];
  };
  static constexpr bool kPrefetch = false;
  const T* img;
  int H, W, x, yb;
  const int (&cols)[C];
  __device__ __forceinline__ Raw fetch(int m) const {
    const T* row = img + static_cast<long long>(source_row<ROWS>(yb + m, H)) * W;
    Raw r;
    if constexpr (VEC)
      load_cols<C>(reinterpret_cast<const float*>(row), x, r.v);
    else
      load_cols<T, C>(row, cols, r.v);
    return r;
  }
  __device__ __forceinline__ void unpack(const Raw& r, float (&v)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = r.v[c];
  }
};

// A row of vertical sums in shared memory.
struct SharedLoader {
  using Raw = float;
  static constexpr bool kPrefetch = false;
  const float* row;
  __device__ __forceinline__ Raw fetch(int m) const { return row[m]; }
  __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) const { v[0] = r; }
};

// Tap i0 + u of a correlation run: raw = x(i0 + u + K - 1) into its ring
// slot, then one multiply-add of each chain.  i0 is a multiple of K and u
// a compile-time constant once the caller's loop is unrolled, so every
// ring index is one too.
template <int K, int C, typename Ld>
__device__ __forceinline__ void ring_step(const Ld& ld, const typename Ld::Raw& raw,
                                          float (&w)[C][K], float (&acc)[C][K],
                                          int u, float t) {
  float v[C];
  ld.unpack(raw, v);
#pragma unroll
  for (int c = 0; c < C; ++c) w[c][(u + K - 1) % K] = v[c];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c][j] = acc[c][j] + t * w[c][(u + j) % K];
}

// One correlation run of K adjacent outputs (times C lanes of columns):
// acc[c][j] = sum_i taps[i] * x(j + i)[c], each chain in tap order.  The
// ring slot of x(m) is m % K.  `taps` lies in shared memory, 16-byte
// aligned and zero-padded to a multiple of K past nt.
//
// NONNEG: every x(m) is finite and >= 0 (uint8 frames and their vertical
// sums).  Then the chains start at +0 and run over whole chunks of K taps,
// the zero taps past nt included: +0 + y == y and acc + 0 * x == acc for
// acc, x >= 0, so each chain keeps the plain version's bits, and the run
// is one loop body.  Otherwise tap 0 starts each chain with a product and
// the last chunk is guarded tap by tap.  Either way a run fetches x(m) for
// m <= roundup(nt, K) + K - 2 at most.
template <int K, int C, bool NONNEG, typename Ld>
__device__ __forceinline__ void corr_run(const Ld& ld, const float* taps, int nt,
                                         float (&acc)[C][K]) {
  using Raw = typename Ld::Raw;
  constexpr bool kPf = Ld::kPrefetch;
  float w[C][K];
  float tk[K];
  Raw buf[K], nxt[K];   // a chunk's x(i0 + u + K - 1), the next chunk's
#pragma unroll
  for (int m = 0; m < K - 1; ++m) {
    float v[C];
    ld.unpack(ld.fetch(m), v);
#pragma unroll
    for (int c = 0; c < C; ++c) w[c][m] = v[c];
  }
  if constexpr (kPf) {
#pragma unroll
    for (int u = 0; u < K; ++u) buf[u] = ld.fetch(u + K - 1);
  }
  int i0 = 0;
  if constexpr (NONNEG) {
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][j] = 0.0f;
  } else {  // taps 0 .. K-1; tap 0 starts each chain with a product
    tap_chunk(taps, 0, tk);
    {
      float v[C];
      ld.unpack(kPf ? buf[0] : ld.fetch(K - 1), v);
#pragma unroll
      for (int c = 0; c < C; ++c) w[c][K - 1] = v[c];
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c][j] = tk[0] * w[c][j];
    if constexpr (kPf) {
      if (K < nt) {
#pragma unroll
        for (int u = 0; u < K; ++u) nxt[u] = ld.fetch(K + u + K - 1);
      }
    }
#pragma unroll
    for (int u = 1; u < K; ++u)
      if (u < nt) ring_step(ld, kPf ? buf[u] : ld.fetch(u + K - 1), w, acc, u, tk[u]);
    if constexpr (kPf) {
#pragma unroll
      for (int u = 0; u < K; ++u) buf[u] = nxt[u];
    }
    i0 = K;
  }
  const int full = NONNEG ? nt : nt - K + 1;   // chunks i0 < full run whole
#pragma unroll 1
  for (; i0 < full; i0 += K) {
    if constexpr (kPf) {
      if (i0 + K < nt) {
#pragma unroll
        for (int u = 0; u < K; ++u) nxt[u] = ld.fetch(i0 + K + u + K - 1);
      }
    }
    tap_chunk(taps, i0, tk);
#pragma unroll
    for (int u = 0; u < K; ++u)
      ring_step(ld, kPf ? buf[u] : ld.fetch(i0 + u + K - 1), w, acc, u, tk[u]);
    if constexpr (kPf) {
#pragma unroll
      for (int u = 0; u < K; ++u) buf[u] = nxt[u];
    }
  }
  if (!NONNEG && i0 < nt) {
    tap_chunk(taps, i0, tk);
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (i0 + u < nt)
        ring_step(ld, kPf ? buf[u] : ld.fetch(i0 + u + K - 1), w, acc, u, tk[u]);
  }
}

// The vertical run of one item: KV rows x CV columns from input row yb
// on, columns x .. x + CV - 1 (VEC: one vector load a row) or cols
// (reflected).
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void vertical_run(const T* img, int H, int W, int x,
                                             const int (&cols)[CV], int yb,
                                             const float* taps, int nt,
                                             float (&acc)[CV][KV]) {
  if constexpr (VEC && sizeof(T) == 1) {
    const WordLoader<ROWS, CV> ld{img, H, W, x, yb};
    corr_run<KV, CV, true>(ld, taps, nt, acc);
  } else {
    const ColumnLoader<T, VEC, ROWS, CV> ld{img, H, W, x, yb, cols};
    corr_run<KV, CV, sizeof(T) == 1>(ld, taps, nt, acc);
  }
}

// Geometry of one launch (the wrapper's tile, kernels/gauss.py:tile).
struct Tile {
  int H, W, ntaps, TY, TX;
  int pitch;     // f32 words of a row of vertical sums (odd)
  int tpad;      // taps staged, a multiple of 8 with zeros past ntaps
  int vec_in;    // rows of the input aligned for 4-column loads
  int vec_out;   // rows of the output aligned for 16-byte stores
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gauss_kernel(const T* __restrict__ src, float* __restrict__ dst,
             const float* __restrict__ taps_g, const Tile t) {
  extern __shared__ float4 smem4[];
  float* taps = reinterpret_cast<float*>(smem4);   // [tpad]
  float* V = taps + t.tpad;                        // [TY][pitch]
  const int H = t.H, W = t.W, nt = t.ntaps, r = t.ntaps / 2;
  const int x0 = blockIdx.x * t.TX;
  const int y0 = blockIdx.y * t.TY;
  const int d = ((x0 - r) % CV + CV) % CV;   // V column 0 is image column xs
  const int xs = x0 - r - d;                 // a multiple of CV
  // words of vertical sums: the columns the horizontal runs read, up to
  // the 7 past the last tap that a whole chunk of 8 zero taps fetches
  const int nw = (d + t.TX + 2 * r + 7 + CV - 1) / CV;
  const T* img = src + static_cast<long long>(blockIdx.z) * H * W;

  for (int i = threadIdx.x; i < t.tpad; i += THREADS)
    taps[i] = i < nt ? taps_g[i] : 0.0f;
  __syncthreads();

  // vertical pass: item (row group g, word q) -> V[g*KV + j][CV*q + c]
  const int groups = t.TY / KV;
  for (int e = threadIdx.x; e < groups * nw; e += THREADS) {
    const int g = e / nw;
    const int q = e - g * nw;
    const int x = xs + CV * q;
    const bool vec = t.vec_in && x >= 0 && x + CV - 1 < W;
    int cols[CV];
#pragma unroll
    for (int c = 0; c < CV; ++c) cols[c] = reflect101(x + c, W);
    const int yb = y0 + g * KV - r;       // input row of x(0)
    const int last = yb + (nt + KV - 1) / KV * KV + KV - 2;   // a run's last row
    float acc[CV][KV];
    if (!vec)   // a word at the frame's left or right edge
      vertical_run<T, false, 2>(img, H, W, x, cols, yb, taps, nt, acc);
    else if (yb >= 0 && last < H)
      vertical_run<T, true, 0>(img, H, W, x, cols, yb, taps, nt, acc);
    else if (H >= 2 && yb >= -(H - 1) && last <= 2 * (H - 1))
      vertical_run<T, true, 1>(img, H, W, x, cols, yb, taps, nt, acc);
    else
      vertical_run<T, true, 2>(img, H, W, x, cols, yb, taps, nt, acc);
#pragma unroll
    for (int j = 0; j < KV; ++j)
#pragma unroll
      for (int c = 0; c < CV; ++c) V[(g * KV + j) * t.pitch + CV * q + c] = acc[c][j];
  }
  __syncthreads();

  // horizontal pass: lane -> row lane % TY; slot (warp, lane / TY) takes
  // chunks of KH adjacent outputs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per_warp = 32 / t.TY;
  const int ly = lane % t.TY;
  const int y = y0 + ly;
  float* out = dst + static_cast<long long>(blockIdx.z) * H * W +
               static_cast<long long>(y) * W;
  const float* vrow = V + ly * t.pitch + d;
  const int chunks = t.TX / KH;
  for (int ch = warp * per_warp + lane / t.TY; ch < chunks; ch += WARPS * per_warp) {
    const int lx0 = ch * KH;
    if (x0 + lx0 >= W) break;
    float acc[1][KH];
    corr_run<KH, 1, sizeof(T) == 1>(SharedLoader{vrow + lx0}, taps, nt, acc);
    if (y >= H) continue;
    const int x = x0 + lx0;
    if (t.vec_out && x + KH <= W) {
      float4* o = reinterpret_cast<float4*>(out + x);
#pragma unroll
      for (int k = 0; k < KH; k += 4)
        o[k / 4] = make_float4(acc[0][k], acc[0][k + 1], acc[0][k + 2], acc[0][k + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < KH; ++j)
        if (x + j < W) out[x + j] = acc[0][j];
    }
  }
}

Tile make_tile(int H, int W, int ntaps, int ty, int tx) {
  const int r = ntaps / 2;
  Tile t;
  t.H = H;
  t.W = W;
  t.ntaps = ntaps;
  t.TY = ty;
  t.TX = tx;
  t.pitch = 4 * ((3 + tx + 2 * r + 7 + 3) / 4) + 1;
  t.tpad = (ntaps + 7) / 8 * 8 + 8;
  t.vec_in = 0;
  t.vec_out = 0;
  return t;
}

size_t smem_bytes(const Tile& t) {
  return sizeof(float) * (t.tpad + static_cast<size_t>(t.TY) * t.pitch);
}

template <typename T>
int launch(const void* src, float* dst, int n, const float* taps, Tile t,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(t);
  cudaError_t err = cudaFuncSetAttribute(
      gauss_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t.W + t.TX - 1) / t.TX, (t.H + t.TY - 1) / t.TY, n);
  gauss_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(src), dst, taps, t);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int ntaps, int ty, int tx) {
  return ntaps >= 1 && ntaps % 2 == 1 && (ty == 32 || ty == 16) && tx >= 64 &&
         tx % 64 == 0;
}

}  // namespace

// src: (n, H, W) uint8 (src_u8 != 0) or f32; dst: (n, H, W) f32, not src.
// taps: ntaps (odd) f32 on the device.  ty, tx: output rows (32 or 16)
// and columns (a multiple of 64) per block, whose shared memory the
// wrapper has checked (kernels/gauss.py:tile).  Returns a cudaError_t.
extern "C" int oft_gauss(const void* src, int src_u8, float* dst, int n,
                         int H, int W, const float* taps, int ntaps, int ty,
                         int tx, int device, void* stream) {
  if (!valid(ntaps, ty, tx) || n < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  Tile t = make_tile(H, W, ntaps, ty, tx);
  t.vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(src) % (src_u8 ? 4 : 16) == 0;
  t.vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (src_u8) return launch<uint8_t>(src, dst, n, taps, t, st);
  return launch<float>(src, dst, n, taps, t, st);
}

// The dynamic shared memory of a block of the (ntaps, ty, tx) tile and the
// blocks of it resident on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int oft_gauss_occupancy(int src_u8, int ntaps, int ty, int tx,
                                   int device, int* blocks, int* smem) {
  if (!valid(ntaps, ty, tx)) return static_cast<int>(cudaErrorInvalidValue);
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(smem_bytes(make_tile(1, 1, ntaps, ty, tx)));
  *smem = bytes;
  if (src_u8) {
    err = cudaFuncSetAttribute(gauss_kernel<uint8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gauss_kernel<uint8_t>, THREADS, bytes);
  } else {
    err = cudaFuncSetAttribute(gauss_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, gauss_kernel<float>, THREADS, bytes);
  }
  return static_cast<int>(err);
}
