// K2: Farnebäck polynomial expansion (FarnebackPolyExp), with an optional
// 3-tap REFLECT_101 pre-smooth for pyramid level 0.
//
// Replaces the Pallas kernels of optical_flow_tpu/pallas/polyexp.py
// (poly_exp_pallas_store and poly_exp_pallas): R = (b_y, b_x, a_yy, a_xx,
// a_xy) per pixel from the (2n+1)^2 neighbourhood under replicate borders,
// via separable g, x*g and x^2*g correlations combined by the inverse-Gram
// entries.
//
// What bounds it: the 20 B/px of R written to device memory (against 1 or
// 4 B/px read), 0.42 ms at level 0 of a 1080p B=16 call; the 18 (2n+1)
// multiplies and adds a pixel, unfused (--fmad=false), come close behind.
// A block of 256 threads takes a TX x TY output tile (sized per poly_n by
// the wrapper: 128 x 16 at poly_n 5 and 1080p) and:
//   1. stages the raw band once in shared memory: the tile's unique image
//      rows and columns plus the n-pixel replicate halo, and with the
//      pre-smooth its 1-pixel REFLECT_101 ring, with 16-byte loads where
//      the frame's rows are aligned and a group lies inside the image,
//      scalar loads elsewhere (RAW; see below);
//   2. with the pre-smooth, runs it there in staged_value's order: the
//      three vertical taps of every band column, then the three
//      horizontal ones, four columns a thread, so each staged value S is
//      made once, from values on the chip (the former kernel made 9 scalar
//      byte loads from device memory per staged value, 2.13 staged values
//      per output);
//   3. the three vertical correlations of each output row at each of the
//      TX + 2n staged columns, four rows a thread from one sliding run of
//      S (polyexp.cuh:vertical_run), into V;
//   4. the six horizontal correlations, four adjacent outputs a thread
//      (horizontal_run), the combine, and R's five planes written with
//      16-byte stores where aligned.
// The vertical pass computes (TX + 2n) / TX of the columns it needs (1.08
// at 128 x 16, n = 5; the former 32 x 16 tile: 1.31); each output's chains
// stay in the plain version's tap order.  At cv2's poly_n 5 and 7 the
// kernel is compiled for that n, so both passes unroll with the taps as
// constant operands.

// Border: S holds the tile's *unique* image rows ylo..yhi and columns
// xlo..xhi (the halo clamped into the image); a staged position outside
// the image reads S at the clamped pixel, so the replicate border of the
// expansion repeats the *smoothed* edge.  With the pre-smooth, band row j
// holds image row reflect101(ylo - 1 + j): staged row clamp(y) takes band
// rows at reflect101(clamp(y) - 1), clamp(y), reflect101(clamp(y) + 1),
// as staged_value does (and the same for columns).
//
// Shared memory: S, then the band and the pre-smooth's vertical sums P,
// which V later reuses.  Where the band does not fit beside S (poly_n far
// beyond cv2's 5 and 7), RAW is off and S is made by staged_value from
// device memory, as before: any poly_n <= 96 runs (kernels/polyexp.py:
// k2_fits and _tile mirror this layout).  The taps travel by value in the
// launch's parameters (2.3 KB at n = 96), where a tap is a constant-cache
// load; from shared memory K2 took 7 % longer (PERF.md, PR 4).  The
// arithmetic is polyexp.cuh's, which K7 shares; it follows the plain
// version op for op (--fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyexp.cuh"

namespace {

using oft::PolyConsts;

constexpr int kMaxN = oft::kPolyMaxN;     // the largest n the constants hold
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int K = 4;                      // adjacent outputs a thread, both passes
constexpr int U = 4;                      // band rows a warp keeps in flight

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_len() {
  return 16 / static_cast<int>(sizeof(T));
}

// The block's shared-memory layout, from the tile and n (mirrored by
// kernels/polyexp.py:_smem), nc = TX + 2n.  S: [TY + 2n][nc rounded up to
// 4] floats, or, for an f32 band without the pre-smooth, the band itself;
// band: [TY + 2n + 2e][band_stride] T, e = 1 with the pre-smooth; P:
// [TY + 2n][band_stride] floats and 4 spare; V: [3][TY][nc + 1] floats over
// the band and P.
struct Layout {
  int s_stride, band_stride, vs;
  size_t s_bytes, band_off, p_off, v_off, total;
};

template <typename T, bool PRE, bool RAW>
__host__ __device__ Layout layout(int n, int TX, int TY) {
  constexpr int V = vec_len<T>();
  const int e = PRE ? 1 : 0;
  const int nc = TX + 2 * n;
  const int nr = TY + 2 * n;
  Layout L;
  L.vs = nc + 1;   // odd (nc is even): see step 4
  L.band_stride = V * ((V - 1 + nc + 2 * e + V - 1) / V);
  const bool s_is_band = RAW && !PRE && sizeof(T) == 4;
  L.s_stride = s_is_band ? L.band_stride : (nc + 3) / 4 * 4;
  L.s_bytes = s_is_band ? 0 : sizeof(float) * nr * L.s_stride;
  const size_t v_bytes = sizeof(float) * 3 * TY * L.vs;
  L.band_off = L.s_bytes;
  const size_t band_bytes = RAW ? sizeof(T) * (nr + 2 * e) * L.band_stride : 0;
  L.p_off = L.band_off + band_bytes;
  const size_t p_bytes = (RAW && PRE) ? sizeof(float) * (nr * L.band_stride + 4) : 0;
  // V reuses the band and P, except where S is the band
  L.v_off = s_is_band ? L.p_off : L.band_off;
  const size_t v_end = L.v_off + v_bytes;
  const size_t bp_end = L.p_off + p_bytes;
  L.total = v_end > bp_end ? v_end : bp_end;
  return L;
}

// A byte b as a float: (2^23 + b) - 2^23, exact, without a conversion
// instruction.
__device__ __forceinline__ float to_float(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}
__device__ __forceinline__ float to_float(float v) { return v; }

// Four adjacent band values at p (4-element aligned) as floats, from one
// 4- or 16-byte read.
__device__ __forceinline__ void load4(const uint8_t* p, float (&v)[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) - 8388608.0f;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// PRE: the 3-tap pre-smooth first.  RAW: the band is staged in shared
// memory; else S comes from staged_value on device memory.  NT: n known at
// compile time (cv2's poly_n 5 and 7), so that both correlation passes
// unroll with the taps as constant operands; 0: n from the launch.
template <typename T, bool PRE, bool RAW, int NT>
__global__ void __launch_bounds__(kThreads)
polyexp_kernel(const void* __restrict__ src_v, float* __restrict__ R, int H, int W,
               int n_arg, int TX, int TY, int in_aligned, int out_aligned,
               const __grid_constant__ PolyConsts c) {
  constexpr int VL = vec_len<T>();
  constexpr int e = PRE ? 1 : 0;
  constexpr int NTAPS = NT ? 2 * NT + 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = NT ? NT : n_arg;
  const T* src = static_cast<const T*>(src_v);
  const Layout L = layout<T, PRE, RAW>(n, TX, TY);
  const int taps = 2 * n + 1;
  const int nc = TX + 2 * n;                 // staged columns of the tile
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  // the tile's unique image rows [ylo, yhi] and columns [xlo, xhi]
  const int ylo = oft::clampi(y0 - n, 0, H - 1);
  const int yhi = oft::clampi(y0 + TY + n - 1, 0, H - 1);
  const int xlo = oft::clampi(x0 - n, 0, W - 1);
  const int xhi = oft::clampi(x0 + TX + n - 1, 0, W - 1);
  const int nuy = yhi - ylo + 1;
  const int nux = xhi - xlo + 1;
  // band column k holds image column xs + k: xs is xlo - e rounded down
  // to a vector boundary, so that vector loads stay aligned
  const int xb = xlo - e;
  const int xs = xb - (((xb % VL) + VL) % VL);
  const int koff = xb - xs;
  const long long plane = static_cast<long long>(H) * W;
  const T* img = src + blockIdx.z * plane;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  T* band = reinterpret_cast<T*>(smem + L.band_off);
  float* P = reinterpret_cast<float*>(smem + L.p_off);
  float* S = reinterpret_cast<float*>(smem);
  int s_off = 0;                             // S[i][j] at S[s_off + i * s_stride + j]
  if (RAW && !PRE && sizeof(T) == 4) {
    S = reinterpret_cast<float*>(band);
    s_off = koff;
  }
  float* Vb = reinterpret_cast<float*>(smem + L.v_off);

  if (RAW) {
    // 1. the band: rows ylo - e .. yhi + e, columns xlo - e .. xhi + e
    // (reflected with the pre-smooth; every one inside the image without)
    const int brows = nuy + 2 * e;
    const int ngroups = (koff + nux + 2 * e + VL - 1) / VL;
    if (!in_aligned) {   // a lane per column
      for (int j = warp; j < brows; j += kWarps) {
        const int y = PRE ? oft::reflect101(ylo - 1 + j, H) : ylo + j;
        const T* row = img + static_cast<long long>(y) * W;
        for (int i = lane; i < nux + 2 * e; i += 32)
          band[j * L.band_stride + koff + i] = row[PRE ? oft::reflect101(xb + i, W) : xb + i];
      }
    }
    for (int j0 = warp; in_aligned && j0 < brows; j0 += U * kWarps) {
      for (int gi = lane; gi < ngroups; gi += 32) {
        const int x = xs + VL * gi;
        const bool vec = in_aligned && x >= 0 && x + VL <= W;
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * kWarps;
          if (j < brows && vec) {
            const int y = PRE ? oft::reflect101(ylo - 1 + j, H) : ylo + j;
            v[u] = *reinterpret_cast<const uint4*>(img + static_cast<long long>(y) * W + x);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * kWarps;
          if (j >= brows) continue;
          T* out = band + j * L.band_stride + VL * gi;
          if (vec) {
            *reinterpret_cast<uint4*>(out) = v[u];
          } else {
            const int y = PRE ? oft::reflect101(ylo - 1 + j, H) : ylo + j;
            const T* row = img + static_cast<long long>(y) * W;
            for (int i = 0; i < VL; ++i) {
              const int xx = x + i;
              out[i] = (xx >= xb && xx <= xhi + e)
                           ? row[PRE ? oft::reflect101(xx, W) : xx] : T(0);
            }
          }
        }
      }
    }
    __syncthreads();
    if (PRE) {
      // 2a. the pre-smooth's vertical taps at every band column it needs,
      // four columns a thread: a thread's three reads are issued together.
      // Items (i, q) of nuy x pg are stepped without a division.
      const int pg = (koff + nux + 2 + 3) / 4;
      const int di = kThreads / pg, dq = kThreads - di * pg;
      for (int i = tid / pg, q = tid - i * pg; i < nuy;) {
        const T* b = band + i * L.band_stride + 4 * q;
        float r0[4], r1[4], r2[4], a[4];
        load4(b, r0);
        load4(b + L.band_stride, r1);
        load4(b + 2 * L.band_stride, r2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = c.pre[0] * r0[j];
          a[j] = a[j] + c.pre[1] * r1[j];
          a[j] = a[j] + c.pre[2] * r2[j];
        }
        *reinterpret_cast<float4*>(P + i * L.band_stride + 4 * q) =
            make_float4(a[0], a[1], a[2], a[3]);
        i += di;
        q += dq;
        if (q >= pg) q -= pg, ++i;
      }
      __syncthreads();
      // 2b. then its horizontal taps: S, four columns a thread
      const int sg = (nux + 3) / 4;
      const int ei = kThreads / sg, eq = kThreads - ei * sg;
      for (int i = tid / sg, q = tid - i * sg; i < nuy;) {
        const float* p = P + i * L.band_stride + koff + 4 * q;
        float v[6], o[4];
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = p[j];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = c.pre[0] * v[j];
          o[j] = o[j] + c.pre[1] * v[j + 1];
          o[j] = o[j] + c.pre[2] * v[j + 2];
        }
        *reinterpret_cast<float4*>(S + i * L.s_stride + 4 * q) =
            make_float4(o[0], o[1], o[2], o[3]);
        i += ei;
        q += eq;
        if (q >= sg) q -= sg, ++i;
      }
      __syncthreads();
    } else if (sizeof(T) == 1) {
      for (int i = warp; i < nuy; i += kWarps)
        for (int j = lane; j < nux; j += 32)
          S[i * L.s_stride + j] = to_float(band[i * L.band_stride + koff + j]);
      __syncthreads();
    }
  } else {
    for (int i = warp; i < nuy; i += kWarps)
      for (int j = lane; j < nux; j += 32)
        S[i * L.s_stride + j] = oft::staged_value<T, PRE>(img, ylo + i, xlo + j, H, W, c);
    __syncthreads();
  }

  // 3. the vertical correlations of output rows ly .. ly + K - 1 at staged
  // column lx (image column clamp(x0 - n + lx)); staged row l is image row
  // clamp(y0 - n + l), S row clamp(y0 - n + l) - ylo, which is l itself in
  // a tile whose rows and halo lie inside the image.  Thread tid takes
  // items tid, tid + kThreads, ... of (TY / K) x nc, stepped without a
  // division.
  const bool inside = y0 - n >= 0 && y0 + TY + n <= H;
  for (int rg = tid / nc, lx = tid - rg * nc; K * rg < TY; ) {
    const int ly = K * rg;
    if (y0 + ly >= H) break;
    const float* col = S + s_off + (oft::clampi(x0 - n + lx, 0, W - 1) - xlo);
    float a0[K], a1[K], a2[K];
    if (inside) {
      const float* p = col + ly * L.s_stride;
      oft::vertical_run<K, NTAPS>([&](int q) { return p[q * L.s_stride]; }, taps, c,
                                  a0, a1, a2);
    } else {
      const int ybase = y0 - n + ly;
      oft::vertical_run<K, NTAPS>(
          [&](int q) {
            return col[(oft::clampi(ybase + q, 0, H - 1) - ylo) * L.s_stride];
          },
          taps, c, a0, a1, a2);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      Vb[(0 * TY + ly + j) * L.vs + lx] = a0[j];
      Vb[(1 * TY + ly + j) * L.vs + lx] = a1[j];
      Vb[(2 * TY + ly + j) * L.vs + lx] = a2[j];
    }
    for (lx += kThreads; lx >= nc; lx -= nc) ++rg;
  }
  __syncthreads();

  // 4. the horizontal correlations of outputs x0 + K g .. + K - 1 on row
  // ly: staged columns K g .. K g + 2n + K - 1.  A warp takes 4 rows x 32
  // columns, lane >> 3 the row and lane & 7 the group of K: with V's odd
  // row stride its 32 reads fall on 32 banks, and each row's 8 lanes
  // store 128 contiguous bytes a plane
  const int lg = __ffs(TX / 32) - 1;       // TX / 32 is 1, 2 or 4
  for (int task = warp; task < (TY / 4) << lg; task += kWarps) {
    const int ly = 4 * (task >> lg) + (lane >> 3);
    const int g = 8 * (task & ((1 << lg) - 1)) + (lane & 7);
    const int y = y0 + ly;
    const int ox = x0 + K * g;
    if (y >= H || ox >= W) continue;
    const float* v0 = Vb + (0 * TY + ly) * L.vs;
    const float* v1 = Vb + (1 * TY + ly) * L.vs;
    const float* v2 = Vb + (2 * TY + ly) * L.vs;
    oft::HSums s[K];
    oft::horizontal_run<K, NTAPS>(
        [&](int q, float& r0, float& r1, float& r2) {
          r0 = v0[K * g + q];
          r1 = v1[K * g + q];
          r2 = v2[K * g + q];
        },
        taps, c, s);
    float rv[K][5];
#pragma unroll
    for (int j = 0; j < K; ++j) oft::combine(s[j], c, rv[j]);
    float* out = R + blockIdx.z * 5 * plane + static_cast<long long>(y) * W + ox;
    if (out_aligned) {
#pragma unroll
      for (int k = 0; k < 5; ++k)
        *reinterpret_cast<float4*>(out + k * plane) =
            make_float4(rv[0][k], rv[1][k], rv[2][k], rv[3][k]);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (ox + j >= W) break;
#pragma unroll
        for (int k = 0; k < 5; ++k) out[k * plane + j] = rv[j][k];
      }
    }
  }
}

using KernelFn = void (*)(const void*, float*, int, int, int, int, int, int, int,
                         const PolyConsts);

template <typename T, bool PRE, bool RAW>
KernelFn pick_n(int n) {
  if constexpr (RAW) {
    if (n == 5) return polyexp_kernel<T, PRE, RAW, 5>;
    if (n == 7) return polyexp_kernel<T, PRE, RAW, 7>;
  }
  return polyexp_kernel<T, PRE, RAW, 0>;
}

// The kernel for a launch and its shared memory, into *fn and *bytes.
template <typename T>
void pick(bool pre, bool raw, int n, int TX, int TY, KernelFn* fn, size_t* bytes) {
  if (pre && raw) {
    *fn = pick_n<T, true, true>(n);
    *bytes = layout<T, true, true>(n, TX, TY).total;
  } else if (pre) {
    *fn = pick_n<T, true, false>(n);
    *bytes = layout<T, true, false>(n, TX, TY).total;
  } else if (raw) {
    *fn = pick_n<T, false, true>(n);
    *bytes = layout<T, false, true>(n, TX, TY).total;
  } else {
    *fn = pick_n<T, false, false>(n);
    *bytes = layout<T, false, false>(n, TX, TY).total;
  }
}

// tile: (TX, TY, raw); 0 where the tile is valid for n.
int pick_checked(int src_u8, int pre, int n, const int* tile, KernelFn* fn,
                 size_t* bytes) {
  const int TX = tile[0], TY = tile[1], raw = tile[2];
  if (n < 1 || n > kMaxN || (TX != 32 && TX != 64 && TX != 128) || TY < 4 || TY % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (src_u8)
    pick<uint8_t>(pre != 0, raw != 0, n, TX, TY, fn, bytes);
  else
    pick<float>(pre != 0, raw != 0, n, TX, TY, fn, bytes);
  return 0;
}

}  // namespace

// src: (nimg, H, W) uint8 (src_u8 != 0) or f32; R: (nimg, 5, H, W) f32.
// consts: host array [g, xg, xxg (2n+1 each), pre (3), ig11, ig03, ig33,
// ig55]; pre is used when pre != 0.  tile: host array (TX, TY, raw) from
// the wrapper: the output tile (TX 32, 64 or 128, TY a multiple of 4) and whether
// the band is staged in shared memory.  in_aligned != 0: src and every
// frame row start on a 16-byte boundary; out_aligned: the same for R.
// Returns a cudaError_t.
extern "C" int oft_polyexp(const void* src, int src_u8, float* R, int nimg,
                           int H, int W, int n, const float* consts, int pre,
                           const int* tile, int in_aligned, int out_aligned,
                           int device, void* stream) {
  KernelFn fn;
  size_t smem;
  int rc = pick_checked(src_u8, pre, n, tile, &fn, &smem);
  if (rc != 0) return rc;
  const oft::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const PolyConsts c = oft::poly_consts(consts, n);
  int TX = tile[0], TY = tile[1];
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, nimg);
  void* args[] = {&src, &R, &H, &W, &n, &TX, &TY,
                  &in_aligned, &out_aligned, const_cast<PolyConsts*>(&c)};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(fn), grid,
                                           dim3(kThreads), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}
