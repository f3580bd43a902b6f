"""The index maps of the redesigned K2, K5b, K6, K4 and K7, emulated in numpy
on the CPU.

No CUDA kernel runs here, so these tests repeat what each kernel does with
its indices, in numpy f32 with each chain in tap order, and hold the
result to the plain versions (`core.poly_exp`, `core.blur_solve`) to the
bit, on small frames whose tiles and strips meet every border:

- K2 (`csrc/polyexp.cu`): per output tile, the band of the tile's unique
  image rows and columns with the pre-smooth's reflected ring (band row j
  = image row reflect101(ylo - 1 + j)), the pre-smooth's vertical then
  horizontal taps, staged rows and columns read at clamp(...) - ylo, the
  vertical correlations, the horizontal ones, the combine.
- K5b (`csrc/blur_solve.cu`, the strip kernel): per strip of columns,
  blocks of rows, M staged G rows a pass from the 4-aligned column at or
  left of x0 - m (clamped), each row's horizontal sums into a ring of
  2m + G rows at slot (y - y0 + m) mod R, each output row's vertical sum
  from the ring, the solve.
- K6 (`csrc/gauss.cu`): per block of `gauss.tile`'s rows and columns, the
  4-aligned column span that the horizontal taps reach (word loads where
  the word lies in the frame, reflected scalar columns elsewhere), the
  reflected rows, the vertical run of 8 rows x 4 columns a thread and the
  horizontal run of 8 outputs a lane from a ring whose slot is m % 8,
  taps in chunks of 8 zero-padded past the count.
- K4 (`csrc/colorize.cu`): the launch plan, per frame of each group the
  slices of 4-pixel quads (the ragged last quad), the magnitudes and hues
  kept on chip up to the cache's capacity and recomputed past it, the
  per-block (min, max) pairs folded after every block of the frame has
  published, then the map.
- K7 (`csrc/update_blur_poly.cu`): per output tile, the unique M rows and
  columns of the tile plus the window's halo, img0 staged over them plus
  the expansion's halo, the fetch targets of the inside pixels reduced to
  their bounding box and the anchor, R0's vertical sums in bands of the
  rows the region holds (or R0 per pixel where not one row fits), the
  box cut to the region (`fit_box`), img1 staged over it and its vertical
  sums, R1 per M pixel from the box or from its own window (the
  per-pixel path), M over R0, the out-of-image entries from their clamped
  pixels, the window sum and the solve.
"""

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch.kernels import blur_solve as k5b
from optical_flow_tpu_torch.kernels import gauss as k6
from optical_flow_tpu_torch.kernels import polyexp as k2
from optical_flow_tpu_torch.kernels import resample
from optical_flow_tpu_torch.kernels import update_gather as k7
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.ops import colorize, resize
from optical_flow_tpu_torch.ops.color import hsv2bgr_planes
from optical_flow_tpu_torch.ops.polar import fast_atan2_deg, magnitude
from optical_flow_tpu_torch.oracle.synthetic import (smooth_texture_pair,
                                                     vertical_jump_pair)
from optical_flow_tpu_torch.models.farneback.params import (gaussian_kernel,
                                                            poly_exp_weights)

f32 = np.float32


def _reflect101(i, n):
    i = abs(i)
    return 2 * (n - 1) - i if i >= n else i


def _chain(taps, values):
    """taps[0] * values[0] + taps[1] * values[1] + ..., in that order."""
    acc = f32(taps[0]) * values[0]
    for t, v in zip(taps[1:], values[1:]):
        acc = acc + f32(t) * v
    return acc


def emulate_k2(img, poly_n, poly_sigma, pre_taps, tx, ty):
    """K2's tiles on one (H, W) frame -> R (5, H, W) f32."""
    n = poly_n
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(n, poly_sigma)
    ig11, ig03, ig33, ig55 = (f32(v) for v in (ig11, ig03, ig33, ig55))
    H, W = img.shape
    pre = pre_taps is not None
    e = 1 if pre else 0
    R = np.zeros((5, H, W), f32)
    for y0 in range(0, H, ty):
        for x0 in range(0, W, tx):
            ylo, yhi = np.clip([y0 - n, y0 + ty + n - 1], 0, H - 1)
            xlo, xhi = np.clip([x0 - n, x0 + tx + n - 1], 0, W - 1)
            nuy, nux = yhi - ylo + 1, xhi - xlo + 1
            brow = [_reflect101(ylo - 1 + j, H) if pre else ylo + j
                    for j in range(nuy + 2 * e)]
            bcol = [_reflect101(xlo - 1 + i, W) if pre else xlo + i
                    for i in range(nux + 2 * e)]
            band = img[np.ix_(brow, bcol)].astype(f32)
            if pre:
                P = _chain(pre_taps, [band[j:j + nuy] for j in range(3)])
                S = _chain(pre_taps, [P[:, i:i + nux] for i in range(3)])
            else:
                S = band
            rows = np.clip(y0 - n + np.arange(ty + 2 * n), 0, H - 1) - ylo
            cols = np.clip(x0 - n + np.arange(tx + 2 * n), 0, W - 1) - xlo
            St = S[np.ix_(rows, cols)]
            v = [_chain(t, [St[k:k + ty] for k in range(2 * n + 1)]) for t in (g, xg, xxg)]

            def h(t, r):
                return _chain(t, [r[:, k:k + tx] for k in range(2 * n + 1)])

            b1, b2, b3 = h(g, v[0]), h(xg, v[0]), h(g, v[1])
            b4, b5, b6 = h(xxg, v[0]), h(g, v[2]), h(xg, v[1])
            out = np.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                            b1 * ig03 + b4 * ig33, b6 * ig55])
            hh, ww = min(ty, H - y0), min(tx, W - x0)
            R[:, y0:y0 + hh, x0:x0 + ww] = out[:, :hh, :ww]
    return R


def emulate_k5b(M, winsize, gaussian, sw, G, rows_per_block):
    """K5b's strip kernel on one (5, H, W) M -> flow (2, H, W) f32."""
    m = winsize // 2
    taps = (core.gaussian_window_kernel(winsize) if gaussian
            else np.ones(2 * m + 1, f32))
    scale = f32(1.0) if gaussian else f32(1.0 / (winsize * winsize))
    _, H, W = M.shape
    R = 2 * m + G
    groups = (sw + 2 * m + 6) // 4

    def sums(values):
        # the box adds the values themselves (1 * v == v)
        if gaussian:
            return _chain(taps, values)
        acc = values[0]
        for v in values[1:]:
            acc = acc + v
        return acc

    flow = np.zeros((2, H, W), f32)
    for x0 in range(0, W, sw):
        d = (x0 - m) % 4
        xs = x0 - m - d
        cols = np.clip(xs + np.arange(4 * groups), 0, W - 1)
        for y0 in range(0, H, rows_per_block):
            y_end = min(y0 + rows_per_block, H)
            ring = np.full((5, R, sw), np.nan, f32)

            def build_rows(ya, n):
                for r in range(n):
                    staged = M[:, min(max(ya + r, 0), H - 1)][:, cols]
                    ring[:, (ya + r - y0 + m) % R] = sums(
                        [staged[:, d + i:d + i + sw] for i in range(2 * m + 1)])

            for ya in range(y0 - m, y0 + m, G):
                build_rows(ya, min(G, y0 + m - ya))
            for yg in range(y0, y_end, G):
                build_rows(yg + m, min(G, y_end - yg))
                for y in range(yg, min(yg + G, y_end)):
                    slot = (y - y0) % R
                    s = sums([ring[:, (slot + i) % R] for i in range(2 * m + 1)]) * scale
                    idet = f32(1.0) / (s[0] * s[2] - s[1] * s[1] + f32(1e-3))
                    ww = min(sw, W - x0)
                    flow[0, y, x0:x0 + ww] = ((s[0] * s[4] - s[1] * s[3]) * idet)[:ww]
                    flow[1, y, x0:x0 + ww] = ((s[2] * s[3] - s[1] * s[4]) * idet)[:ww]
    return flow


K2_CASES = [
    # (h, w, poly_n, uint8 with the pre-smooth, tile)
    (2, 2, 1, True, (4, 4)), (3, 2, 2, True, (4, 4)), (2, 3, 5, True, (8, 4)),
    (3, 7, 5, False, (4, 4)), (9, 11, 5, True, (8, 4)), (13, 6, 7, True, (4, 8)),
    (21, 19, 2, True, (8, 8)), (19, 21, 5, False, (8, 4)), (17, 37, 5, True, None),
    (37, 17, 5, False, None), (16, 33, 11, True, None), (7, 5, 11, True, (4, 4)),
]


@pytest.mark.parametrize("h,w,poly_n,u8,tile", K2_CASES)
def test_k2_tiles_equal_plain(h, w, poly_n, u8, tile):
    """Small frames, tiles smaller than the halo, frames narrower than it:
    the tiles' band, pre-smooth and correlation index maps give the plain
    version's R to the bit."""
    rng = np.random.default_rng(h * 100 + w)
    if u8:
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        pre = gaussian_kernel(3, 0.0)
    else:
        img = rng.standard_normal((h, w)).astype(f32) * 40
        pre = None
    if tile is None:
        tile = k2._tile(poly_n, w, img.itemsize, pre is not None)[:2]
    got = emulate_k2(img, poly_n, 1.2, pre, *tile)
    ref = core.poly_exp(torch.as_tensor(img), poly_n, 1.2, pre).numpy()
    np.testing.assert_array_equal(got, ref)


def test_k2_band_rows_reflect_the_clamped_row():
    """The rows of K2's band at the top and bottom borders: a staged row
    above the frame reads the pre-smoothed row 0, made from rows 1, 0, 1
    (reflect101 of clamp), not from a clamped or a reflected raw row."""
    H, n = 6, 5
    ylo, yhi = np.clip([0 - n, 0 + 16 + n - 1], 0, H - 1)
    band = [_reflect101(ylo - 1 + j, H) for j in range(yhi - ylo + 3)]
    assert band == [1, 0, 1, 2, 3, 4, 5, 4]
    staged = np.clip(-n + np.arange(16 + 2 * n), 0, H - 1) - ylo
    assert list(staged[:n + 1]) == [0] * (n + 1)
    assert [band[s:s + 3] for s in (0, 5)] == [[1, 0, 1], [4, 5, 4]]


K5B_CASES = [
    # (h, w, winsize, gaussian, strip width, G, rows per block)
    (5, 7, 1, False, 8, 4, 4), (6, 9, 2, True, 8, 4, 8), (7, 5, 3, False, 4, 4, 4),
    (11, 13, 15, False, 8, 4, 4), (11, 13, 15, True, 8, 4, 8),
    (9, 38, 9, True, 32, 16, 16), (40, 37, 63, False, 32, 16, 16),
    (40, 37, 63, True, 32, 16, 32), (21, 70, 21, False, 32, 16, 16),
    (3, 2, 64, False, 32, 16, 16), (70, 40, 63, False, 32, 32, 32),
    (70, 40, 63, True, 32, 32, 64), (45, 66, 15, True, 32, 32, 32),
]


@pytest.mark.parametrize("h,w,winsize,gaussian,sw,G,rows", K5B_CASES)
def test_k5b_strip_equals_plain(h, w, winsize, gaussian, sw, G, rows):
    """Strips, row blocks and passes that meet the frame's edges, windows
    larger than the frame: the staged columns, the ring's slots and the
    chains give the plain version's flow to the bit."""
    rng = np.random.default_rng(winsize * 7 + w)
    M = (rng.standard_normal((5, h, w)) * 3).astype(f32)
    M[0] = np.abs(M[0]) + 1
    M[2] = np.abs(M[2]) + 1
    got = emulate_k5b(M, winsize, gaussian, sw, G, rows)
    ref = core.blur_solve(torch.as_tensor(M)[None], winsize, gaussian)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def _reflect101_any(i, n):
    """REFLECT_101 with any number of reflections (csrc/gauss.cu)."""
    if 0 <= i < n:
        return i
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = abs(i) % period
    return period - i if i >= n else i


def corr_run(ld, taps, nt, K=8, prefetch=False, nonneg=False):
    """K6's correlation run: K chains acc[j] = sum_i taps[i] * x(j + i) in
    tap order, x(m) = ld(m) kept in ring slot m % K; the taps in chunks of
    K (zero-padded past nt).  `nonneg` (uint8 frames): the chains start at
    +0 and every chunk runs whole; else the first tap is a product and the
    last chunk is guarded.  With `prefetch`, each chunk's values are fetched
    a chunk ahead, as the kernel's word loader does."""
    w = [ld(m) for m in range(K - 1)] + [None]
    tk = np.asarray(taps, f32)

    def step(u, x, t):
        w[(u + K - 1) % K] = x
        for j in range(K):
            acc[j] = acc[j] + f32(t) * w[(u + j) % K]

    def chunk(i0):
        return [ld(i0 + u + K - 1) for u in range(K)]

    buf = chunk(0) if prefetch else None
    i0 = 0
    if nonneg:
        acc = [f32(0.0) * w[0] for _ in range(K)]
    else:
        w[K - 1] = buf[0] if prefetch else ld(K - 1)
        acc = [f32(taps[0]) * w[j] for j in range(K)]
        nxt = chunk(K) if prefetch and K < nt else None
        for u in range(1, K):
            if u < nt:
                step(u, buf[u] if prefetch else ld(u + K - 1), tk[u])
        buf = nxt
        i0 = K
    full = nt if nonneg else nt - K + 1
    while i0 < full:
        nxt = chunk(i0 + K) if prefetch and i0 + K < nt else None
        for u in range(K):
            step(u, buf[u] if prefetch else ld(i0 + u + K - 1), tk[i0 + u])
        buf = nxt
        i0 += K
    if not nonneg and i0 < nt:
        for u in range(K):
            if i0 + u < nt:
                step(u, buf[u] if prefetch else ld(i0 + u + K - 1), tk[i0 + u])
    return acc


def emulate_k6(img, taps, ty, tx, cv=4):
    """K6's blocks on one (H, W) frame -> (H, W) f32, and how many times
    each output was written; `cv` columns a thread in the vertical pass
    (CV in csrc/gauss.cu)."""
    H, W = img.shape
    nt, r = len(taps), len(taps) // 2
    tpad = np.zeros((nt + 7) // 8 * 8 + 8, f32)
    tpad[:nt] = taps
    vec_in = W % 4 == 0
    out = np.full((H, W), np.nan, f32)
    writes = np.zeros((H, W), np.int32)
    pitch = (k6.smem_bytes(nt, ty, tx) // 4 - len(tpad)) // ty
    for y0 in range(0, H, ty):
        for x0 in range(0, W, tx):
            d = (x0 - r) % cv
            xs = x0 - r - d
            nw = (d + tx + 2 * r + 7 + cv - 1) // cv
            assert cv * nw < pitch and pitch % 2 == 1
            V = np.full((ty, pitch), np.nan, f32)
            # vertical pass: item (group g, word q), 8 rows x cv columns
            for g in range(ty // 8):
                yb = y0 + 8 * g - r
                last = yb + (nt + 7) // 8 * 8 + 8 - 2    # a run's last row
                if yb >= 0 and last < H:
                    mode = 0
                elif H >= 2 and yb >= -(H - 1) and last <= 2 * (H - 1):
                    mode = 1
                else:
                    mode = 2
                words = []
                for q in range(nw):
                    x = xs + cv * q
                    vec = vec_in and x >= 0 and x + cv - 1 < W
                    words.append([x + c if vec else _reflect101_any(x + c, W)
                                  for c in range(cv)])
                cols = np.asarray(words)          # (nw, cv)

                def ld(m, yb=yb, mode=mode, cols=cols):
                    # the kernel's source_row: no reflection, one (without
                    # a branch), or any number; edge words take the last
                    y = yb + m
                    if mode == 1:
                        y = min(abs(y), 2 * (H - 1) - abs(y))
                    elif mode == 2:
                        y = _reflect101_any(y, H)
                    assert 0 <= y < H
                    return img[y][cols].astype(f32)

                u8 = img.dtype == np.uint8
                acc = corr_run(ld, tpad, nt, prefetch=u8, nonneg=u8)
                for j in range(8):
                    V[8 * g + j, :cv * nw] = acc[j].reshape(-1)
            # horizontal pass: lane -> row lane % ty, slot (warp, lane // ty)
            per_warp = 32 // ty
            lanes = []
            for warp in range(8):
                for lane in range(32):
                    for ch in range(warp * per_warp + lane // ty, tx // 8, 8 * per_warp):
                        if x0 + 8 * ch >= W:
                            break
                        lanes.append((lane % ty, 8 * ch))
            ly, lx0 = (np.asarray(v) for v in zip(*lanes))
            acc = corr_run(lambda m: V[ly, d + lx0 + m], tpad, nt,
                           nonneg=img.dtype == np.uint8)
            for j in range(8):
                y, x = y0 + ly, x0 + lx0 + j
                keep = (y < H) & (x < W)
                out[y[keep], x[keep]] = acc[j][keep]
                np.add.at(writes, (y[keep], x[keep]), 1)
    return out, writes


K6_CASES = [
    # (h, w, ntaps, uint8, tile or None for gauss.tile's)
    (37, 53, 3, True, None), (40, 150, 9, True, (32, 64)),
    (70, 131, 15, False, (16, 64)), (30, 45, 79, True, None),
    (5, 300, 39, False, (32, 128)), (1, 7, 3, True, None),
    (33, 200, 39, True, (32, 64)), (20, 260, 1, True, (32, 64)),
    (9, 128, 17, False, (32, 64)), (50, 66, 7, True, (16, 64)),
    (12, 9, 25, False, None), (64, 256, 33, True, (32, 128)),
]


@pytest.mark.parametrize("h,w,ntaps,u8,tile", K6_CASES)
def test_k6_blocks_equal_plain(h, w, ntaps, u8, tile):
    """Column spans that start left of the frame and end past it, words
    half outside it, rows reflected more than once (frames within the
    radius), 16-row blocks, tap counts below, at and past a chunk of 8:
    every output written once and equal to the plain version to the bit."""
    rng = np.random.default_rng(ntaps * 31 + w)
    img = (rng.integers(0, 256, (h, w), dtype=np.uint8) if u8
           else (rng.standard_normal((h, w)) * 40).astype(f32))
    taps = gaussian_kernel(ntaps, (ntaps - 1) / 5) if ntaps > 1 else np.ones(1, f32)
    ty, tx = tile or k6.tile(ntaps, w)
    got, writes = emulate_k6(img, taps, ty, tx)
    assert (writes == 1).all()
    ref = core.gaussian_blur_reflect101(torch.as_tensor(img)[None], taps)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_k6_column_span_of_the_deep_levels():
    """At the five-level 1080p pyramid's 39 and 79 taps a block spans 640
    of the 1920 columns (three spans, two blocks an SM), so its vertical
    pass recomputes at most 15 % more columns than it outputs (the halo
    and the 7 columns a last chunk of zero taps reads)."""
    for ntaps in (39, 79):
        ty, tx = k6.tile(ntaps, 1920)
        assert (ty, tx) == (32, 640)
        assert 2 * k6.smem_bytes(ntaps, ty, tx) + 2 * 1024 <= 228 * 1024
        r = ntaps // 2
        span = 4 * ((3 + tx + 2 * r + 7 + 3) // 4)
        assert span / tx <= 1.15


def k4_plan(B, P, sms=132):
    """oft_colorize's plan at two blocks an SM: (G, NG, slice, cap, vec)."""
    quads = -(-P // 4)
    NG = 2 if B >= 2 else 1
    G = sms * 2 // NG
    slc = -(-quads // G)
    cap = min(slc, 112 * 1024 // 20)
    return G, NG, slc, cap, P % 4 == 0


def _hue_bytes(fx, fy):
    rad = fast_atan2_deg(fy, fx) * colorize._RAD_PER_DEG
    return torch.remainder(torch.floor(rad * colorize._DEG_PER_RAD), 256.0)


def emulate_k4(flow, G, NG, slc, cap):
    """K4's launch on (B, 2, H, W) f32 -> (B, 3, H, W) uint8, and how many
    times each output byte was written."""
    B, _, H, W = flow.shape
    P = H * W
    quads = -(-P // 4)
    fl = torch.as_tensor(flow).reshape(B, 2, P)
    out = np.zeros((B, 3, P), np.uint8)
    writes = np.zeros((B, 3, P), np.int32)
    eps = f32(2.220446049250313e-16)
    for grp in range(NG):
        for b in range(grp, B, NG):      # the group's frames, in order
            fx, fy = fl[b, 0], fl[b, 1]
            parts, cache = [], []
            for k in range(G):           # 1. every block of the group
                q0, q1 = k * slc, min(k * slc + slc, quads)
                px = [np.arange(4 * q, min(4 * q + 4, P)) for q in range(q0, q1)]
                mags = [magnitude(fx[i], fy[i]) for i in px]
                mn = min((float(m.min()) for m in mags), default=np.inf)
                mx = max((float(m.max()) for m in mags), default=-np.inf)
                parts.append((f32(mn), f32(mx)))
                cache.append([(i, m, _hue_bytes(fx[i], fy[i]))
                              for i, m in zip(px[:cap], mags[:cap])])
            # 3. (scale, shift) from the G pairs, then each block's map
            mn = min(p[0] for p in parts)
            mx = max(p[1] for p in parts)
            rng = f32(mx - mn)
            scale = f32(f32(255.0) / rng) if rng > eps else f32(0.0)
            shift = f32(-mn) * scale
            for k in range(G):
                q0, q1 = k * slc, min(k * slc + slc, quads)
                for li, q in enumerate(range(q0, q1)):
                    if li < cap:
                        i, m, hue = cache[k][li]
                    else:   # past the cache: read again
                        i = np.arange(4 * q, min(4 * q + 4, P))
                        m, hue = magnitude(fx[i], fy[i]), _hue_bytes(fx[i], fy[i])
                    value = torch.floor(m * float(scale) + float(shift)).clamp(0, 255)
                    sat = torch.full((), 255.0)
                    for c, plane in enumerate(hsv2bgr_planes(hue, sat, value)):
                        out[b, c, i] = plane.numpy()
                        writes[b, c, i] += 1
    return out.reshape(B, 3, H, W), writes


K4_CASES = [
    # (B, h, w, plan or None for the card's (132 SMs, two blocks each))
    (1, 5, 7, (4, 1, 3, 3)), (3, 6, 8, (3, 2, 4, 1)), (4, 9, 13, (5, 2, 6, 2)),
    (2, 16, 16, None), (1, 1, 1, None), (3, 11, 7, (2, 2, 10, 4)),
    (5, 4, 4, (1, 2, 4, 4)), (2, 7, 9, (16, 2, 1, 1)),
]


@pytest.mark.parametrize("B,h,w,plan", K4_CASES)
def test_k4_slices_equal_plain(B, h, w, plan):
    """Frames whose H * W is not a multiple of 4 (the ragged last quad),
    slices past the cache's capacity, more blocks than quads, one or two
    groups and an odd batch; frame 0 holds no motion (its value plane is 0):
    each byte written once and equal to the plain version."""
    rng = np.random.default_rng(B * 100 + h * w)
    flow = ((rng.random((B, 2, h, w)) - 0.5) * 12.0).astype(f32)
    flow[0] = 0.0
    G, NG, slc, cap = plan or k4_plan(B, h * w)[:4]
    assert G * slc >= -(-h * w // 4)
    got, writes = emulate_k4(flow, G, NG, slc, cap)
    assert (writes == 1).all()
    ref = colorize.flow_to_bgr_planar(torch.as_tensor(flow)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_k4_plan_keeps_a_1080p_frame_on_chip():
    """At the visualizer's 1080p chunks the slice of a frame fits the cache
    (the flow is read once), two groups take alternate frames; at B = 1 one
    group of every block; at 4320x7680 the slice overflows the cache."""
    G, NG, slc, cap, vec = k4_plan(16, 1080 * 1920)
    assert (G, NG, slc) == (132, 2, 3928) and slc <= cap and vec
    G, NG, slc, cap, vec = k4_plan(1, 1079 * 1917)
    assert (G, NG) == (264, 1) and slc <= cap and not vec
    G, NG, slc, cap, vec = k4_plan(2, 4320 * 7680)
    assert slc > cap


def _staged_image(img, pre_taps):
    """staged_value over a whole (H, W) frame: the pixels as f32, or the
    3-tap REFLECT_101 pre-smooth (the vertical taps, then the horizontal)."""
    H, W = img.shape
    x = img.astype(f32)
    if pre_taps is None:
        return x
    rows = [[_reflect101(y + d, H) for y in range(H)] for d in (-1, 1)]
    P = _chain(pre_taps, [x[rows[0]], x, x[rows[1]]])
    cols = [[_reflect101(c + d, W) for c in range(W)] for d in (-1, 1)]
    return _chain(pre_taps, [P[:, cols[0]], P, P[:, cols[1]]])


def _combine(v0, v1, v2, h, w):
    """The six horizontal correlations (h(t, v) gives one) and the combine:
    R (5, ...) in polyexp.cuh's order."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = w
    b1, b2, b3 = h(g, v0), h(xg, v0), h(g, v1)
    b4, b5, b6 = h(xxg, v0), h(g, v2), h(xg, v1)
    return np.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                     b1 * ig03 + b4 * ig33, b6 * ig55])


def k7_fit_box(lo_y, hi_y, lo_x, hi_x, ay, ax, xc, n):
    """update_blur_poly.cu's fit_box: (y0, x0, h, w) of the fetch box."""
    if hi_y < lo_y or hi_x < lo_x:
        return 0, 0, 0, 0

    def floats(bh, bw):
        return (bw + 2 * n) * (4 * bh + 2 * n)

    eh, ew = hi_y - lo_y + 1, hi_x - lo_x + 1
    bh, bw = eh, ew
    if floats(bh, bw) > xc:
        s = 0
        while floats(s + 1, s + 1) <= xc:
            s += 1
        bh, bw = min(eh, s), min(ew, s)
        if bh < eh:
            t = xc // (bw + 2 * n) - 2 * n
            bh = min(eh, t // 4) if t > 0 else 0
        elif bw < ew:
            t = xc // (4 * bh + 2 * n) - 2 * n
            bw = min(ew, t) if t > 0 else 0
    if bh <= 0 or bw <= 0:
        return 0, 0, 0, 0
    y0 = lo_y if bh == eh else min(max(ay - bh // 2, lo_y), hi_y - bh + 1)
    x0 = lo_x if bw == ew else min(max(ax - bw // 2, lo_x), hi_x - bw + 1)
    return y0, x0, bh, bw


K7_PASSES, K7_MIN_BOXED = 4, 64     # kPasses and kMinBoxed in the kernel


def emulate_k7(img0, img1, flow, winsize, gaussian, poly_n, poly_sigma,
               pre_taps, tx, ty, xc):
    """K7's blocks on one frame pair, (H, W) each, flow (2, H, W) f32, a
    tx x ty output tile and a region X of xc floats -> (new flow (2, H, W)
    f32, {"per_pixel", "boxed", "m_pixels"}, the blocks' fetch boxes)."""
    n, m = poly_n, winsize // 2
    nt = 2 * n + 1
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(n, poly_sigma)
    w = (g, xg, xxg) + tuple(f32(v) for v in (ig11, ig03, ig33, ig55))
    H, W = img0.shape
    mh, mw = ty + 2 * m, tx + 2 * m
    assert xc >= max((mh + 2 * n) * (mw + 2 * n), 5 * mh * tx)
    xcb = xc - 8 - -(-mh * mw // 32)     # X less the pass bits and bounds
    S0, S1 = _staged_image(img0, pre_taps), _staged_image(img1, pre_taps)
    taps = (core.gaussian_window_kernel(winsize) if gaussian
            else np.ones(2 * m + 1, f32))
    scale = f32(1.0) if gaussian else f32(1.0 / (winsize * winsize))
    sc_field = core.border_scale_field(H, W)
    out = np.full((2, H, W), np.nan, f32)
    counts = {"per_pixel": 0, "boxed": 0, "m_pixels": 0}
    boxes = []          # per block, its passes' fetch boxes

    def staged(S, ys, xs, rows, cols):
        return S[np.ix_(np.clip(ys + np.arange(rows), 0, H - 1),
                        np.clip(xs + np.arange(cols), 0, W - 1))]

    def vsums(U, i0, rows):
        return [_chain(t, [U[i0 + q:i0 + q + rows] for q in range(nt)])
                for t in (g, xg, xxg)]

    def wsum(values):
        return _chain(taps, values) if gaussian else sum(values[1:], values[0])

    for y0 in range(0, H, ty):
        for x0 in range(0, W, tx):
            ylo, yhi = max(y0 - m, 0), min(y0 + ty + m - 1, H - 1)
            xlo, xhi = max(x0 - m, 0), min(x0 + tx + m - 1, W - 1)
            nr, nc = yhi - ylo + 1, xhi - xlo + 1
            ys, xs = np.mgrid[ylo:yhi + 1, xlo:xhi + 1]
            # 1. img0 staged; the inside targets' bounds and the anchor
            us0 = nc + 2 * n
            U0 = staged(S0, ylo - n, xlo - n, nr + 2 * n, us0)
            dx, dy = flow[0, ys, xs], flow[1, ys, xs]
            fx = np.rint(xs.astype(f32) + dx)
            fy = np.rint(ys.astype(f32) + dy)
            inside = (fx >= 0) & (fx <= W - 1) & (fy >= 0) & (fy <= H - 1)
            xi = np.clip(fx, 0, W - 1).astype(np.int64)
            yi = np.clip(fy, 0, H - 1).astype(np.int64)
            cy, cx = min(y0 + ty // 2, yhi), min(x0 + tx // 2, xhi)
            if inside.any():
                lo_y, hi_y = int(yi[inside].min()), int(yi[inside].max())
                lo_x, hi_x = int(xi[inside].min()), int(xi[inside].max())
                if inside[cy - ylo, cx - xlo]:
                    ay, ax = int(yi[cy - ylo, cx - xlo]), int(xi[cy - ylo, cx - xlo])
                else:
                    ay, ax = (lo_y + hi_y) // 2, (lo_x + hi_x) // 2
            else:
                lo_y, hi_y, lo_x, hi_x, ay, ax = 1, 0, 1, 0, 0, 0
            box = k7_fit_box(lo_y, hi_y, lo_x, hi_x, ay, ax, xcb, n)
            boxes.append([])
            # 2. R0 on the unique pixels, in bands of rb rows
            u0, vs0 = (nr + 2 * n) * us0, us0 + 3
            rb = min(nr, (xc - u0) // (3 * vs0))
            R0 = np.full((5, nr, nc), np.nan, f32)
            if rb >= 1:
                for b0 in range(0, nr, rb):
                    rows = min(rb, nr - b0)
                    v = vsums(U0, b0, rows)
                    R0[:, b0:b0 + rows] = _combine(
                        *v, lambda t, r: _chain(t, [r[:, k:k + nc] for k in range(nt)]), w)
            else:
                R0 = _combine(*vsums(U0, 0, nr),
                              lambda t, r: _chain(t, [r[:, k:k + nc] for k in range(nt)]), w)
            # 3. passes: img1 staged over the pass's box, its vertical
            # sums, R1 of the targets in it; the targets left bound the
            # next box (at their top-left corner); a pass without a box
            # takes R1 of every target left from its own window
            d = np.zeros((5, nr, nc), f32)
            done = ~inside
            for npass in range(K7_PASSES):
                by0, bx0, bh, bw = box
                if bh == 0:
                    per_pixel = inside & ~done
                    py, px = yi[per_pixel], xi[per_pixel]
                    cols = [np.clip(px - n + j, 0, W - 1) for j in range(nt)]
                    win = [[S1[np.clip(py - n + k, 0, H - 1), cols[j]] for k in range(nt)]
                           for j in range(nt)]
                    v = [[_chain(t, win[j]) for j in range(nt)] for t in (g, xg, xxg)]
                    if per_pixel.any():
                        d[:, per_pixel] = _combine(*v, lambda t, r: _chain(t, r), w)
                    counts["per_pixel"] += int(per_pixel.sum())
                    break
                boxes[-1].append(box)
                assert (bw + 2 * n) * (4 * bh + 2 * n) <= xcb
                boxed = (~done & (yi >= by0) & (yi < by0 + bh)
                         & (xi >= bx0) & (xi < bx0 + bw))
                if boxed.any():
                    V1 = vsums(staged(S1, by0 - n, bx0 - n, bh + 2 * n, bw + 2 * n), 0, bh)
                    ri, ci = yi[boxed] - by0, xi[boxed] - bx0
                    d[:, boxed] = _combine(
                        *V1, lambda t, r: _chain(t, [r[ri, ci + k] for k in range(nt)]), w)
                counts["boxed"] += int(boxed.sum())
                done |= boxed
                rest = ~done
                if not rest.any():
                    break
                if rest.sum() >= K7_MIN_BOXED and npass + 2 < K7_PASSES:
                    ly, lx = int(yi[rest].min()), int(xi[rest].min())
                    box = k7_fit_box(ly, int(yi[rest].max()), lx, int(xi[rest].max()),
                                     ly, lx, xcb, n)
                else:
                    box = (0, 0, 0, 0)
            counts["m_pixels"] += nr * nc
            # 4. M over R0 (update_matrices.cuh:assemble), then the entries
            # outside the image from their clamped pixels
            half, quarter, zero = f32(0.5), f32(0.25), f32(0.0)
            r2 = np.where(inside, d[0], zero)
            r3 = np.where(inside, d[1], zero)
            r4 = np.where(inside, (R0[2] + d[2]) * half, R0[2])
            r5 = np.where(inside, (R0[3] + d[3]) * half, R0[3])
            r6 = np.where(inside, (R0[4] + d[4]) * quarter, R0[4] * half)
            r2 = (R0[0] - r2) * half + (r4 * dy + r6 * dx)
            r3 = (R0[1] - r3) * half + (r6 * dy + r5 * dx)
            sc = sc_field[ys, xs]
            r2, r3, r4, r5, r6 = (r * sc for r in (r2, r3, r4, r5, r6))
            M = np.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                          r4 * r2 + r6 * r3, r6 * r2 + r5 * r3])
            Ms = M[:, np.clip(y0 - m + np.arange(mh), 0, H - 1) - ylo][
                :, :, np.clip(x0 - m + np.arange(mw), 0, W - 1) - xlo]
            # 5. the window sums (horizontal, then vertical) and the solve
            Hs = wsum([Ms[:, :, i:i + tx] for i in range(2 * m + 1)])
            s = wsum([Hs[:, i:i + ty] for i in range(2 * m + 1)]) * scale
            idet = f32(1.0) / (s[0] * s[2] - s[1] * s[1] + f32(1e-3))
            hh, ww = min(ty, H - y0), min(tx, W - x0)
            out[0, y0:y0 + hh, x0:x0 + ww] = ((s[0] * s[4] - s[1] * s[3]) * idet)[:hh, :ww]
            out[1, y0:y0 + hh, x0:x0 + ww] = ((s[2] * s[3] - s[1] * s[4]) * idet)[:hh, :ww]
    return out, counts, boxes


def _k7_flow(kind, h, w, rng):
    """A (2, h, w) f32 flow: smooth, random ±60 px, the vertical jump's
    strips (+40 and +104 rows) or one that sends the targets to all four
    borders, most past them (clamped)."""
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w].astype(f32)
        return np.stack([2.5 * np.sin(yy / 9.0) + 1.3, 1.7 * np.cos(xx / 7.0) - 0.6]).astype(f32)
    if kind == "random60":
        return ((rng.random((2, h, w)) - 0.5) * 120).astype(f32)
    if kind == "jump":
        flow = ((rng.random((2, h, w)) - 0.5) * 1.5).astype(f32)
        for r0f, r1f, dy in ((0.37, 0.445, 40), (0.46, 0.535, 104)):
            flow[1, int(h * r0f):int(h * r1f)] += dy
        return flow
    # "borders": every target sent to between 2 px inside and 8 px past
    # the nearest edge of each axis
    yy, xx = np.mgrid[0:h, 0:w].astype(f32)
    push = (10 * rng.random((h, w)) - 2).astype(f32)
    fy = np.where(yy < h / 2, -(yy + push), (h - 1 - yy) + push)
    fx = np.where(xx < w / 2, -(xx + push), (w - 1 - xx) + push)
    return np.stack([fx, fy]).astype(f32)


def _k7_inputs(kind, h, w, u8, seed):
    rng = np.random.default_rng(seed)
    if kind == "jump":
        f1, f2 = vertical_jump_pair(h, w)
    else:
        f1, f2 = smooth_texture_pair(h, w, (1, 2))
    if not u8:
        f1, f2 = (f.astype(f32) * f32(0.7) + f32(3.0) for f in (f1, f2))
    return f1, f2, _k7_flow(kind, h, w, rng)


K7_CASES = [
    # (h, w, flow, winsize, gaussian, poly_n, uint8 + pre-smooth, tile, xc)
    # xc "plan": update_gather._k7_plan's at 32 columns; "big": every box
    # fits; an int: the region cut so that boxes and bands are cut too
    (37, 53, "smooth", 15, False, 5, True, (32, 32), "plan"),
    (33, 130, "smooth", 15, True, 5, True, (32, 32), "plan"),
    (37, 53, "random60", 15, False, 5, True, (32, 32), "plan"),
    (33, 130, "random60", 15, True, 5, False, (32, 32), "plan"),
    (160, 70, "jump", 15, False, 5, True, (32, 32), "plan"),
    (160, 70, "jump", 9, True, 5, True, (16, 16), 4000),
    (45, 66, "borders", 15, False, 5, True, (32, 32), "plan"),
    (45, 66, "borders", 7, True, 3, False, (8, 8), 1200),
    (5, 7, "random60", 3, False, 5, True, (32, 32), "plan"),
    (5, 7, "smooth", 15, True, 5, False, (32, 32), "plan"),
    (37, 53, "random60", 61, False, 5, True, (32, 32), "plan"),
    (37, 53, "smooth", 5, False, 7, True, (8, 16), "big"),
    (37, 53, "random60", 5, True, 7, False, (8, 8), 900),
    (33, 130, "random60", 1, False, 5, True, (16, 8), 650),
    (40, 37, "smooth", 3, False, 6, True, (4, 4), 330),
    (37, 53, "borders", 3, True, 6, False, (4, 4), 330),
]


@pytest.mark.parametrize("h,w,kind,winsize,gaussian,poly_n,u8,tile,xc", K7_CASES)
def test_k7_blocks_equal_plain(h, w, kind, winsize, gaussian, poly_n, u8, tile, xc):
    """Smooth, ±60 px, vertical-jump and border-crossing flows, frames
    smaller than a tile and odd sizes, the real plan and regions cut so
    that boxes are cut, R0 runs in bands or per pixel: every block's staged
    spans, fetch box and split of M pixels give the plain version's flow
    to the bit."""
    tx, ty = tile
    pre = gaussian_kernel(3, 0.0) if u8 else None
    img0, img1, flow = _k7_inputs(kind, h, w, u8, h * w + winsize)
    if xc == "plan":
        xc = k7._k7_plan(winsize, poly_n, tx)[1]
    elif xc == "big":
        xc = 10 ** 6
    got, counts, _ = emulate_k7(img0, img1, flow, winsize, gaussian, poly_n, 1.2,
                                pre, tx, ty, xc)
    ref = core.update_step_poly(torch.as_tensor(img0)[None], torch.as_tensor(img1)[None],
                                torch.as_tensor(flow)[None], winsize, gaussian,
                                poly_n, 1.2, pre)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert counts["per_pixel"] + counts["boxed"] <= counts["m_pixels"]


def _k7_paths(kind, h, w, winsize, poly_n, tile, xc):
    img0, img1, flow = _k7_inputs(kind, h, w, True, h * w + winsize)
    return emulate_k7(img0, img1, flow, winsize, False, poly_n, 1.2,
                      gaussian_kernel(3, 0.0), *tile, xc)[1:]


def test_k7_split_of_the_m_pixels():
    """Which path the M pixels take under the real plan (32 x 32, winsize
    15, poly_n 5): a smooth flow and a ±6 px one keep every fetch in the
    block's first box; the vertical jump's strips need a second; ±60 px
    random flows cut three boxes and leave the rest to the per-pixel
    path; targets past the borders need no R1."""
    xc = k7._k7_plan(15, 5, 32)[1]
    for kind, amp in (("smooth", None), ("random6", 6)):
        h, w = 96, 130
        img0, img1, _ = _k7_inputs("smooth", h, w, True, 1)
        flow = (_k7_flow("smooth", h, w, None) if amp is None else
                ((np.random.default_rng(2).random((2, h, w)) - 0.5) * 2 * amp).astype(f32))
        counts, boxes = emulate_k7(img0, img1, flow, 15, False, 5, 1.2,
                                   gaussian_kernel(3, 0.0), 32, 32, xc)[1:]
        assert counts["per_pixel"] == 0 and counts["boxed"] > 0, kind
        # one box a block: the block's M span plus about 12 px at ±6 px
        assert all(len(b) == 1 and b[0][2] <= 46 + 13 and b[0][3] <= 46 + 13
                   for b in boxes)
    # the vertical jump: the strips' blocks take a second box, so no
    # target is left to the per-pixel path
    counts, boxes = _k7_paths("jump", 160, 130, 15, 5, (32, 32), xc)
    assert counts["per_pixel"] == 0 and max(len(b) for b in boxes) == 2
    # ±60 px: three boxes, then the per-pixel path
    counts, boxes = _k7_paths("random60", 160, 130, 15, 5, (32, 32), xc)
    assert counts["per_pixel"] > 0 and counts["boxed"] > 0
    assert max(len(b) for b in boxes) == 3
    assert all((bw + 10) * (4 * bh + 10) <= xc for b in boxes for _, _, bh, bw in b)
    counts, _ = _k7_paths("borders", 45, 66, 15, 5, (32, 32), xc)
    assert counts["boxed"] + counts["per_pixel"] < counts["m_pixels"]


def test_k7_fit_box_cuts_to_the_region():
    """The bounding box where it fits; else the largest square grown along
    the axis still cut, placed around the anchor inside the bounds."""
    n, xc = 5, 18333
    assert k7_fit_box(10, 57, 20, 77, 30, 40, xc, n) == (10, 20, 48, 58)
    # a tall bounding box (a vertical jump): the width kept, rows cut
    y0, x0, bh, bw = k7_fit_box(0, 199, 100, 145, 150, 120, xc, n)
    assert bw == 46 and (bw + 10) * (4 * bh + 10) <= xc < (bw + 10) * (4 * bh + 14)
    assert y0 == 150 - bh // 2 and x0 == 100
    # anchored at the bottom edge of the bounds
    assert k7_fit_box(0, 199, 100, 145, 199, 120, xc, n)[0] == 200 - bh
    # both axes cut: a square, then the rows grown with its width
    y0, x0, bh, bw = k7_fit_box(0, 299, 0, 299, 0, 299, xc, n)
    assert (y0, x0 + bw) == (0, 300) and bw == 61 < bh
    assert k7_fit_box(5, 4, 0, 0, 0, 0, xc, n) == (0, 0, 0, 0)
    assert k7_fit_box(0, 0, 0, 0, 0, 0, 10, n) == (0, 0, 0, 0)


# --- X1 (csrc/resample.cu) ---------------------------------------------------

def _x1_flat(x):
    """x's storage as a flat f32 numpy array and the element offset of
    each of its (N, C) planes, as the kernel reads them through strides."""
    v = resample._planes(x)
    n, c, _, _ = v.shape
    sn, sc, sh, sw = v.stride()
    base = v.storage_offset()
    flat = v.untyped_storage()
    flat = torch.tensor([], dtype=torch.float32).set_(flat).numpy()
    planes = base + (np.arange(n)[:, None] * sn + np.arange(c)[None, :] * sc).reshape(-1)
    return flat, planes, (sh, sw)


def _x1_stage_table(idx, wt, t0, nt, tile, lo):
    """A tile's staged table: indices minus lo, the entries past the
    frame's edge index 0 with weight 0."""
    s_idx = np.zeros((tile, idx.shape[1]), np.int64)
    s_wt = np.zeros((tile, idx.shape[1]), f32)
    s_idx[:nt] = idx[t0:t0 + nt] - lo
    s_wt[:nt] = wt[t0:t0 + nt]
    return s_idx, s_wt


def _x1_rows(band, s_ry, s_wy, s_cx, s_wx):
    """The horizontal pass first from a staged band (P, band_h, band_w):
    per output, each row tap's sum over the column taps from the first
    term, weighted, summed from the first row tap -> (P, rows, cols)."""
    acc = None
    for k in range(s_ry.shape[1]):
        rows = band[:, s_ry[:, k], :]
        v = None
        for m in range(s_cx.shape[1]):
            term = rows[:, :, s_cx[:, m]] * s_wx[:, m]
            v = term if v is None else v + term
        term = v * s_wy[:, k][:, None]
        acc = term if acc is None else acc + term
    return acc


def _x1_stores(o, out, planes, y0, x0, nr, nc, dw, stores):
    """The tile's stores: groups of 4 consecutive outputs of a row, one
    16-byte store where dw % 4 == 0 and the group lies in the row, else
    one store each inside it."""
    for g in range(0, nc, 4):
        vec = dw % 4 == 0 and x0 + g + 4 <= dw
        stores["vector" if vec else "scalar"] += nr * len(planes)
        n = 4 if vec else min(4, dw - x0 - g)
        out[planes, y0:y0 + nr, x0 + g:x0 + g + n] = o[:, :nr, g:g + n]


def emulate_x1(x, ytab, xtab, vertical_first, scale):
    """X1's launch on x (..., H, W) f32 as `resample.plan` plans it, in
    numpy f32 -> ((N*C, dh, dw) f32, plan, store counts).

    band: per output tile (tile_h x TILE_W), the staged tables (indices
    relative to the band's first row and 4-aligned first column), the
    band of source rows and columns they reach copied from the storage
    through x's strides (entries past the frame left NaN: never read),
    the sums in table order.  columns: the row table absolute, the
    columns' vertical sums streamed from the storage a load at a time
    ((x0, y0, x1, y1) of 2 pixels of the (B, H, W, 2) layout, split into
    the two channels' planes; or one element), then the horizontal sums
    from them.  generic: each output from the tables."""
    pl = resample.plan(x, ytab, xtab, vertical_first)
    iy, wy = ytab.index.numpy(), ytab.weight.numpy()
    ix, wx = xtab.index.numpy(), xtab.weight.numpy()
    (dh, ty), (dw, tx) = iy.shape, ix.shape
    flat, bases, (sh, sw) = _x1_flat(x)
    H, W = x.shape[-2:]
    NC = len(bases)
    out = np.full((NC, dh, dw), np.nan, f32)
    stores = {"vector": 0, "scalar": 0}
    sc = f32(scale)
    TW = resample.TILE_W
    if pl.path == "generic":
        plane = lambda q, r, c: flat[bases[q] + r[..., None] * sh + c * sw]
        for q in range(NC):
            if vertical_first:
                acc = None
                for i in range(tx):
                    v = None
                    for j in range(ty):
                        term = plane(q, iy[:, j], ix[:, i]) * wy[:, j, None]
                        v = term if v is None else v + term
                    term = v * wx[:, i]
                    acc = term if acc is None else acc + term
            else:
                acc = _x1_rows(flat[bases[q] + np.arange(H)[:, None] * sh
                                    + np.arange(W) * sw][None], iy, wy, ix, wx)[0]
            out[q] = acc * sc
        stores["scalar"] = NC * dh * dw
        return out, pl, stores
    th, bw = pl.tile_h, pl.band_w
    for y0 in range(0, dh, th):
        nr = min(th, dh - y0)
        for x0 in range(0, dw, TW):
            nc = min(TW, dw - x0)
            clo = int(ix[x0:x0 + nc].min())
            if pl.load > 1:
                clo -= clo % pl.load
            s_cx, s_wx = _x1_stage_table(ix, wx, x0, nc, TW, clo)
            assert 0 <= s_cx.min() and s_cx.max() < bw
            cols = min(bw, W - clo)
            if pl.path == "band":
                rlo = int(iy[y0:y0 + nr].min())
                s_ry, s_wy = _x1_stage_table(iy, wy, y0, nr, th, rlo)
                assert 0 <= s_ry.min() and s_ry.max() < pl.band_h
                rows = min(pl.band_h, H - rlo)
                band = np.full((NC, pl.band_h, bw), np.nan, f32)
                band[:, :rows, :cols] = flat[bases[:, None, None]
                                             + (rlo + np.arange(rows))[:, None] * sh
                                             + (clo + np.arange(cols)) * sw]
                o = _x1_rows(band, s_ry, s_wy, s_cx, s_wx) * sc
                _x1_stores(o, out, np.arange(NC), y0, x0, nr, nc, dw, stores)
                continue
            s_ry, s_wy = _x1_stage_table(iy, wy, y0, nr, th, 0)
            items = bases[::2] if pl.load == 2 else bases
            chans = 2 if pl.load == 2 else 1
            v = np.full((len(items), chans, th, bw), np.nan, f32)
            for j in range(ty):
                rows = items[:, None] + s_ry[:nr, j][None, :] * sh     # (items, nr)
                if pl.load == 2:
                    # a 16-byte load: (x, y) of pixels c and c + 1
                    c = np.arange(0, cols, 2)
                    raw = flat[rows[..., None, None] + 2 * (clo + c)[:, None] + np.arange(4)]
                    val = np.empty((len(items), 2, nr, cols), f32)
                    val[:, 0, :, 0::2], val[:, 1, :, 0::2] = raw[..., 0], raw[..., 1]
                    val[:, 0, :, 1::2], val[:, 1, :, 1::2] = raw[..., 2], raw[..., 3]
                else:
                    val = flat[rows[..., None] + (clo + np.arange(cols)) * sw][:, None]
                term = val * s_wy[:nr, j][:, None]
                v[:, :, :nr, :cols] = term if j == 0 else v[:, :, :nr, :cols] + term
            v = v.reshape(len(items) * chans, th, bw)
            acc = None
            for i in range(tx):
                term = v[:, :, s_cx[:, i]] * s_wx[:, i]
                acc = term if acc is None else acc + term
            _x1_stores(acc * sc, out, np.arange(NC), y0, x0, nr, nc, dw, stores)
    return out, pl, stores


def _x1_bit_equal(got, ref):
    nan = np.isnan(ref)
    return got.shape == ref.shape and (np.isnan(got) == nan).all() and \
        (np.where(nan, 0, got).view(np.int32) == np.where(nan, 0, ref).view(np.int32)).all()


def _x1_source(n, h, w, seed, layout="planar"):
    """(n, 2, h, w) f32 up to 6 px from default_rng(seed), NaN and +-inf at
    a few places, pixel (0, 0) among them (where an area table's pads
    point): planar, the (B, H, W, 2) layout read in place ("pairs"), a
    view cut 1 column into a frame 2 wider ("offset": rows and planes not
    16-byte aligned), or of its first w columns ("narrow": a row's last
    16-byte load would reach past the width)."""
    x = ((np.random.default_rng(seed).random((n, 2, h, w + 2)) - 0.5) * 12).astype(f32)
    x[0, 0, 0, 0] = x[0, 0, 0, 1] = np.nan
    x[-1, -1, 0, 1] = np.inf
    x[0, -1, h // 2, w // 3] = -np.inf
    t = torch.as_tensor(x)
    if layout == "offset":
        return t[..., 1:w + 1]
    if layout == "narrow":
        return t[..., :w]
    t = t[..., 1:w + 1].contiguous()
    return t.movedim(1, -1).contiguous().movedim(-1, 1) if layout == "pairs" else t


_CPU = torch.device("cpu")

X1_BILINEAR_CASES = [
    # (n, h, w, dh, dw, scale, layout, path)
    (1, 135, 240, 270, 480, 2.0, "planar", "band"),       # the 1080p pyramid's x2 steps
    (1, 270, 480, 540, 960, 2.0, "planar", "band"),
    (1, 540, 960, 1080, 1920, 2.0, "planar", "band"),
    (3, 36, 64, 72, 129, 2.0, "planar", "generic"),       # the 72x129 chunk: tiles 2.2x
    (2, 37, 65, 73, 129, 2.0, "planar", "generic"),       # 65 -> 129 columns
    (2, 37, 64, 73, 127, 2.0, "planar", "band"),          # dw % 4 == 3, odd rows
    (2, 37, 62, 73, 123, 2.0, "offset", "band"),          # rows not 16-byte aligned
    (2, 37, 62, 73, 124, 2.0, "pairs", "band"),           # strided columns: element loads
    (2, 37, 62, 73, 124, 2.0, "narrow", "band"),          # the last load of a row cut
    (2, 48, 53, 48, 106, 4.0, "planar", "band"),          # a row table of t = 0
    (1, 200, 400, 110, 220, 1.0, "planar", "band"),       # /1.8: 8-row tiles
    (1, 120, 200, 60, 100, 1.0, "planar", "generic"),     # /2: no source pixel read twice
    (1, 1080, 1920, 68, 120, 1.0, "planar", "generic"),   # the levels=5 resizes after K6
    (1, 1080, 1920, 34, 60, 1.0, "planar", "generic"),
    (1, 400, 640, 100, 160, 1.0, "planar", "generic"),    # /4: the band past SMEM
    (1, 64, 64, 8, 8, 1.0, "planar", "generic"),          # /8
]


@pytest.mark.parametrize("n,h,w,dh,dw,scale,layout,path", X1_BILINEAR_CASES)
def test_x1_bilinear_tiles_equal_plain(n, h, w, dh, dw, scale, layout, path):
    """X1's tiles on the bilinear resize with its scale: equal to
    `resize_bilinear_f32(x) * scale` to the bit, NaN and +-inf included;
    every output stored once, 16-byte stores wherever dw % 4 == 0."""
    x = _x1_source(n, h, w, h * w, layout)
    ytab = resample._table("bilinear", h, dh, _CPU)
    xtab = resample._table("bilinear", w, dw, _CPU)
    got, pl, stores = emulate_x1(x, ytab, xtab, False, scale)
    assert pl.path == path
    ref = (resize.resize_bilinear_f32(x, dw, dh) * scale).reshape(-1, dh, dw).numpy()
    assert _x1_bit_equal(got, ref)
    if path == "band":
        assert pl.load == (4 if layout == "narrow" or layout == "planar" and w % 4 == 0
                           else 1)
        assert (stores["scalar"] == 0) == (dw % 4 == 0)


X1_AREA_CASES = [
    # (n, h, w, dh, dw, layout, launches' paths)
    (1, 1080, 1920, 135, 240, "pairs", ("columns",)),     # the seed at 1080p, read strided
    (2, 72, 129, 36, 64, "pairs", ("generic",)),          # the 72x129 seed: tiles 2.2x
    (2, 36, 1000, 9, 125, "planar", ("generic",)),        # planar rows: not the seed's
    (2, 36, 1000, 9, 125, "offset", ("columns",)),        # element loads
    (2, 36, 998, 9, 125, "narrow", ("generic",)),
    (2, 24, 480, 6, 120, "pairs", ("columns",)),          # 16-byte pair loads
    (2, 30, 360, 7, 101, "pairs", ("columns",)),          # pads at index 0
    (2, 60, 512, 120, 128, "pairs", ("band", "generic")),  # an axis grows: two launches
    (2, 60, 500, 120, 128, "pairs", ("band", "generic")),  # 5 column taps, 1 row tap
    (2, 512, 60, 128, 120, "pairs", ("columns", "generic")),
    (2, 64, 128, 64, 128, "pairs", ("columns",)),         # the same size: x * scale
    (2, 40, 1000, 5, 13, "pairs", ("generic",)),          # 78 column taps: over SMEM
]


@pytest.mark.parametrize("n,h,w,dh,dw,layout,paths", X1_AREA_CASES)
def test_x1_area_tiles_equal_plain(n, h, w, dh, dw, layout, paths):
    """X1's launches of `area_plan` with the scale on the last: equal to
    `resize_area_f32(x) * scale` to the bit, NaN and +-inf in x (pixel
    (0, 0) among them, where the pads point)."""
    x = _x1_source(n, h, w, h + w, layout)
    plan = resample.area_plan(h, w, dh, dw)
    assert len(plan) == len(paths)
    cur, scale = x, float(f32(0.5 ** 3))
    for k, (vert, horiz, vertical_first) in enumerate(plan):
        got, pl, _ = emulate_x1(cur, resample._table(*vert, _CPU),
                                resample._table(*horiz, _CPU), vertical_first,
                                scale if k == len(plan) - 1 else 1.0)
        assert pl.path == paths[k]
        cur = torch.as_tensor(got).reshape(x.shape[:-2] + got.shape[-2:])
    ref = (resize.resize_area_f32(x, dw, dh) * scale).reshape(-1, dh, dw).numpy()
    assert _x1_bit_equal(cur.reshape(-1, dh, dw).numpy(), ref)


@pytest.mark.parametrize("sh,dh,w,dw,parts", [(135, 270, 240, 480, 3), (541, 1079, 64, 128, 4)])
def test_x1_row_block_tiles_equal_plain(sh, dh, w, dw, parts):
    """The halo path's per-block resize through X1's tiles: each output row
    block from the source rows it reads, with the frame's vertical table
    shifted to them, equals the plain `bilinear_rows` on the block."""
    x = _x1_source(2, sh, w, sh)
    s0, s1, _ = resize._coeffs_f32(sh, dh)
    sy0, sy1, ty = resize.coeff_tensors(sh, dh, _CPU)
    for block in np.array_split(np.arange(dh), parts):
        a, b = int(block[0]), int(block[-1]) + 1
        lo, hi = int(s0[a]), int(s1[b - 1]) + 1
        src = x[..., lo:hi, :]
        got, pl, _ = emulate_x1(src, resample._row_block_table(sh, dh, a, b, lo, _CPU),
                                resample._table("bilinear", w, dw, _CPU), False, 2.0)
        assert pl.path == "band"
        ref = resize.bilinear_rows(src, dw, sy0[a:b] - lo, sy1[a:b] - lo, ty[a:b]) * 2.0
        assert _x1_bit_equal(got, ref.reshape(-1, b - a, dw).numpy())


def test_x1_plans_of_chip_smoke_cases():
    """The host's plan for each of chip_smoke.py's kernel_X1 cases: the
    path, the tile, the staged band and the shared memory.  The x2
    upsamples stage a band of 10 rows x 72 columns for a 16 x 128 tile;
    the seed's vertical sums are 4 rows x 1028 columns x 2 channels, a
    word of padding every 32; the levels=5 resizes (/16 and /32) and the
    72x129 chunk's upsample, whose tiles would cover 2.2 times its
    planes, take the generic kernel, as does the 8K halo blocks' /2
    level resize, whose taps read each source pixel once; their upsample
    is planned as the x2 steps."""
    def bilinear(n, h, w, dh, dw):
        x = torch.empty((n, 2, h, w))
        return resample.plan(x, resample._table("bilinear", h, dh, _CPU),
                             resample._table("bilinear", w, dw, _CPU), False)

    band = dict(path="band", load=4, tile_h=16, band_h=10)
    for h, w in ((135, 240), (270, 480), (540, 960)):
        assert bilinear(16, h, w, 2 * h, 2 * w) == resample.Plan(**band, band_w=72, smem=8064)
    assert bilinear(128, 36, 64, 72, 129).path == "generic"     # tiles 2.2x the plane
    blurred = torch.empty((32, 1080, 1920))
    for dh, dw in ((68, 120), (34, 60)):
        assert resample.plan(blurred, resample._table("bilinear", 1080, dh, _CPU),
                             resample._table("bilinear", 1920, dw, _CPU),
                             False).path == "generic"
    seed = torch.empty((16, 1080, 1920, 2)).movedim(-1, 1)
    assert resample.plan(seed, resample._table("area", 1080, 135, _CPU),
                         resample._table("area", 1920, 240, _CPU), True) == resample.Plan(
        "columns", 2, 4, 0, 1028, 42368)
    s0 = resize._coeffs_f32(2160, 4320)[0]
    lo = int(s0[2160])
    block = torch.empty((1, 2, 2160 - lo, 3840))
    assert resample.plan(block, resample._row_block_table(2160, 4320, 2160, 4320, lo, _CPU),
                         resample._table("bilinear", 3840, 7680, _CPU),
                         False) == resample.Plan(**band, band_w=72, smem=8064)
    s0 = resize._coeffs_f32(4320, 2160)[0]
    lo = int(s0[1080])
    block = torch.empty((2, 4320 - lo, 7680))
    assert resample.plan(block, resample._row_block_table(4320, 2160, 1080, 2160, lo, _CPU),
                         resample._table("bilinear", 7680, 3840, _CPU), False).path == "generic"
