"""The index maps of the redesigned K2 and K5b, emulated in numpy on the CPU.

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
"""

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch.kernels import blur_solve as k5b
from optical_flow_tpu_torch.kernels import polyexp as k2
from optical_flow_tpu_torch.models.farneback import core
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
