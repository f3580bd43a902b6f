"""K3: one pyramid level from the full-resolution frame (`csrc/gauss_resize.cu`).

Replaces `optical_flow_tpu/pallas/gauss_resize.py`
(`gaussian_blur_resize_multi`, `:345`, and the one-level
`gaussian_blur_resize_pallas`, `:403`).  Computes
`resize_bilinear_f32(gaussian_blur_reflect101(img, taps), out_w, out_h)`
for any dims, from a uint8 or f32 frame batch, up to 32 taps
(`k3_fits`); the pyramid's deeper levels, whose level Gaussian is wider
(39 taps at the fourth level of a halving pyramid), go to K6
(`kernels/gauss.py`) and the bilinear resize instead.

Bound on the card by the read of the frame (1 B/px for uint8 frames) and
the 4 B written per output pixel.  A block takes a tile of output pixels,
stages its reflected source band once in shared memory (16-byte loads
where the frame's rows are aligned), blurs vertically at the two source
rows of each output row, both chains in one pass, then horizontally at
the two source columns of each output pixel, and interpolates.  The
wrapper sizes the tile per level and dtype (`_tile`: the fewest staged
bytes per output pixel within `_SMEM_BUDGET`, so that four blocks share
an SM) and keeps the index/weight tables of `_coeffs_f32` on the device
per level shape.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            device_cache, on_cuda, raise_on_error)
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.ops.resize import _coeffs_f32

_MAX_TAPS = 32
# Shared memory a tile aims for: four blocks of 256 threads share an SM.
_SMEM_BUDGET = 48 * 1024
_TILE_WIDTHS = (128, 64, 32, 16, 8)
_TILE_HEIGHTS = (32, 16, 8, 4, 2, 1)


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("gauss_resize").oft_gauss_resize
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p, p, p, p, i, p, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=256)
def _spans(n: int, out_n: int, r: int, tile: int):
    """Per block of `tile` outputs along one axis: the first and last
    source index its taps reach, [s0(first) - r, s1(last) + r]."""
    s0, s1, _ = _coeffs_f32(n, out_n)
    first = np.arange(0, out_n, tile)
    last = np.minimum(first + tile, out_n) - 1
    return s0[first] - r, s1[last] + r


def _columns(w: int, out_w: int, r: int, tw: int, vec: int):
    """(band row stride, most blurred columns) of any block of `tw`
    output columns: the stride covers the span from its vector-aligned
    start, in whole 16-byte vectors of `vec` elements."""
    xlo, xhi = _spans(w, out_w, r, tw)
    xs = xlo - xlo % vec
    return int(((xhi - xs) // vec + 1).max()) * vec, int((xhi - xlo + 1).max())


@functools.lru_cache(maxsize=256)
def _tile(ntaps: int, h: int, w: int, out_h: int, out_w: int, esize: int):
    """(tile_w, tile_h, band_stride, band_rows_max, ncols_max, smem bytes)
    of the kernel for one level and frame element size: of the tiles
    whose shared memory (the band, then two blurred rows per output row)
    fits `_SMEM_BUDGET`, the one that stages the fewest band elements per
    output pixel, the larger then the wider on a tie; where none fits,
    the one with the least shared memory.  None when no tile fits a
    block."""
    r = ntaps // 2
    vec = 16 // esize
    best = None
    for tw in _TILE_WIDTHS:
        stride, ncols = _columns(w, out_w, r, tw, vec)
        for th in _TILE_HEIGHTS:
            ylo, yhi = _spans(h, out_h, r, th)
            rows = int((yhi - ylo + 1).max())
            smem = esize * rows * stride + 4 * 2 * th * ncols
            if smem > MAX_SMEM:
                continue
            key = (smem > _SMEM_BUDGET, smem if smem > _SMEM_BUDGET else 0,
                   rows * stride / (tw * th), -tw * th, -tw)
            if best is None or key < best[0]:
                best = (key, (tw, th, stride, rows, ncols, smem))
    return None if best is None else best[1]


@device_cache(64)
def _tables(h: int, w: int, out_h: int, out_w: int, device: torch.device):
    """The `_coeffs_f32` index and weight tables of a level on the device."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in (*_coeffs_f32(h, out_h), *_coeffs_f32(w, out_w)))


@functools.lru_cache(maxsize=256)
def k3_fits(ntaps: int, h: int, w: int, out_w: int) -> bool:
    """Whether K3 takes a level: an odd tap count up to 31, a frame whose
    dims exceed the blur's radius (one reflection), and a tile whose band
    fits shared memory for f32 frames (uint8 frames need less).  The
    pyramid sends every other level to K6 and the bilinear resize."""
    r = ntaps // 2
    if ntaps % 2 == 0 or ntaps > _MAX_TAPS or min(h, w) <= r or out_w < 1:
        return False
    # the narrowest, one-row tile spans at most 2r + 2 source rows at any
    # level height, and `_tile` takes it when nothing larger fits
    stride, ncols = _columns(w, out_w, r, _TILE_WIDTHS[-1], 4)
    return 4 * (2 * r + 2) * stride + 4 * 2 * ncols <= MAX_SMEM


def gauss_resize(img: torch.Tensor, taps, out_w: int,
                 out_h: int) -> torch.Tensor:
    """(N, H, W) uint8/f32 frames -> (N, out_h, out_w) f32 level images."""
    if not on_cuda(img):
        return core.gaussian_blur_resize(img, taps, out_w, out_h)
    dev = img.device
    check(img, "img", dev, (torch.uint8, torch.float32), 3)
    taps = np.asarray(taps, dtype=np.float32)
    n, h, w = img.shape
    out = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if not k3_fits(len(taps), h, w, out_w):
        raise ValueError(f"K3 does not take {len(taps)} taps on {h}x{w} -> "
                         f"{out_w} columns (k3_fits; the pyramid runs K6 there)")
    tile = _tile(len(taps), h, w, out_h, out_w, img.element_size())
    aligned = img.data_ptr() % 16 == 0 and w % (16 // img.element_size()) == 0
    taps_host = (ctypes.c_float * len(taps))(*taps.tolist())
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8),
                   out.data_ptr(), n, h, w, out_h, out_w,
                   *(t.data_ptr() for t in _tables(h, w, out_h, out_w, dev)),
                   taps_host, len(taps), (ctypes.c_int * 5)(*tile[:5]),
                   int(aligned), dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "gauss_resize")
    LAUNCHES["K3"] += 1
    return out
