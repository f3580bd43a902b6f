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
the 4 B written per output pixel.  A block blurs vertically only at the
two source rows each of its output rows reads, over the span of source
columns its output columns reach, in shared memory; then each thread
blurs horizontally at its two source columns and interpolates.  The
index/weight tables of `_coeffs_f32` go to the kernel as small device
arrays.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            on_cuda, raise_on_error)
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.ops.resize import _coeffs_f32

_TX, _TY = 32, 8  # output tile of a block, as in the kernel
_MAX_TAPS = 32


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("gauss_resize").oft_gauss_resize
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, i, i, p, p, p, p, p, p, p, i, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=256)
def _ncols_max(w: int, out_w: int, r: int) -> int:
    """Widest span of source columns any block's horizontal taps reach."""
    sx0, sx1, _ = _coeffs_f32(w, out_w)
    first = np.arange(0, out_w, _TX)
    last = np.minimum(first + _TX, out_w) - 1
    lo = np.maximum(sx0[first] - r, 0)
    hi = np.minimum(sx1[last] + r, w - 1)
    return int((hi - lo + 1).max())


def k3_fits(ntaps: int, h: int, w: int, out_w: int) -> bool:
    """Whether K3 takes a level: an odd tap count up to 32, a frame whose
    dims exceed the blur's radius (one reflection), and a source-column
    span per block that fits shared memory.  The pyramid sends every
    other level to K6 and the bilinear resize."""
    r = ntaps // 2
    if ntaps % 2 == 0 or ntaps > _MAX_TAPS or min(h, w) <= r or out_w < 1:
        return False
    return 2 * _TY * _ncols_max(w, out_w, r) * 4 <= MAX_SMEM


def gauss_resize(img: torch.Tensor, taps, out_w: int,
                 out_h: int) -> torch.Tensor:
    """(N, H, W) uint8/f32 frames -> (N, out_h, out_w) f32 level images."""
    if not on_cuda(img):
        return core.gaussian_blur_resize(img, taps, out_w, out_h)
    dev = img.device
    check(img, "img", dev, (torch.uint8, torch.float32), 3)
    taps = np.asarray(taps, dtype=np.float32)
    n, h, w = img.shape
    r = len(taps) // 2
    out = torch.empty((n, out_h, out_w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if not k3_fits(len(taps), h, w, out_w):
        raise ValueError(f"K3 does not take {len(taps)} taps on {h}x{w} -> "
                         f"{out_w} columns (k3_fits; the pyramid runs K6 there)")
    sy0, sy1, ty = _coeffs_f32(h, out_h)
    sx0, sx1, tx = _coeffs_f32(w, out_w)
    ncols_max = _ncols_max(w, out_w, r)
    tables = [torch.as_tensor(a, device=dev) for a in (sy0, sy1, ty, sx0, sx1, tx)]
    taps_host = (ctypes.c_float * len(taps))(*taps.tolist())
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8),
                   out.data_ptr(), n, h, w, out_h, out_w,
                   *(t.data_ptr() for t in tables), taps_host, len(taps),
                   ncols_max, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "gauss_resize")
    LAUNCHES["K3"] += 1
    return out
