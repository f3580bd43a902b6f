"""K2: polynomial expansion, optional level-0 pre-smooth (`csrc/polyexp.cu`).

Replaces `optical_flow_tpu/pallas/polyexp.py` (`poly_exp_pallas_store`,
`:645`, and `poly_exp_pallas`, `:479`): FarnebackPolyExp, R = (b_y, b_x,
a_yy, a_xx, a_xy) per pixel from the (2n+1)^2 neighbourhood with
replicate borders; with `pre_taps`, the 3-tap REFLECT_101 smooth of level
0 runs first in the same pass.

Bound on the card by the 20 B/px of R it writes (it reads 1 or 4 B/px).
A block stages its tile's raw band once in shared memory with 16-byte
loads (the n-pixel replicate halo, and the pre-smooth's 1-pixel reflected
ring), runs the pre-smooth there (each staged value made once), then the
vertical and the horizontal correlations four outputs a thread, and
writes R once.  Staged entries
outside the image hold the *smoothed* value at the clamped pixel, which is
the replicate border of the smoothed image.  The wrapper sizes the tile
per poly_n and width (`_tile`: 128 x 16 at poly_n 5 and 1080p); where the
band does not fit beside the staged values, the staged values come from
device memory as before, so any poly_n <= 96 runs (`k2_fits`).  The
per-pixel arithmetic is `csrc/polyexp.cuh`, which K7
(`update_gather.update_blur_poly`) shares.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            on_cuda, raise_on_error)
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.params import poly_exp_weights

_MAX_N = 96                    # kPolyMaxN: the constants' size in the kernel
_TILE_WIDTHS = (128, 64, 32)   # output columns of a block, multiples of 4
_TILE_HEIGHT = 16
# Shared memory a tile aims for: two blocks of 256 threads share an SM.
_SMEM_BUDGET = 113 * 1024


def _smem(n: int, tx: int, ty: int, esize: int, pre: bool, raw: bool) -> int:
    """Bytes of shared memory of one block, as `layout` in polyexp.cu:
    the staged values S, then the raw band and the pre-smooth's vertical
    sums (raw), over which the vertical correlations V go."""
    vl = 16 // esize
    e = 1 if pre else 0
    nc, nr = tx + 2 * n, ty + 2 * n
    vs = nc + 1
    band_stride = vl * ((vl - 1 + nc + 2 * e + vl - 1) // vl)
    s_is_band = raw and not pre and esize == 4
    s_bytes = 0 if s_is_band else 4 * nr * ((nc + 3) // 4 * 4)
    p_off = s_bytes + (esize * (nr + 2 * e) * band_stride if raw else 0)
    p_bytes = 4 * (nr * band_stride + 4) if raw and pre else 0
    v_off = p_off if s_is_band else s_bytes
    return max(v_off + 4 * 3 * ty * vs, p_off + p_bytes)


@functools.lru_cache(maxsize=256)
def _tile(poly_n: int, w: int, esize: int, pre: bool):
    """(tile_w, tile_h, raw, smem bytes) of the kernel for one poly_n,
    frame width and element size: the band staged (raw) within
    `_SMEM_BUDGET` if a 16-row tile allows it, else the staged values
    from device memory, then the same without the budget; among the
    widths that fit, the one with the least work per row (vertical
    correlations on tile_w + 2n columns a tile, horizontal ones on
    tile_w), the wider on a tie.  A 32 x 8 tile without the band last;
    None when nothing fits a block."""
    n = poly_n
    for budget in (_SMEM_BUDGET, MAX_SMEM):
        for raw in (True, False):
            fits = [tw for tw in _TILE_WIDTHS
                    if _smem(n, tw, _TILE_HEIGHT, esize, pre, raw) <= budget]
            if fits:
                tw = min(fits, key=lambda t: (-(-w // t) * (3 * t + 2 * n), -t))
                return tw, _TILE_HEIGHT, raw, _smem(n, tw, _TILE_HEIGHT, esize, pre, raw)
    smem = _smem(n, 32, 8, esize, pre, False)
    return (32, 8, False, smem) if smem <= MAX_SMEM else None


@functools.lru_cache(maxsize=256)
def _tile_arg(poly_n: int, w: int, esize: int, pre: bool):
    """_tile's (tile_w, tile_h, raw) as the kernel's host array."""
    tw, th, raw, _ = _tile(poly_n, w, esize, pre)
    return (ctypes.c_int * 3)(tw, th, int(raw))


def k2_fits(poly_n: int) -> bool:
    """Whether K2 takes poly_n for uint8 and f32 frames, with and without
    the pre-smooth: 1 <= poly_n <= 96 (the kernel's constants), a window
    19 times as wide as cv2's poly_n 5; every such poly_n has a tile."""
    return 1 <= poly_n <= _MAX_N and all(
        _tile(poly_n, 1, esize, pre) is not None for esize in (1, 4) for pre in (False, True))


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("polyexp").oft_polyexp
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, i, p, i, p, i, i, i, p]
    f.restype = i
    return f


def expansion_consts(poly_n: int, poly_sigma: float, pre_taps, h: int,
                     w: int):
    """The expansion's constants as the kernels take them (polyexp.cuh's
    PolyConsts): a host array [g, xg, xxg, pre (3), ig11, ig03, ig33,
    ig55]; raises for a poly_n below 1, or pre-smooth taps that are not 3
    or a frame too small for them (h, w >= 2)."""
    if poly_n < 1:
        raise ValueError(f"poly_n must be >= 1, got {poly_n}")
    if pre_taps is not None:
        if len(pre_taps) != 3:
            raise ValueError(f"the pre-smooth takes 3 taps, got {len(pre_taps)}")
        if min(h, w) < 2:
            raise ValueError(f"frame {h}x{w} too small for the pre-smooth")
        pre_taps = tuple(np.asarray(pre_taps, dtype=np.float32).tolist())
    return _consts(poly_n, float(poly_sigma), pre_taps)


@functools.lru_cache(maxsize=64)
def _consts(poly_n: int, poly_sigma: float, pre_taps):
    """expansion_consts' array, made once per (poly_n, poly_sigma,
    pre-smooth): a launch's host work stays off the card's path."""
    pre = np.zeros(3, np.float32) if pre_taps is None else np.float32(pre_taps)
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(poly_n, poly_sigma)
    consts = np.concatenate([g, xg, xxg, pre, np.float32([ig11, ig03, ig33, ig55])])
    return (ctypes.c_float * len(consts))(*consts.tolist())


def poly_exp(img: torch.Tensor, poly_n: int, poly_sigma: float,
             pre_taps=None) -> torch.Tensor:
    """(N, H, W) uint8/f32 -> R (N, 5, H, W) f32."""
    if not on_cuda(img):
        return core.poly_exp(img, poly_n, poly_sigma, pre_taps)
    dev = img.device
    check(img, "img", dev, (torch.uint8, torch.float32), 3)
    n_img, h, w = img.shape
    consts = expansion_consts(poly_n, poly_sigma, pre_taps, h, w)
    if not k2_fits(poly_n):
        raise ValueError(f"poly_n {poly_n} does not fit the kernel's tile (<= 96)")
    R = torch.empty((n_img, 5, h, w), dtype=torch.float32, device=dev)
    if R.numel() == 0:
        return R
    esize = img.element_size()
    tile = _tile_arg(poly_n, w, esize, pre_taps is not None)
    in_aligned = int(img.data_ptr() % 16 == 0 and (w * esize) % 16 == 0)
    out_aligned = int(R.data_ptr() % 16 == 0 and w % 4 == 0)
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8), R.data_ptr(),
                   n_img, h, w, poly_n, consts, int(pre_taps is not None), tile,
                   in_aligned, out_aligned, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "polyexp")
    LAUNCHES["K2"] += 1
    return R
