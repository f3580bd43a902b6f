"""K2: polynomial expansion, optional level-0 pre-smooth (`csrc/polyexp.cu`).

Replaces `optical_flow_tpu/pallas/polyexp.py` (`poly_exp_pallas_store`,
`:645`, and `poly_exp_pallas`, `:479`): FarnebackPolyExp, R = (b_y, b_x,
a_yy, a_xx, a_xy) per pixel from the (2n+1)^2 neighbourhood with
replicate borders; with `pre_taps`, the 3-tap REFLECT_101 smooth of level
0 runs first in the same pass.

Bound on the card by the 20 B/px of R it writes (it reads 1 or 4 B/px).
A block stages its tile plus an n-pixel halo once in shared memory, so
the input is read about once and R written once.  With the pre-smooth,
staged entries outside the image hold the *smoothed* value at the clamped
pixel, which is the replicate border of the smoothed image.  The tile's
shared memory is sized from poly_n, and any poly_n whose tile fits runs
(`k2_fits`: poly_n <= 96, kMaxN in the kernel).  The per-pixel
arithmetic is `csrc/polyexp.cuh`, which K7 (`update_gather.update_blur_poly`)
shares.
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

_TX, _TY = 32, 16  # output tile of a block, as in the kernel


def k2_fits(poly_n: int) -> bool:
    """Whether K2's tile (the input tile with its poly_n halo and the
    three vertical correlations) fits one block's shared memory:
    poly_n <= 96, a window 19 times as wide as cv2's poly_n 5."""
    n = poly_n
    return 4 * ((_TY + 2 * n) * (_TX + 2 * n) + 3 * _TY * (_TX + 2 * n)) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("polyexp").oft_polyexp
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, i, p, i, i, p]
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
    pre = np.zeros(3, np.float32)
    if pre_taps is not None:
        if len(pre_taps) != 3:
            raise ValueError(f"the pre-smooth takes 3 taps, got {len(pre_taps)}")
        if min(h, w) < 2:
            raise ValueError(f"frame {h}x{w} too small for the pre-smooth")
        pre = np.asarray(pre_taps, dtype=np.float32)
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
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8), R.data_ptr(),
                   n_img, h, w, poly_n, consts, int(pre_taps is not None),
                   dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "polyexp")
    LAUNCHES["K2"] += 1
    return R
