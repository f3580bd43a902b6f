"""K6: full-resolution separable Gaussian blur (`csrc/gauss.cu`).

Replaces `optical_flow_tpu/pallas/gauss.py` (`gaussian_blur_pallas`,
`:107`): (N, H, W) uint8 or f32 frames -> (N, H, W) f32, cv2's
GaussianBlur with REFLECT_101 borders, any odd tap count.  The pyramid
runs it for the levels K3 does not take (`gauss_resize.k3_fits`), before
the bilinear resize, as the JAX package does for levels its fused level
kernel does not take (`models/farneback/flow.py:229-231`).

Bound on the card by its 4 x ntaps f32 operations per pixel, above the
5 B/px a uint8 frame reads and writes.  A block blurs vertically into
shared memory over the columns its horizontal taps reach, each thread
sliding a 16-row window of the input down the taps, then blurs
horizontally from shared memory.  The TPU kernel's 16-row bands, padded
copy of the frame and 128-lane padding do not carry over: the reflected
index is a load.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            on_cuda, output, raise_on_error)
from optical_flow_tpu_torch.models.farneback import core

_TX, _RPT, _TY_MAX = 128, 16, 64   # as TX and RPT in the kernel; rows per block


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("gauss").oft_gauss
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, p, i, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=64)
def _taps(taps: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.float32).to(device)


def block_rows(ntaps: int) -> int:
    """Output rows per block: the most, up to 64 in steps of 16, whose
    shared memory (taps, row table, TY x (128 + 2r) vertical sums) fits;
    0 when even 16 rows do not: r > 1556, where a pyramid level's r of
    about min(H, W) / 25.6 puts the frame's short side past 39000 px."""
    r = ntaps // 2
    for ty in range(_TY_MAX, 0, -_RPT):
        if 4 * (ntaps + ty + 2 * r + ty * (_TX + 2 * r)) <= MAX_SMEM:
            return ty
    return 0


def gaussian_blur(img: torch.Tensor, taps, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """(N, H, W) uint8/f32 frames -> (N, H, W) f32, blurred with the odd
    `taps` under REFLECT_101 borders; written to `out` when given (CUDA
    only; not the input's buffer)."""
    if not on_cuda(img):
        if out is not None:
            raise ValueError("out= is for CUDA tensors")
        return core.gaussian_blur_reflect101(img, taps)
    dev = img.device
    check(img, "img", dev, (torch.uint8, torch.float32), 3)
    taps = tuple(float(t) for t in np.asarray(taps, dtype=np.float32))
    if len(taps) % 2 == 0:
        raise ValueError(f"need an odd tap count, got {len(taps)}")
    ty = block_rows(len(taps))
    if ty == 0:
        raise ValueError(f"{len(taps)} taps do not fit one block's shared memory")
    n, h, w = img.shape
    out = output(out, img.shape, dev, img)
    if out.numel() == 0:
        return out
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8), out.data_ptr(),
                   n, h, w, _taps(taps, dev).data_ptr(), len(taps), ty,
                   dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "gauss")
    LAUNCHES["K6"] += 1
    return out
