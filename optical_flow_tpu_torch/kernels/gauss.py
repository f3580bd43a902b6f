"""K6: full-resolution separable Gaussian blur (`csrc/gauss.cu`).

Replaces `optical_flow_tpu/pallas/gauss.py` (`gaussian_blur_pallas`,
`:107`): (N, H, W) uint8 or f32 frames -> (N, H, W) f32, cv2's
GaussianBlur with REFLECT_101 borders, any odd tap count.  The pyramid
runs it for the levels K3 does not take (`gauss_resize.k3_fits`), before
the bilinear resize, as the JAX package does for levels its fused level
kernel does not take (`models/farneback/flow.py:229-231`).

Bound on the card by f32 instruction issue: 4 x ntaps unfused operations
per pixel, far above the 5 B/px a uint8 frame reads and writes.  A block
of 32 rows (16 at radii past about 870) and `tile`'s column span blurs
vertically into shared memory over the columns its horizontal taps reach,
each thread making 4 columns x 8 rows from a ring of loaded rows, then
horizontally from shared memory, each lane one row and 8 adjacent
outputs.  The TPU kernel's 16-row bands, padded copy of the frame and
128-lane padding do not carry over: the reflected index is a load.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            device_cache, on_cuda, output,
                                            raise_on_error)
from optical_flow_tpu_torch.models.farneback import core

_ROWS = (32, 16)          # block rows the kernel takes, preferred first
_TX_STEP = 64             # block columns: a multiple of 8 outputs x 8 warps
# Shared memory of one SM on Hopper, and what each resident block reserves.
_SM_SMEM, _BLOCK_RESERVED = 228 * 1024, 1024


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("gauss").oft_gauss
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, i, p, i, i, i, p, i, i, i, i, p]
    f.restype = i
    return f


@device_cache(64)
def _taps(taps: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.float32).to(device)


def smem_bytes(ntaps: int, ty: int, tx: int) -> int:
    """Dynamic shared memory of a (ty, tx) block, as the kernel's
    smem_bytes: the taps zero-padded past a multiple of 8, and ty rows of
    vertical sums over the 4-aligned columns that tx outputs and the
    horizontal taps reach (7 more: a chunk of 8 taps past the last), at an
    odd pitch."""
    r = ntaps // 2
    pitch = 4 * ((3 + tx + 2 * r + 7 + 3) // 4) + 1
    tpad = (ntaps + 7) // 8 * 8 + 8
    return 4 * (tpad + ty * pitch)


@functools.lru_cache(maxsize=256)
def tile(ntaps: int, w: int) -> tuple:
    """(rows, columns) of K6's block for `ntaps` taps on frames `w` wide,
    or (0, 0) when no block fits.  32 rows where they fit, else 16; the
    widest span (a multiple of 64) at which two blocks share an SM, else
    one; then the frame's width split evenly into that many spans, so the
    halo of 2r recomputed columns is as small a share as the width allows.
    Takes every tap count up to 3113 at any width, as the earlier
    128 x 16 block did."""
    full = max(1, -(-w // _TX_STEP)) * _TX_STEP
    for ty in _ROWS:
        for budget in (_SM_SMEM // 2 - _BLOCK_RESERVED, MAX_SMEM):
            widest = 0
            for tx in range(_TX_STEP, full + 1, _TX_STEP):
                if smem_bytes(ntaps, ty, tx) > budget:
                    break
                widest = tx
            if widest:
                spans = -(-full // widest)
                return ty, -(-full // (spans * _TX_STEP)) * _TX_STEP
    return 0, 0


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
    n, h, w = img.shape
    ty, tx = tile(len(taps), w)
    if ty == 0:
        raise ValueError(f"{len(taps)} taps do not fit one block's shared memory")
    out = output(out, img.shape, dev, img)
    if out.numel() == 0:
        return out
    rc = _kernel()(img.data_ptr(), int(img.dtype == torch.uint8), out.data_ptr(),
                   n, h, w, _taps(taps, dev).data_ptr(), len(taps), ty,
                   tx, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "gauss")
    LAUNCHES["K6"] += 1
    return out
