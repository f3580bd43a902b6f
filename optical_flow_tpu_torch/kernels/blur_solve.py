"""K5b: box or Gaussian window sum of the update matrices + 2x2 solve
(`csrc/blur_solve.cu`).

Replaces `optical_flow_tpu/pallas/blur_solve.py`
(`update_flow_blur_solve_pallas`, `:194`, and `blur_solve_store`, `:311`):
M (B, 5, H, W) f32 as K5a writes it -> flow (B, 2, H, W) f32.  Replicate
borders come from clamped loads, so there is no padded copy of M and no
store layout.  The window is 2 * (winsize // 2) + 1 taps per axis: ones
and a 1 / winsize^2 scale for the box, `core.gaussian_window_kernel` and
scale 1 for the Gaussian; the taps go to the card once per (winsize,
window, device).  Any winsize >= 1 runs, beyond K1's tile too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, check, on_cuda,
                                            output, raise_on_error)
from optical_flow_tpu_torch.models.farneback import core


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("blur_solve").oft_blur_solve
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=64)
def window_taps(winsize: int, gaussian: bool, device: torch.device) -> torch.Tensor:
    """The window's 2 * (winsize // 2) + 1 taps on `device`: ones for the
    box, `core.gaussian_window_kernel` for the Gaussian (also K1's)."""
    taps = (core.gaussian_window_kernel(winsize) if gaussian
            else np.ones(2 * (winsize // 2) + 1, np.float32))
    return torch.as_tensor(taps).to(device)


def blur_solve(M: torch.Tensor, winsize: int, gaussian: bool,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """M (B, 5, H, W) f32 -> flow (B, 2, H, W) f32, written to `out` when
    given (CUDA only; not M's buffer).  The Gaussian window needs
    winsize >= 2 (`core.gaussian_window_kernel`)."""
    if not on_cuda(M):
        if out is not None:
            raise ValueError("out= is for CUDA tensors")
        return core.blur_solve(M, winsize, gaussian)
    dev = M.device
    check(M, "M", dev, (torch.float32,), 4)
    B, five, h, w = M.shape
    if five != 5:
        raise ValueError(f"M has shape {tuple(M.shape)}, expected (B, 5, H, W)")
    if winsize < 1:
        raise ValueError(f"winsize must be >= 1, got {winsize}")
    taps = window_taps(winsize, bool(gaussian), dev)
    scale = 1.0 if gaussian else float(np.float32(1.0 / (winsize * winsize)))
    out = output(out, (B, 2, h, w), dev, M)
    if out.numel() == 0:
        return out
    rc = _kernel()(M.data_ptr(), taps.data_ptr(), out.data_ptr(), B, h, w,
                   winsize // 2, scale, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "blur_solve")
    LAUNCHES["K5b"] += 1
    return out
