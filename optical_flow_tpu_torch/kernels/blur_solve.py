"""K5b: box or Gaussian window sum of the update matrices + 2x2 solve
(`csrc/blur_solve.cu`).

Replaces `optical_flow_tpu/pallas/blur_solve.py`
(`update_flow_blur_solve_pallas`, `:194`, and `blur_solve_store`, `:311`):
M (B, 5, H, W) f32 as K5a writes it -> flow (B, 2, H, W) f32.  Replicate
borders come from clamping where M is staged, so there is no padded copy
of M and no store layout.  The window is 2 * (winsize // 2) + 1 taps per
axis: plain adds and a 1 / winsize^2 scale for the box,
`core.gaussian_window_kernel` and scale 1 for the Gaussian; the taps go to
the card once per (winsize, window, device).

Bound on the card by the window sums' operations (630 a pixel at winsize
63), not by its 28 B/px.  The strip kernel stages M on 32 rows at a time
of a 32-column strip in shared memory, one channel at a time with 16-byte
loads (the next channel's in flight), sums each row once into a ring of
horizontal sums and each output row from the ring, four sums a thread in
both passes in tap order (K1's `window_sums`), three blocks of eight warps
an SM at winsize 63; a block walks the rows `_rows_per_block` gives it.
Its shared memory takes windows up to 261 (`k5b_strip_fits`); larger ones
take the tile kernel, which streams window rows through a fixed buffer,
so any winsize >= 1 runs.  K5a -> K5b equals K1 to the bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, MAX_SMEM, _build, check,
                                            device_cache, on_cuda, output,
                                            raise_on_error, sm_count)
from optical_flow_tpu_torch.models.farneback import core

_STRIP = 32         # output columns of a strip block, SW in blur_solve.cu
_ROWS = 32          # M rows staged per pass, G in blur_solve.cu
_SM_SMEM = 228 * 1024   # shared memory of an SM; each block also takes 1 KiB


def k5b_smem(winsize: int) -> int:
    """The strip kernel's shared memory per block, as `smem_floats` in
    blur_solve.cu: one channel of M on 32 rows of the strip plus its halo,
    the ring of horizontal sums, the window taps."""
    m = winsize // 2
    return 4 * (_ROWS * ((_STRIP + 2 * m + 3) | 1) + 5 * (2 * m + _ROWS) * (_STRIP + 1)
                + 2 * m + 1)


def k5b_strip_fits(winsize: int) -> bool:
    """Whether the strip kernel takes the window (winsize <= 261); larger
    windows go to the tile kernel."""
    return k5b_smem(winsize) <= MAX_SMEM


def _rows_per_block(B: int, h: int, w: int, winsize: int,
                    device: torch.device) -> int:
    """Output rows each strip block walks: h / nb rounded up to a multiple
    of 32, for the nb that takes the fewest waves x rows (each block walks
    its rows and 2m more above them; resident blocks per SM by the shared
    memory, at most three), so that neither the halo nor a last, thin wave
    of blocks dominates."""
    strips = -(-w // _STRIP)
    resident = max(1, min(3, _SM_SMEM // (k5b_smem(winsize) + 1024)))
    slots = resident * sm_count(device)
    best = None
    for nb in range(1, -(-h // _ROWS) + 1):
        rows = -(-h // nb)
        rows = -(-rows // _ROWS) * _ROWS
        cost = -(-(B * strips * -(-h // rows)) // slots) * (rows + 2 * (winsize // 2))
        if best is None or cost < best[0]:
            best = (cost, rows)
    return best[1]


@functools.lru_cache(maxsize=None)
def _strip():
    f = _build.library("blur_solve").oft_blur_solve
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=None)
def _tile():
    f = _build.library("blur_solve").oft_blur_solve_tile
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
    f.restype = i
    return f


@device_cache(64)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    if k5b_strip_fits(winsize):
        aligned = int(M.data_ptr() % 16 == 0 and w % 4 == 0)
        rc = _strip()(M.data_ptr(), taps.data_ptr() if gaussian else None,
                      out.data_ptr(), B, h, w, winsize // 2, scale,
                      _rows_per_block(B, h, w, winsize, dev), aligned, dev.index,
                      stream)
    else:
        rc = _tile()(M.data_ptr(), taps.data_ptr(), out.data_ptr(), B, h, w,
                     winsize // 2, scale, dev.index, stream)
    raise_on_error(rc, "blur_solve")
    LAUNCHES["K5b"] += 1
    return out
