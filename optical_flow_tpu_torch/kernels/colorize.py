"""K4: flow -> BGR colorization (`csrc/colorize.cu`).

Replaces `optical_flow_tpu/pallas/colorize.py` (`flow_to_bgr_planar_pallas`,
`:125`), together with the per-frame magnitude min/max that the JAX package
computes in XLA before the Pallas call (`:134-141`).  One cooperative
launch of persistent blocks walks the frames: the blocks of a group cut a
frame into slices of 4-pixel quads, keep each slice's magnitudes and hues
in shared memory while they reduce it, meet at a per-frame counter, and
map the slice from shared memory, so the flow is read from device memory
once.

Bound on the card by device memory: 8 B/px of flow read and 3 B/px
written.  There is no shape gate; the TPU kernel's (8, 128) padding does
not carry over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, check, on_cuda,
                                            raise_on_error, sm_count)
from optical_flow_tpu_torch.ops import colorize


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("colorize").oft_colorize
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, p, i, ctypes.c_longlong, i, p]
    f.restype = i
    return f


def flow_to_bgr_planar(flow: torch.Tensor) -> torch.Tensor:
    """flow (B, 2, H, W) f32 -> planar BGR (B, 3, H, W) uint8."""
    if not on_cuda(flow):
        return colorize.flow_to_bgr_planar(flow)
    dev = flow.device
    check(flow, "flow", dev, (torch.float32,), 4)
    B, two, h, w = flow.shape
    if two != 2:
        raise ValueError(f"flow has shape {tuple(flow.shape)}, expected (B, 2, H, W)")
    out = torch.empty((B, 3, h, w), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    # per frame, each block's (min, max) pair (at most two blocks an SM)
    # and the count of blocks that have published theirs
    parts = torch.empty((B, 2 * sm_count(dev), 2), dtype=torch.float32, device=dev)
    counters = torch.zeros((B,), dtype=torch.int32, device=dev)
    rc = _kernel()(flow.data_ptr(), parts.data_ptr(), counters.data_ptr(),
                   out.data_ptr(), B, h * w, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "colorize")
    LAUNCHES["K4"] += 1
    return out
