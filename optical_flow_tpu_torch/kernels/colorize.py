"""K4: flow -> BGR colorization (`csrc/colorize.cu`).

Replaces `optical_flow_tpu/pallas/colorize.py` (`flow_to_bgr_planar_pallas`,
`:125`), together with the per-frame magnitude min/max that the JAX package
computes in XLA before the Pallas call (`:134-141`): one launch reduces
each frame to `_MAX_PARTS` partial (min, max) pairs, a second maps every
pixel to its planar B, G, R bytes.

Bound on the card by device memory: 8 B/px of flow read by each launch
and 3 B/px written.  There is no shape gate; the TPU kernel's (8, 128)
padding does not carry over.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, check, on_cuda,
                                            raise_on_error)
from optical_flow_tpu_torch.ops import colorize

_THREADS = 256     # as kThreads in the kernel
_MAX_PARTS = 32    # as kMaxParts
_MAX_BATCH = 65535  # the grid's y dimension


@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("colorize").oft_colorize
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, i, ctypes.c_longlong, i, i, p]
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
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds {_MAX_BATCH}")
    out = torch.empty((B, 3, h, w), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    plane = h * w
    nparts = min(_MAX_PARTS, -(-plane // (_THREADS * 64)))
    parts = torch.empty((B, nparts, 2), dtype=torch.float32, device=dev)
    rc = _kernel()(flow.data_ptr(), parts.data_ptr(), out.data_ptr(), B, plane,
                   nparts, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "colorize")
    LAUNCHES["K4"] += 1
    return out
