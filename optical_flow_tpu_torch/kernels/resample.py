"""X1: separable resampling by per-axis tap tables (`csrc/resample.cu`).

Replaces what the JAX package leaves to one XLA fusion between its
Pallas kernels (no `pl.pallas_call`): the flow's x2 upsample with its
scale (`optical_flow_tpu/models/farneback/flow.py:296-297`,
`resize_bilinear_f32(flow) * f32(1 / pyr_scale)`), the resize after the
full-resolution Gaussian on the K6 route (`flow.py:231`) and the seed's
INTER_AREA downsample with its scale (`flow.py:290-292`).  One launch
reads the source once, strided (the seed's (B, H, W, 2) layout in place),
and writes a contiguous (..., dh, dw) f32 result; the eager plain
versions (`ops/resize.py`) make 13 launches for one bilinear level.

Each output recomputes the first-pass values it needs from the tables
(`ops/resize.py:bilinear_taps`, `_area_taps`, `unit_taps`): for each tap
of the second axis, the first axis's taps summed from the first term in
table order, then `* scale` as a separate f32 multiply, all built with
`--fmad=false`.  So the result equals the plain version to the bit
(`tests/test_torch_resample.py` holds the same loop in PyTorch to the
plain resizes).  Bound on the card by bytes: the source read once, the
output written once.

`resize_bilinear`, `resize_area` and `bilinear_rows` are the entries:
each runs the plain version on a CPU tensor and X1 on a CUDA tensor.
Each table carries the source span its indices reach, which the launch
checks against the frame it is given, so that no table reads past it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, on_cuda,
                                            raise_on_error)
from optical_flow_tpu_torch.ops import resize

@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("resample").oft_resample
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f.argtypes = [p, q, q, q, q, i, i, i, i, p, p, i, p, p, i, i, ctypes.c_float, p,
                  i, i, i, p]
    f.restype = i
    return f


class Table(NamedTuple):
    """An axis's taps: (d_len, T) int32 source indices and f32 weights,
    and the source span [lo, hi) the indices reach."""
    index: torch.Tensor
    weight: torch.Tensor
    lo: int
    hi: int


def _to_table(idx: np.ndarray, wt: np.ndarray, device: torch.device) -> Table:
    return Table(torch.as_tensor(np.ascontiguousarray(idx, np.int32), device=device),
                 torch.as_tensor(np.ascontiguousarray(wt, np.float32), device=device),
                 int(idx.min()), int(idx.max()) + 1)


@functools.lru_cache(maxsize=512)
def _table(kind: str, s_len: int, d_len: int, device: torch.device) -> Table:
    """An axis's table on `device`, made once per (kind, lengths, device):
    "bilinear", "area" or "unit" (d_len == s_len)."""
    if kind == "bilinear":
        idx, wt = resize.bilinear_taps(s_len, d_len)
    elif kind == "area":
        idx, wt = resize._area_taps(s_len, d_len)
    else:
        idx, wt = resize.unit_taps(d_len)
    return _to_table(idx, wt, device)


@functools.lru_cache(maxsize=512)
def _row_block_table(s_len: int, d_len: int, a: int, b: int, lo: int,
                     device: torch.device) -> Table:
    """Output rows [a, b) of the (s_len -> d_len) bilinear table, their
    source indices shifted to a row block that starts at source row lo."""
    idx, wt = resize.bilinear_taps(s_len, d_len)
    return _to_table(idx[a:b] - lo, wt[a:b], device)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """x as an (N, C, H, W) view: leading axes made two, a copy only where
    the strides do not allow a view."""
    if x.dim() < 2:
        raise ValueError(f"need (..., H, W), got {tuple(x.shape)}")
    lead = x.shape[:-2]
    if len(lead) == 2:
        return x
    if len(lead) < 2:
        return x.reshape((1,) * (2 - len(lead)) + tuple(x.shape))
    return x.reshape((-1, lead[-1]) + tuple(x.shape[-2:]))


def _resample(x: torch.Tensor, ytab: Table, xtab: Table, vertical_first: bool,
              scale: float = 1.0) -> torch.Tensor:
    """One X1 launch: (..., H, W) f32 on the card, any strides ->
    contiguous (..., dh, dw) f32, resampled by the tables ytab (dh, Ty)
    and xtab (dw, Tx) on x's device, then `* scale`.  The entries above
    send a CPU tensor to the plain resizes; here it raises."""
    if not on_cuda(x):
        raise ValueError("X1 launches on a CUDA tensor; a CPU tensor takes the plain resize")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    dev = x.device
    iy, wy, ix, wx = ytab.index, ytab.weight, xtab.index, xtab.weight
    for name, t, dt in (("ytab index", iy, torch.int32), ("ytab weight", wy, torch.float32),
                        ("xtab index", ix, torch.int32), ("xtab weight", wx, torch.float32)):
        if t.device != dev or t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dt} tensor on {dev}")
    if iy.shape != wy.shape or ix.shape != wx.shape:
        raise ValueError("each table's index and weight shapes must agree")
    dh, ty = iy.shape
    dw, tx = ix.shape
    if ty < 1 or tx < 1:
        raise ValueError("each table needs at least one tap")
    v = _planes(x)
    n, c, h, w = v.shape
    out = torch.empty(tuple(x.shape[:-2]) + (dh, dw), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if h == 0 or w == 0:
        raise ValueError(f"cannot resample an empty {h}x{w} frame")
    for name, tab, length in (("ytab", ytab, h), ("xtab", xtab, w)):
        if tab.lo < 0 or tab.hi > length:
            raise ValueError(f"{name} reads source [{tab.lo}, {tab.hi}), past a "
                             f"length of {length}")
    sn, sc, sh, sw = v.stride()
    rc = _kernel()(v.data_ptr(), sn, sc, sh, sw, c, n * c, h, w,
                   iy.data_ptr(), wy.data_ptr(), ty, ix.data_ptr(), wx.data_ptr(), tx,
                   int(vertical_first), float(scale), out.data_ptr(), dh, dw,
                   dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "resample")
    LAUNCHES["X1"] += 1
    return out


def resize_bilinear(x: torch.Tensor, dw: int, dh: int,
                    scale: float = 1.0) -> torch.Tensor:
    """`ops/resize.py:resize_bilinear_f32(x, dw, dh) * scale` (no multiply
    at scale 1): one X1 launch, horizontal pass first, on a CUDA tensor;
    the plain version on a CPU tensor."""
    if not on_cuda(x):
        out = resize.resize_bilinear_f32(x, dw, dh)
        return out if scale == 1.0 else out * scale
    sh, sw = x.shape[-2:]
    dev = x.device
    if (dw, dh) == (sw, sh):
        # the plain version returns x itself: both axes pass unchanged
        ytab, xtab = _table("unit", sh, sh, dev), _table("unit", sw, sw, dev)
    else:
        ytab, xtab = _table("bilinear", sh, dh, dev), _table("bilinear", sw, dw, dev)
    return _resample(x.float(), ytab, xtab, False, scale)


def area_plan(sh: int, sw: int, dh: int, dw: int) -> list:
    """The X1 launches of `resize_area_f32(., dw, dh)` from (sh, sw): each
    ((kind, s_len, d_len) vertical, (kind, s_len, d_len) horizontal,
    vertical_first).  The plain version's passes, in its order: an axis
    that shrinks is one area pass; one that grows goes through
    `resize_bilinear_f32`, whose identity pass on the other axis runs too.
    Consecutive passes on different axes share a launch; a pass left alone
    pairs with the other axis's unit table.  Both axes shrinking (the
    seed's case) is one launch; an axis that grows makes two."""
    passes = []                                   # (axis, kind, s_len, d_len)
    h, w = sh, sw
    if resize._area_taps(sh, dh) is not None:
        passes.append(("v", "area", sh, dh))
        h = dh
    elif dh != sh:
        passes += [("h", "bilinear", w, w), ("v", "bilinear", sh, dh)]
        h = dh
    if resize._area_taps(sw, dw) is not None:
        passes.append(("h", "area", sw, dw))
        w = dw
    elif dw != sw:
        passes += [("h", "bilinear", sw, dw), ("v", "bilinear", h, h)]
        w = dw
    launches, k = [], 0
    while k < len(passes):
        first = passes[k]
        second = passes[k + 1] if k + 1 < len(passes) else None
        if second is not None and second[0] != first[0]:
            k += 2
        else:
            n = h if first[0] == "h" else w       # the size along the other axis
            second = ("v" if first[0] == "h" else "h", "unit", n, n)
            k += 1
        vert, horiz = (first, second) if first[0] == "v" else (second, first)
        launches.append((vert[1:], horiz[1:], first[0] == "v"))
    if not launches:                              # the plain version returns x
        launches.append((("unit", sh, sh), ("unit", sw, sw), True))
    return launches


def resize_area(x: torch.Tensor, dw: int, dh: int, scale: float = 1.0) -> torch.Tensor:
    """`ops/resize.py:resize_area_f32(x, dw, dh) * scale`: the launches of
    `area_plan`, the scale on the last, on a CUDA tensor (x strided or
    not); the plain version on a CPU tensor."""
    if not on_cuda(x):
        return resize.resize_area_f32(x, dw, dh) * scale
    sh, sw = x.shape[-2:]
    plan = area_plan(sh, sw, dh, dw)
    out = x.float()
    for k, (vert, horiz, vertical_first) in enumerate(plan):
        out = _resample(out, _table(*vert, out.device), _table(*horiz, out.device),
                        vertical_first, scale if k == len(plan) - 1 else 1.0)
    return out


def bilinear_rows(x: torch.Tensor, dw: int, sh: int, dh: int, a: int, b: int,
                  lo: int, scale: float = 1.0) -> torch.Tensor:
    """Output rows [a, b) of the (sh -> dh, x's width -> dw) bilinear
    resize of a frame, from x, its source rows [lo, lo + x's height), then
    `* scale` (no multiply at scale 1): `ops/resize.py:bilinear_rows` with
    the frame's vertical table shifted to the block, one X1 launch on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not on_cuda(x):
        sy0, sy1, ty = resize.coeff_tensors(sh, dh, x.device)
        out = resize.bilinear_rows(x.float(), dw, sy0[a:b] - lo, sy1[a:b] - lo, ty[a:b])
        return out if scale == 1.0 else out * scale
    dev = x.device
    return _resample(x.float(), _row_block_table(sh, dh, a, b, lo, dev),
                     _table("bilinear", x.shape[-1], dw, dev), False, scale)
