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

The host plans each launch (`plan`) from the tables' per-tile spans,
which each cached `Table` carries, and from x's strides: the band kernel
(the bilinear resizes: a tile's tables staged in shared memory once, its
source band once a plane with the next plane's in flight, 4 outputs and
one 16-byte store a thread), the columns kernel (INTER_AREA on the seed:
source rows streamed into the tile's vertical sums, its (B, H, W, 2)
layout two pixels of both channels a 16-byte load), or the generic
kernel (an output a thread) for the other tables and layouts, and where
the band would not fit, no source pixel is read twice, or the tiles
would mostly cover nothing (the levels=5 resizes, the 72x129 frames).
`tests/test_torch_kernel_tiles.py:emulate_x1` repeats each plan in
numpy.  No path is a fallback: the plan is fixed by the shapes before
the launch, and a failing launch raises.

`resize_bilinear`, `resize_area` and `bilinear_rows` are the entries:
each runs the plain version on a CPU tensor and X1 on a CUDA tensor.
Each table carries the source span its indices reach, which the launch
checks against the frame it is given, so that no table reads past it;
its dtypes, shape and device are fixed where it is made, once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, device_cache,
                                            on_cuda, raise_on_error)
from optical_flow_tpu_torch.ops import resize

@functools.lru_cache(maxsize=None)
def _kernel():
    f = _build.library("resample").oft_resample
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f.argtypes = [p, q, q, q, q, i, i, i, i, p, p, i, p, p, i, i, ctypes.c_float, p,
                  i, i, i, i, i, i, i, i, i, p]
    f.restype = i
    return f


# `csrc/resample.cu`: output columns a tile of the band and columns
# kernels, the tile lengths whose spans a table carries (1 to TILE_W
# outputs, powers of two), and the dynamic shared memory a block may
# take (its SMEM: the 48 KB a block has without an opt-in, less the 16
# bytes those kernels declare statically).
TILE_W = 128
TILE_LENGTHS = tuple(1 << k for k in range(TILE_W.bit_length()))
SMEM = 48 * 1024 - 16
PATHS = {"generic": 0, "band": 1, "columns": 2}


class Table(NamedTuple):
    """An axis's taps on one device: (d_len, T) int32 source indices and
    f32 weights, the source span [lo, hi) the indices reach, `spans[k]`
    the largest span (max - min + 1) of the indices of a tile of
    TILE_LENGTHS[k] consecutive outputs (tiles from output 0), and
    `shape` = (d_len, T, spans), what `plan` reads of the table."""
    index: torch.Tensor
    weight: torch.Tensor
    lo: int
    hi: int
    spans: tuple
    device: torch.device
    shape: tuple


def _to_table(idx: np.ndarray, wt: np.ndarray, device: torch.device) -> Table:
    """The table on `device`, checked once here: X1 reads it as it is at
    every launch."""
    idx = np.ascontiguousarray(idx, np.int32)
    wt = np.ascontiguousarray(wt, np.float32)
    if idx.ndim != 2 or idx.shape != wt.shape or idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError(f"a table is (d_len, T >= 1) indices and weights, got "
                         f"{idx.shape} and {wt.shape}")
    first, last = idx.min(1), idx.max(1)
    spans = []
    for n in TILE_LENGTHS:
        starts = np.arange(0, len(idx), n)
        spans.append(int((np.maximum.reduceat(last, starts)
                          - np.minimum.reduceat(first, starts)).max()) + 1)
    lo, hi = int(first.min()), int(last.max()) + 1
    return Table(torch.as_tensor(idx, device=device), torch.as_tensor(wt, device=device),
                 lo, hi, tuple(spans), torch.device(device), (*idx.shape, tuple(spans)))


@device_cache(512)
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


@device_cache(512)
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


class Plan(NamedTuple):
    """One X1 launch as the host plans it (`plan`): the kernel ("band":
    the horizontal pass first from a staged band; "columns": the vertical
    pass first, rows streamed; "generic": an output a thread), the floats
    a source load moves (4: 16 bytes of a plane's row; 2: 16 bytes of a
    (B, H, W, 2) layout, both channels of 2 pixels; 1: one, any strides),
    the tile's output rows (its columns are TILE_W), the staged band's
    rows (band) and columns a row (band; columns: the vertical sums' row,
    a channel), and the block's dynamic shared memory in bytes.  The C
    entry cuts the planes (pairs of planes where load is 2) into groups
    from the card's resident blocks (`plane_groups`), each block walking
    its group's planes with the tile's tables staged once."""
    path: str
    load: int
    tile_h: int
    band_h: int
    band_w: int
    smem: int


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _tiled(dh: int, dw: int, tile_h: int) -> bool:
    """Whether tile_h x TILE_W tiles cover a dh x dw plane with at most
    half again its area: past that (a 129-wide frame's second column of
    tiles is 1 wide) the tiles' staging costs more than their reuse
    saves, and the generic kernel runs."""
    return 2 * (-(-dh // tile_h) * tile_h) * (-(-dw // TILE_W) * TILE_W) <= 3 * dh * dw


@functools.lru_cache(maxsize=1024)
def _plan(vertical_first: bool, load: int, ytab: tuple, xtab: tuple) -> Plan:
    """`plan` from the launch's shape: ytab, xtab = the tables' `shape`,
    (outputs, taps, spans)."""
    (dh, ty, yspans), (dw, tx, xspans) = ytab, xtab
    col_span = xspans[-1]
    tables = 8 * TILE_W * tx
    if not vertical_first and ty == tx == 2:
        load = 4 if load == 4 else 1
        band_w = _round4(col_span + (3 if load == 4 else 0))
        for tile_h in (16, 8):
            band_h = yspans[TILE_LENGTHS.index(tile_h)]
            smem = 2 * 4 * band_h * band_w + 8 * tile_h * ty + tables
            # staging pays where the tile's taps read its band more than
            # once over (not at a /2 downsample, whose taps meet each
            # source pixel once)
            reused = band_h * band_w < min(tile_h, dh) * min(TILE_W, dw) * ty * tx
            if smem <= SMEM and reused and _tiled(dh, dw, tile_h):
                return Plan("band", load, tile_h, band_h, band_w, smem)
    elif vertical_first and load < 4:
        channels = load
        band_w = _round4(col_span + load - 1)
        pitch = band_w + band_w // 32            # a word of padding every 32
        for tile_h in (8, 4, 2, 1):
            smem = 4 * channels * tile_h * pitch + 8 * tile_h * ty + tables
            if channels * tile_h <= 8 and smem <= SMEM and _tiled(dh, dw, tile_h):
                return Plan("columns", load, tile_h, 0, band_w, smem)
    return Plan("generic", 1, 0, 0, 0, 0)


def plan(x: torch.Tensor, ytab: Table, xtab: Table, vertical_first: bool) -> Plan:
    """The X1 launch for x (..., H, W) and the tables, decided on the host
    before the launch from the tables' shapes and x's strides (the same on
    a CPU tensor).  The band kernel takes the horizontal pass first with
    both tables bilinear (2 taps), the columns kernel the vertical pass
    first on the (B, H, W, 2) layout (C == 2, channel stride 1, column
    stride 2: the seed) or on element loads, each where the tile's band
    fits SMEM (a bilinear downsample past about 2x does not: its taps
    skip rows and columns), the band kernel's taps read its band more
    than once over, and the tiles cover the output planes without much
    waste (`_tiled`); the generic kernel takes the rest (unit tables, an
    axis that grows, INTER_AREA on planar rows).  The band kernel loads 16
    bytes where x's planes and rows are 16-byte aligned with unit column
    stride, the columns kernel 16 bytes of the (B, H, W, 2) layout; else
    one float."""
    v = _planes(x)
    return _plan(vertical_first, _load(v.data_ptr(), v.shape[1], v.stride()),
                 ytab.shape, xtab.shape)


def _load(ptr: int, c: int, strides: tuple) -> int:
    """The floats a load moves for planes at ptr with C = c and (N, C, H,
    W) strides: 4 (a plane's row), 2 (the (B, H, W, 2) layout) or 1."""
    sn, sc, sh, sw = strides
    if ptr % 16 or sn % 4 or sh % 4:
        return 1
    if sw == 1 and sc % 4 == 0:
        return 4
    return 2 if c == 2 and sc == 1 and sw == 2 else 1


def _resample(x: torch.Tensor, ytab: Table, xtab: Table, vertical_first: bool,
              scale: float = 1.0) -> torch.Tensor:
    """One X1 launch: (..., H, W) f32 on the card, any strides ->
    contiguous (..., dh, dw) f32, resampled by the tables ytab (dh, Ty)
    and xtab (dw, Tx) on x's device, then `* scale`, by the kernel `plan`
    picks.  The entries above send a CPU tensor to the plain resizes;
    here it raises."""
    if not on_cuda(x):
        raise ValueError("X1 launches on a CUDA tensor; a CPU tensor takes the plain resize")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    dev = x.device
    if ytab.device != dev or xtab.device != dev:
        raise ValueError(f"the tables are on {ytab.device} and {xtab.device}, x on {dev}")
    dh, ty, _ = ytab.shape
    dw, tx, _ = xtab.shape
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
    ptr, strides = v.data_ptr(), v.stride()
    pl = _plan(vertical_first, _load(ptr, c, strides), ytab.shape, xtab.shape)
    rc = _kernel()(ptr, *strides, c, n * c, h, w,
                   ytab.index.data_ptr(), ytab.weight.data_ptr(), ty,
                   xtab.index.data_ptr(), xtab.weight.data_ptr(), tx,
                   int(vertical_first), float(scale), out.data_ptr(), dh, dw,
                   PATHS[pl.path], pl.load, pl.tile_h, pl.band_h, pl.band_w, pl.smem,
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
