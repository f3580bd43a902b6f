"""K1: one fused Farnebäck iterate step (`csrc/update_blur.cu`), K5a: the
update matrices alone (`csrc/update_matrices.cu`), and K7: the step from
the level images (`csrc/update_blur_poly.cu`).

K1 replaces `optical_flow_tpu/pallas/update_gather.py`
(`fused_update_blur_store`, `:956`, and its column-chunked form for
frames wider than the TPU's 4096 lanes, `fused_update_blur_store_chunked`,
`:1385`): displaced fetch of R1 -> M = (G11, G12, G22, h1, h2) with
border weights -> winsize^2 box or Gaussian window sum with replicate
borders -> 2x2 solve, in one launch, at any width.  The Gaussian window
sums with its taps in K5b's order (`kernels/blur_solve.py`), so K1 equals
K5a -> K5b to the bit with either window.  The TPU kernel's candidate
blocks, anchors and spill tiers exist because the TPU has no fast gather;
on the card the fetch is a plain clamped load, exact by construction, so
none of that is ported, and neither is the column chunking.

Its floor on the card is device-memory traffic, 56 B/px per step (R0 and
the flow read, the R1 gather, the new flow written), because M never
leaves shared memory.  A block owns a 32-column strip and walks down
32 to 256 output rows (`_rows_per_block`: enough blocks to fill the
card), building M once per row over the strip plus its window halo,
summing each row horizontally into a ring of the last winsize + 31 rows
and each output row vertically from the ring; both sums are
register-blocked four outputs a thread, each still in tap order.  That
is 1.5 M evaluations per output pixel at winsize 15 with 256-row blocks
(the former 32x32 tile: 2.1), and a third of the former shared-memory
reads.  What is left above the traffic floor is building M: its loads,
three pixels a thread in flight, at three blocks an SM.  Measured at the
1080p levels (PERF.md, K1), the build alone takes 85 % of the run-time
kernel's step with the box window and 74 % with the Gaussian one, and
the sums add the time their instructions do not hide under the build's
loads.  At winsize 15 (`k1_fixed`: winsize // 2 == 7, the reference's
window) the wrapper launches the instantiation with the window built in:
both sums unrolled whole, the Gaussian taps passed as kernel parameters,
the build's strides constant and its border weights computed only on the
frame's 5-px border.  It cuts the sums alone by a quarter and the step
by 12 % (box) and 16 % (Gaussian), and its flow equals the run-time
kernel's, and K5a -> K5b's, to the bit; `kernels.FIXED_WINDOW["K1"]`
counts its launches.  The shared memory bounds the window; the route
keeps K1 to winsize <= 61: `k1_fits`.

K5a replaces `update_matrices_pallas_batched_stats` (`:1851`, with its
column-chunked build `:1714` for wide frames and the store-layout entry
`:2007`): the same M, one thread per pixel, written to device memory for
K5b (`kernels/blur_solve.py`), at any width.

K7 (`csrc/update_blur_poly.cu`) replaces `fused_update_blur_store_poly`
(`:1145`): K1 from the level images, with R0 and R1 expanded inside the
step by K2's arithmetic (`csrc/polyexp.cuh`), so R never exists in device
memory and the flow equals K2 -> K1 to the bit.  It trades K2's R traffic
for arithmetic.  A block (a 64 x 32 output tile where it fits, else
32 x 32: `_k7_tile`) expands img0 separably over its M pixels (the tile
plus the window's halo), and img1's vertical correlations once over the
bounding box of its fetch targets, cut to what its shared memory holds
(`_k7_plan`), then over the bounds of the targets left, up to three
boxes; a target left outside them takes R1 from its own (2n+1)^2 window
in device memory.  M on the tile plus its halo bounds winsize and
poly_n: `k7_fits`.  `update_blur_poly_counted` also counts the M pixels
of each path.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import (FIXED_WINDOW, LAUNCHES, MAX_SMEM, _build,
                                            check, on_cuda, output, raise_on_error,
                                            sm_count)
from optical_flow_tpu_torch.kernels.blur_solve import window_taps
from optical_flow_tpu_torch.kernels.polyexp import expansion_consts
from optical_flow_tpu_torch.models.farneback import core

_K7_ROWS = 32       # K7's output rows per block (TY in update_blur_poly.cu)
_K7_TILE_W = 64     # its output columns per block by default (kDefaultTile)
_K7_TWO_BLOCKS = 228 * 1024 // 2 - 1024   # a block's share at two an SM
_STRIP = 32         # K1's strip width and rows built per pass (SW, G)
_K1_MAX_WINSIZE = 61
_K1_FIXED_M = 7     # the half-width K1 has built in (kFixedM): winsize 15


def k1_smem(winsize: int) -> int:
    """K1's shared memory per block, as `smem_floats` in update_blur.cu:
    M on 32 rows of the strip plus its halo, the ring of horizontal sums,
    the window taps."""
    m = winsize // 2
    return 4 * (5 * _STRIP * (_STRIP + 2 * m + 1) + 5 * (2 * m + _STRIP) * (_STRIP + 1)
                + 2 * m + 1)


def k1_fits(winsize: int) -> bool:
    """Whether K1 takes the window: winsize <= 61.  Its shared memory
    would take windows up to 145; the route keeps the larger ones on
    K5a -> K5b, as before."""
    return winsize <= _K1_MAX_WINSIZE and k1_smem(winsize) <= MAX_SMEM


def _rows_per_block(B: int, h: int, w: int, device: torch.device) -> int:
    """Output rows each K1 block walks: the most of 256, 128, 64 and 32
    that still gives six blocks per SM (two waves at three resident
    blocks), so small levels trade some vertical halo for a full card."""
    strips = -(-w // _STRIP)
    for rows in (256, 128, 64):
        if B * strips * -(-h // rows) >= 6 * sm_count(device):
            return rows
    return _STRIP


def _k7_plan(winsize: int, poly_n: int, tile_w: int = _K7_TILE_W):
    """K7's launch at `tile_w` output columns, as `plan` in
    update_blur_poly.cu: (shared-memory bytes, floats of the region X
    that the staged images, their vertical sums and the row sums take in
    turn), or None where M on the tile plus its halo, the taps and the
    larger of img0 staged with the expansion's halo and the row sums do
    not fit a block.  Two blocks an SM where X holds img0's vertical sums
    of every M row at once, else the whole 227 KB; X beyond that caps the
    fetch box."""
    m, n = winsize // 2, poly_n
    mh, mw = _K7_ROWS + 2 * m, tile_w + 2 * m
    ms = 5 * mh * mw + 2 * m + 1
    u0 = (mh + 2 * n) * (mw + 2 * n)
    hs = 5 * mh * tile_w
    full = u0 + 3 * (mw + 2 * n + 3) * mh
    if 4 * (ms + max(u0, hs)) > MAX_SMEM:
        return None
    nbytes = _K7_TWO_BLOCKS if 4 * (ms + max(full, hs)) <= _K7_TWO_BLOCKS else MAX_SMEM
    return nbytes, nbytes // 4 - ms


def _k7_tile(winsize: int, poly_n: int) -> int:
    """The tile width a default launch takes (`default_tile`)."""
    return _K7_TILE_W if _k7_plan(winsize, poly_n, _K7_TILE_W) else 32


def k7_fits(winsize: int, poly_n: int) -> bool:
    """Whether K7 takes the window and the expansion: poly_n within its
    constants (<= 96) and a plan at 32 columns, which holds at poly_n 5
    and 7 for any winsize up to 61, as K1."""
    return 1 <= poly_n <= 96 and _k7_plan(winsize, poly_n, 32) is not None


@functools.lru_cache(maxsize=None)
def _k1():
    f = _build.library("update_blur").oft_update_blur
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, p, i, i, i, i, p, p, ctypes.c_float, i, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=None)
def _host_taps(winsize: int) -> np.ndarray:
    """The Gaussian window's taps in host memory, the values
    `window_taps` puts on the device: the fixed instantiation takes them
    as a kernel parameter."""
    return np.ascontiguousarray(core.gaussian_window_kernel(winsize), np.float32)


def k1_fixed(winsize: int) -> bool:
    """Whether K1 runs the instantiation with the window's half-width
    built in: winsize // 2 == 7 (winsize 15, the reference's)."""
    return winsize // 2 == _K1_FIXED_M


@functools.lru_cache(maxsize=None)
def _k7():
    f = _build.library("update_blur_poly").oft_update_blur_poly
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, i, p, p, i, i, i, i, i, p, ctypes.c_float, p, i, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=None)
def _k7_counted():
    f = _build.library("update_blur_poly").oft_update_blur_poly_counted
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, i, p, p, i, i, i, i, i, p, ctypes.c_float, p, i, i, p, i, p]
    f.restype = i
    return f


@functools.lru_cache(maxsize=None)
def _k5a():
    f = _build.library("update_matrices").oft_update_matrices
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, p, i, i, i, i, p]
    f.restype = i
    return f


def _check_operands(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor):
    """(B, H, W) of a step's CUDA operands, or raise."""
    dev = flow.device
    check(flow, "flow", dev, (torch.float32,), 4)
    B, two, h, w = flow.shape
    if two != 2:
        raise ValueError(f"flow has shape {tuple(flow.shape)}, expected (B, 2, H, W)")
    for name, t in (("R0", R0), ("R1", R1)):
        check(t, name, dev, (torch.float32,), 4)
        if t.shape != (B, 5, h, w):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, 5, h, w)}")
    return B, h, w


def update_blur(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                winsize: int, gaussian: bool = False,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K1, one iterate step: R0, R1 (B, 5, H, W), flow (B, 2, H, W) f32 ->
    new flow (B, 2, H, W) f32, with the box window or, with `gaussian`,
    the Gaussian one (winsize >= 2); written to `out` when given (CUDA
    only; it must not be `flow`, whose neighbours the step still reads).
    Where `k1_fixed(winsize)`, the instantiation with the window built in."""
    if not on_cuda(flow):
        if out is not None:
            raise ValueError("out= is for CUDA tensors")
        return core.update_step(R0, R1, flow, winsize, gaussian)
    B, h, w = _check_operands(R0, R1, flow)
    if not k1_fits(winsize):
        raise ValueError(f"winsize {winsize} is too large for the kernel's tile "
                         "(update_matrices + blur_solve take any winsize)")
    dev = flow.device
    taps = window_taps(winsize, True, dev) if gaussian else None
    scale = 1.0 if gaussian else float(np.float32(1.0 / (winsize * winsize)))
    out = output(out, flow.shape, dev, flow)
    if flow.numel() == 0:
        return out
    fixed = k1_fixed(winsize)
    host_taps = _host_taps(winsize) if fixed and gaussian else None
    rc = _k1()(R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), out.data_ptr(),
               B, h, w, winsize // 2, None if taps is None else taps.data_ptr(),
               None if host_taps is None else host_taps.ctypes.data,
               scale, _rows_per_block(B, h, w, dev), int(fixed), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "update_blur")
    LAUNCHES["K1"] += 1
    FIXED_WINDOW["K1"] += fixed
    return out


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K5a: R0, R1 (B, 5, H, W), flow (B, 2, H, W) f32 -> M (B, 5, H, W)
    f32, written to `out` when given (CUDA only; not an input's buffer)."""
    if not on_cuda(flow):
        if out is not None:
            raise ValueError("out= is for CUDA tensors")
        return core.update_matrices(R0, R1, flow)
    B, h, w = _check_operands(R0, R1, flow)
    out = output(out, (B, 5, h, w), flow.device, R0, R1, flow)
    if out.numel() == 0:
        return out
    dev = flow.device
    rc = _k5a()(R0.data_ptr(), R1.data_ptr(), flow.data_ptr(), out.data_ptr(),
                B, h, w, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(rc, "update_matrices")
    LAUNCHES["K5a"] += 1
    return out


def update_blur_poly(img0: torch.Tensor, img1: torch.Tensor, flow: torch.Tensor,
                     winsize: int, gaussian: bool, poly_n: int, poly_sigma: float,
                     pre_taps=None, out: torch.Tensor | None = None) -> torch.Tensor:
    """K7, one iterate step from the level images: img0, img1 (B, H, W)
    uint8 or f32 (both the same; with `pre_taps`, the level-0 3-tap
    pre-smooth runs first), flow (B, 2, H, W) f32 -> new flow (B, 2, H, W)
    f32, with the box or the Gaussian window; written to `out` when given
    (CUDA only; not `flow`).  Equal to K2 on both images, then K1."""
    if not on_cuda(flow):
        if out is not None:
            raise ValueError("out= is for CUDA tensors")
        return core.update_step_poly(img0, img1, flow, winsize, gaussian,
                                     poly_n, poly_sigma, pre_taps)
    return _launch_k7(img0, img1, flow, winsize, gaussian, poly_n, poly_sigma,
                      pre_taps, out)


def update_blur_poly_counted(img0: torch.Tensor, img1: torch.Tensor,
                             flow: torch.Tensor, winsize: int, gaussian: bool,
                             poly_n: int, poly_sigma: float, pre_taps=None,
                             tile_w: int | None = None):
    """K7 on CUDA tensors at `tile_w` output columns (32 or 64; None: the
    default launch's), and how its M pixels took R1: (new flow, {"per_pixel":
    from img1 in device memory, "boxed": from the block's fetch boxes,
    "m_pixels": every M pixel the blocks evaluated}).  A measurement entry
    (chip_smoke.py, the card tests); the flow equals update_blur_poly's."""
    if not on_cuda(flow):
        raise ValueError("the fetch counts come from the kernel: CUDA tensors only")
    counts = torch.zeros(3, dtype=torch.int64, device=flow.device)
    out = _launch_k7(img0, img1, flow, winsize, gaussian, poly_n, poly_sigma,
                     pre_taps, None, tile_w or _k7_tile(winsize, poly_n), counts)
    per_pixel, boxed, total = counts.tolist()
    return out, {"per_pixel": per_pixel, "boxed": boxed, "m_pixels": total}


def _launch_k7(img0, img1, flow, winsize, gaussian, poly_n, poly_sigma, pre_taps,
               out, tile_w=None, counts=None):
    """update_blur_poly's launch on CUDA tensors: the default entry, or at
    `tile_w` columns the counted one, adding to `counts` (a device int64
    (3,))."""
    dev = flow.device
    check(flow, "flow", dev, (torch.float32,), 4)
    B, two, h, w = flow.shape
    if two != 2:
        raise ValueError(f"flow has shape {tuple(flow.shape)}, expected (B, 2, H, W)")
    for name, t in (("img0", img0), ("img1", img1)):
        check(t, name, dev, (torch.uint8, torch.float32), 3)
        if t.shape != (B, h, w):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(B, h, w)}")
    if img0.dtype != img1.dtype:
        raise TypeError(f"img0 is {img0.dtype}, img1 {img1.dtype}")
    consts = expansion_consts(poly_n, poly_sigma, pre_taps, h, w)
    if not k7_fits(winsize, poly_n):
        raise ValueError(f"winsize {winsize} with poly_n {poly_n} does not fit "
                         "the kernel's tile (K2 -> K1 or K5a -> K5b take it)")
    taps = window_taps(winsize, True, dev) if gaussian else None
    scale = 1.0 if gaussian else float(np.float32(1.0 / (winsize * winsize)))
    out = output(out, flow.shape, dev, flow)
    if flow.numel() == 0:
        return out
    if tile_w is not None and (tile_w not in (32, 64)
                               or _k7_plan(winsize, poly_n, tile_w) is None):
        raise ValueError(f"winsize {winsize} with poly_n {poly_n} does not fit "
                         f"a {tile_w}-column tile")
    args = (img0.data_ptr(), img1.data_ptr(), int(img0.dtype == torch.uint8),
            flow.data_ptr(), out.data_ptr(), B, h, w, winsize // 2, poly_n,
            None if taps is None else taps.data_ptr(), scale, consts,
            int(pre_taps is not None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tile_w is None:
        rc = _k7()(*args, dev.index, stream)
    else:
        rc = _k7_counted()(*args, tile_w, counts.data_ptr(), dev.index, stream)
    raise_on_error(rc, "update_blur_poly")
    LAUNCHES["K7"] += 1
    return out
