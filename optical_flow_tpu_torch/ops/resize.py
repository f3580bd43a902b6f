"""Resizes with cv2.resize semantics.

Port of `optical_flow_tpu.ops.resize` (`_coeffs_f32`,
`resize_bilinear_f32`, `_coeffs_u8`, `resize_u8_cv`,
`aspect_preserving_size`, `resize_frame_u8`, `_area_weights`,
`resize_area_f32`).  `ops/host.py` runs the extractor's frame resize on
the host with the same `_coeffs_u8`; `resize_u8_cv` is its twin on a
tensor's device, used by no pipeline, as in the JAX package.  Bilinear:
half-pixel centres and edge clamp; the pyramid uses it for the x2 flow
upsample between levels, and it is the second half of the plain version
of the `gauss_resize` kernel.  INTER_AREA: the seeded entry's downsample
of the initial flow.  Both run in plain PyTorch on every device, as the
JAX package leaves them to plain XLA, and neither goes through a matrix
product, so no TF32 setting changes them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _coeffs_f32(s_len: int, d_len: int):
    """(s0, s1, t): the two source indices and the f32 weight of s1 for
    each of the d_len output samples."""
    scale = s_len / d_len
    f = (np.arange(d_len) + 0.5) * scale - 0.5
    s0 = np.floor(f).astype(np.int32)
    t = (f - s0).astype(np.float32)
    t[s0 < 0] = 0.0
    s0[s0 < 0] = 0
    t[s0 >= s_len - 1] = 1.0
    s0[s0 >= s_len - 1] = max(s_len - 2, 0)
    s1 = np.minimum(s0 + 1, s_len - 1)
    return s0, s1, t


@functools.lru_cache(maxsize=256)
def _coeffs_u8(s_len: int, d_len: int):
    """(s0, s1, a0, a1): cv2's uint8 INTER_LINEAR source indices and Q11
    fixed-point weights, from the f32 sample position (rint, half to
    even)."""
    scale = s_len / d_len
    f = ((np.arange(d_len) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int32)
    t = f - s0.astype(np.float32)
    t[s0 < 0] = 0.0
    s0[s0 < 0] = 0
    t[s0 >= s_len - 1] = 1.0
    s0[s0 >= s_len - 1] = max(s_len - 2, 0)
    a1 = np.rint(t * np.float32(2048)).astype(np.int32)
    a0 = np.rint((np.float32(1.0) - t) * np.float32(2048)).astype(np.int32)
    s1 = np.minimum(s0 + 1, s_len - 1)
    return s0, s1, a0, a1


def aspect_preserving_size(src_h: int, src_w: int, frame_width: int):
    """Target (width, height) as the reference computes it
    (`optical_flow.py:25-29`): ratio = W/H; new_h = int(frame_width /
    ratio), truncated."""
    ratio = src_w / src_h
    return frame_width, int(frame_width / ratio)


def resize_bilinear_f32(src: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """cv2.resize(src_f32, (dw, dh), INTER_LINEAR) float-path semantics.

    src: (..., H, W) float32.  Resizes the trailing two axes: the
    horizontal pass first, then the vertical, as the JAX version does.
    """
    sh, sw = src.shape[-2:]
    if (dw, dh) == (sw, sh):
        return src
    dev = src.device
    sx0, sx1, tx = (torch.as_tensor(a, device=dev) for a in _coeffs_f32(sw, dw))
    sy0, sy1, ty = (torch.as_tensor(a, device=dev) for a in _coeffs_f32(sh, dh))
    sx0, sx1, sy0, sy1 = (a.long() for a in (sx0, sx1, sy0, sy1))
    row = (src.index_select(-1, sx0) * (1.0 - tx)
           + src.index_select(-1, sx1) * tx)
    ty = ty[:, None]
    return (row.index_select(-2, sy0) * (1.0 - ty)
            + row.index_select(-2, sy1) * ty)


def resize_u8_cv(src: torch.Tensor, dw: int, dh: int,
                 channels_last: bool | None = None) -> torch.Tensor:
    """cv2.resize uint8 INTER_LINEAR fixed-point path, bit-exact
    (downscale), on the tensor's device.

    src: (H, W) uint8, or (H, W, C) uint8 when channels_last=True (the
    default for 3-D input); otherwise the trailing two axes are (H, W) and
    any leading axes are a batch.  The horizontal pass in int32 with the
    Q11 weights, `>> 4`, the vertical pass `>> 16` per term, then
    `(acc + 2) >> 2`, as the JAX version computes it."""
    if channels_last is None:
        channels_last = src.dim() == 3
    if channels_last and src.dim() == 3:
        h_ax, w_ax = 0, 1
    else:
        h_ax, w_ax = src.dim() - 2, src.dim() - 1
    sh, sw = src.shape[h_ax], src.shape[w_ax]
    if (dw, dh) == (sw, sh):
        return src
    dev = src.device
    sx0, sx1, ax0, ax1 = (torch.as_tensor(a, device=dev) for a in _coeffs_u8(sw, dw))
    sy0, sy1, by0, by1 = (torch.as_tensor(a, device=dev) for a in _coeffs_u8(sh, dh))
    s = src.to(torch.int32)
    shape_w = [1] * s.dim()
    shape_w[w_ax] = dw
    row = (s.index_select(w_ax, sx0.long()) * ax0.reshape(shape_w)
           + s.index_select(w_ax, sx1.long()) * ax1.reshape(shape_w))
    r0 = row.index_select(h_ax, sy0.long()) >> 4
    r1 = row.index_select(h_ax, sy1.long()) >> 4
    shape_h = [1] * s.dim()
    shape_h[h_ax] = dh
    acc = ((by0.reshape(shape_h) * r0) >> 16) + ((by1.reshape(shape_h) * r1) >> 16)
    return ((acc + 2) >> 2).clamp(0, 255).to(torch.uint8)


def resize_frame_u8(frame: torch.Tensor, frame_width: int) -> torch.Tensor:
    """The reference's `resize_frame` (`optical_flow.py:25-31`): an
    aspect-preserving uint8 resize of an (H, W[, C]) frame to the given
    width, on the frame's device."""
    if frame.dim() == 3:
        sh, sw = frame.shape[0], frame.shape[1]
    else:
        sh, sw = frame.shape[-2], frame.shape[-1]
    dw, dh = aspect_preserving_size(sh, sw, frame_width)
    return resize_u8_cv(frame, dw, dh)


@functools.lru_cache(maxsize=128)
def _area_weights(s_len: int, d_len: int):
    """Dense per-axis INTER_AREA weight matrix (d_len, s_len), numpy f32,
    as the JAX package builds it: true area averaging for a downscale (each
    output averages its source footprint with fractional-overlap weights);
    None for an upscale, where cv2 falls back to bilinear."""
    if d_len >= s_len:
        return None
    scale = s_len / d_len
    Wm = np.zeros((d_len, s_len), dtype=np.float64)
    for d in range(d_len):
        lo = d * scale
        hi = (d + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, s_len)):
            ov = min(hi, i + 1) - max(lo, i)
            if ov > 0:
                Wm[d, i] = ov
    Wm /= scale
    return Wm.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _area_taps(s_len: int, d_len: int):
    """The nonzero entries of `_area_weights` as (index, weight) columns,
    each (d_len, T) with T <= ceil(scale) + 1, in increasing source index;
    short rows are padded with weight 0 at index 0.  None for an upscale."""
    Wm = _area_weights(s_len, d_len)
    if Wm is None:
        return None
    rows = [np.flatnonzero(r) for r in Wm]
    T = max(len(r) for r in rows)
    idx = np.zeros((d_len, T), np.int64)
    wt = np.zeros((d_len, T), np.float32)
    for d, r in enumerate(rows):
        idx[d, :len(r)] = r
        wt[d, :len(r)] = Wm[d, r]
    return idx, wt


def _area_along(src: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """Weighted sum of each output's source taps along `dim` (-2 or -1),
    in f32, tap by tap in increasing source index."""
    idx, wt = (torch.as_tensor(a, device=src.device) for a in taps)
    shape = (-1, 1) if dim == -2 else (-1,)
    out = None
    for t in range(idx.shape[1]):
        term = src.index_select(dim, idx[:, t]) * wt[:, t].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_area_f32(src: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """cv2.resize(src_f32, (dw, dh), INTER_AREA) semantics for float input.

    src: (..., H, W) float32.  The vertical axis first, then the
    horizontal, as the JAX version does; an axis that grows goes through
    the bilinear resize, as cv2 does.  The JAX version multiplies by the
    dense weight matrix; here each output gathers its few nonzero taps."""
    sh, sw = src.shape[-2:]
    if (dw, dh) == (sw, sh):
        return src
    out = src.float()
    ty, tx = _area_taps(sh, dh), _area_taps(sw, dw)
    if ty is not None:
        out = _area_along(out, -2, ty)
    elif dh != sh:
        out = resize_bilinear_f32(out, out.shape[-1], dh)
    if tx is not None:
        out = _area_along(out, -1, tx)
    elif dw != sw:
        out = resize_bilinear_f32(out, dw, out.shape[-2])
    return out
