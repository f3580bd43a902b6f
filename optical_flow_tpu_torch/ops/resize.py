"""Bilinear resize with cv2.resize INTER_LINEAR float-path semantics.

Port of `optical_flow_tpu.ops.resize` (`_coeffs_f32`,
`resize_bilinear_f32`): half-pixel centres and edge clamp.  The pyramid
uses it for the x2 flow upsample between levels, in plain PyTorch on every
device, as the JAX package leaves it to plain XLA.  It is also the second
half of the plain version of the `gauss_resize` kernel.
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
