"""Host-side (numpy) twins of the uint8 preprocessing, copies of
`optical_flow_tpu.ops.host` (`bgr2gray_host`, `resize_u8_host`,
`resize_gray_host`).

They run inside the decode worker threads, so resize and grayscale
overlap decode and the device upload is the small gray frame (at the
extractor's default width 129, a 9 KB frame where a 720p BGR frame is
2.7 MB).  Integer for integer they are cv2's uint8 paths.
"""

from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.ops.color import gray_coeffs
from optical_flow_tpu_torch.ops.resize import _coeffs_u8, aspect_preserving_size


def bgr2gray_host(bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR (..., 3) -> uint8 gray (...); the fixed point of
    `ops/color.py:bgr2gray_u8` (reference behavior: `optical_flow.py:44`)."""
    b2y, g2y, r2y, shift = gray_coeffs()
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (b * b2y + g * g2y + r * r2y + (1 << (shift - 1))) >> shift
    return y.astype(np.uint8)


def resize_u8_host(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """cv2.resize uint8 INTER_LINEAR fixed-point path on the host.

    src: (H, W) or (H, W, C) uint8: Q11 weights, the horizontal pass in
    int32, the vertical ((b0*(r0>>4))>>16 + (b1*(r1>>4))>>16 + 2) >> 2.
    """
    sh, sw = src.shape[0], src.shape[1]
    if (dw, dh) == (sw, sh):
        return src
    sx0, sx1, ax0, ax1 = _coeffs_u8(sw, dw)
    sy0, sy1, by0, by1 = _coeffs_u8(sh, dh)
    s = src.astype(np.int32)
    wshape = (1, dw) + (1,) * (s.ndim - 2)
    row = (s[:, sx0] * ax0.reshape(wshape)
           + s[:, sx1] * ax1.reshape(wshape))
    r0 = row[sy0] >> 4
    r1 = row[sy1] >> 4
    hshape = (dh, 1) + (1,) * (s.ndim - 2)
    acc = ((by0.reshape(hshape) * r0) >> 16) + ((by1.reshape(hshape) * r1)
                                                >> 16)
    out = (acc + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_gray_host(frame_bgr: np.ndarray, frame_width: int) -> np.ndarray:
    """`resize_frame` + BGR2GRAY (`optical_flow.py:25-31,44`) on the host:
    aspect-preserving uint8 resize to frame_width, then grayscale."""
    sh, sw = frame_bgr.shape[0], frame_bgr.shape[1]
    dw, dh = aspect_preserving_size(sh, sw, frame_width)
    return bgr2gray_host(resize_u8_host(frame_bgr, dw, dh))
