"""Host-side (numpy) twin of the grayscale conversion, a copy of
`optical_flow_tpu.ops.host.bgr2gray_host`.

It runs inside the decode worker threads, so the conversion overlaps
decode and the device upload is one channel, not three.
"""

from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.ops.color import gray_coeffs


def bgr2gray_host(bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR (..., 3) -> uint8 gray (...); the fixed point of
    `ops/color.py:bgr2gray_u8` (reference behavior: `optical_flow.py:44`)."""
    b2y, g2y, r2y, shift = gray_coeffs()
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (b * b2y + g * g2y + r * r2y + (1 << (shift - 1))) >> shift
    return y.astype(np.uint8)
