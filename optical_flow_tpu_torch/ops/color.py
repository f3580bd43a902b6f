"""Color conversions with OpenCV's integer semantics, a port of
`optical_flow_tpu.ops.color`.

  * BGR2GRAY: 15-bit fixed point (b*3735 + g*19235 + r*9798 + 2^14) >> 15,
    or the cv2 4.2 14-bit constants under OFT_CV42_GRAY=1.
  * HSV2BGR on uint8 (cv2's vectorized path): s and v scaled by f32(1/255),
    the hue sector arithmetic in f32, the final value*255 truncated.

`hsv2bgr_planes` is the HSV->BGR math on planes; `hsv2bgr_u8` (interleaved)
and the planar colorization (`ops/colorize.py`, the plain version of the
K4 kernel) both run it, so the two layouts agree to the byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# 15-bit fixed-point BT.601 coefficients (cv2 5.0 BGR2GRAY).
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798
_GRAY_SHIFT = 15
# cv2 4.2 variant (yuv_shift=14), selected by OFT_CV42_GRAY=1.
_B2Y_42, _G2Y_42, _R2Y_42 = 1868, 9617, 4899
_GRAY_SHIFT_42 = 14

# HSV sector -> (b, g, r) selection from tab[0..3], OpenCV sector_data.
_SECTOR_DATA = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
    dtype=np.int32,
)

_INV255 = float(np.float32(1.0 / 255.0))
_SIX_OVER_180 = float(np.float32(6.0 / 180.0))


def gray_coeffs():
    """(b2y, g2y, r2y, shift) for the selected BGR2GRAY fixed-point mode
    (env OFT_CV42_GRAY=1 -> the pinned cv2 4.2 constants)."""
    if os.environ.get("OFT_CV42_GRAY") == "1":
        return _B2Y_42, _G2Y_42, _R2Y_42, _GRAY_SHIFT_42
    return _B2Y, _G2Y, _R2Y, _GRAY_SHIFT


def bgr2gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (..., 3) -> uint8 gray (...), cv2's fixed point."""
    b2y, g2y, r2y, shift = gray_coeffs()
    b = bgr[..., 0].to(torch.int32)
    g = bgr[..., 1].to(torch.int32)
    r = bgr[..., 2].to(torch.int32)
    y = (b * b2y + g * g2y + r * r2y + (1 << (shift - 1))) >> shift
    return y.to(torch.uint8)


def _fma(a, b, c):
    """a * b + c, two roundings, as the JAX package's `_fma` is."""
    return a * b + c


def hsv2bgr_planes(h: torch.Tensor, s, v: torch.Tensor):
    """f32 values of the uint8 H, S, V channels -> the uint8 (B, G, R)
    planes.  `s` may be a 0-dim tensor (a constant saturation)."""
    s = s * _INV255
    v = v * _INV255
    hh = h * _SIX_OVER_180
    hh = torch.where(hh >= 6.0, hh - 6.0, hh)
    fl = torch.floor(hh)
    hfrac = hh - fl
    sector = fl.clamp(0, 5)
    tabs = (v,
            v * (1.0 - s),
            v * _fma(-s, hfrac, 1.0),
            v * _fma(-s, 1.0 - hfrac, 1.0))

    def pick(channel: int) -> torch.Tensor:
        out = tabs[_SECTOR_DATA[5][channel]]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, tabs[_SECTOR_DATA[k][channel]], out)
        # C-cast truncation, not rounding (cv2 vectorized path)
        return torch.floor(out * 255.0).clamp(0, 255).to(torch.uint8)

    return pick(0), pick(1), pick(2)


def hsv2bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    """uint8 HSV (..., 3) -> uint8 BGR (..., 3); 8-bit hue wraps mod 180."""
    h, s, v = (hsv[..., c].to(torch.float32) for c in range(3))
    return torch.stack(hsv2bgr_planes(h, s, v), dim=-1)
