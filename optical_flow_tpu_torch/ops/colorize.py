"""Flow -> BGR colorization (the visualizer's HSV assembly), a port of
`optical_flow_tpu.ops.colorize`.

The reference (`visualize_optical_flow.py:48-55`) takes cv2.cartToPolar of
the flow, writes hue = ang * 180 / pi into a uint8 image (C-cast
truncation, wrapping mod 256: the "hue double-wrap"), saturation 255 and
value = the per-frame min-max-normalized magnitude (truncated), and
converts HSV to BGR.  The hue is computed in f32 from the fastAtan2
degrees through the deg -> rad -> deg round-trip, as the JAX package does.

`flow_to_bgr_planar` is the plain version of the K4 kernel
(`kernels/colorize.py`); it runs the same planes as the interleaved
`flow_to_bgr_u8` and agrees with it to the byte.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.ops.color import hsv2bgr_planes, hsv2bgr_u8
from optical_flow_tpu_torch.ops.polar import (fast_atan2_deg, magnitude,
                                              normalize_minmax_u8_value)

_RAD_PER_DEG = float(np.float32(3.141592653589793 / 180.0))
_DEG_PER_RAD = float(np.float32(180.0 / 3.141592653589793))


def _hue_value(fx: torch.Tensor, fy: torch.Tensor):
    """The uint8 hue and value of each pixel, as f32 integers in [0, 255]."""
    rad = fast_atan2_deg(fy, fx) * _RAD_PER_DEG
    hue = torch.remainder(torch.floor(rad * _DEG_PER_RAD), 256.0)
    value = torch.floor(normalize_minmax_u8_value(magnitude(fx, fy)))
    return hue, value.clamp(0, 255)


def flow_to_bgr_u8(flow: torch.Tensor) -> torch.Tensor:
    """flow (..., H, W, 2) f32 -> BGR uint8 (..., H, W, 3)."""
    hue, value = _hue_value(flow[..., 0], flow[..., 1])
    hue = hue.to(torch.uint8)
    hsv = torch.stack([hue, torch.full_like(hue, 255), value.to(torch.uint8)],
                      dim=-1)
    return hsv2bgr_u8(hsv)


def flow_to_bgr_planar(flow: torch.Tensor) -> torch.Tensor:
    """flow (B, 2, H, W) f32 -> planar BGR uint8 (B, 3, H, W)."""
    hue, value = _hue_value(flow[:, 0], flow[:, 1])
    sat = torch.full((), 255.0, dtype=torch.float32, device=flow.device)
    return torch.stack(hsv2bgr_planes(hue, sat, value), dim=1)
