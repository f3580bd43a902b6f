"""cartToPolar with OpenCV semantics, a port of `optical_flow_tpu.ops.polar`.

cv2.cartToPolar's angle uses OpenCV's fastAtan2 polynomial (max error about
0.3 degrees against the true atan2), computed in degrees and scaled by
f32(pi/180); angle(0, 0) == 0.  The magnitude is the f32 sqrt(x*x + y*y).
"""

from __future__ import annotations

import numpy as np
import torch

# fastAtan2 polynomial constants (degrees).
_P1 = float(np.float32(0.9997878412794807 * (180.0 / 3.141592653589793)))
_P3 = float(np.float32(-0.3258083974640975 * (180.0 / 3.141592653589793)))
_P5 = float(np.float32(0.1555786518463281 * (180.0 / 3.141592653589793)))
_P7 = float(np.float32(-0.04432655554792128 * (180.0 / 3.141592653589793)))
_DBL_EPS = float(np.float32(2.220446049250313e-16))
_DEG2RAD = float(np.float32(3.141592653589793 / 180.0))


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV fastAtan2: angle in degrees [0, 360), f32 polynomial."""
    ax = x.abs()
    ay = y.abs()
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    c = lo / (hi + _DBL_EPS)
    c2 = c * c
    poly = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The magnitude half of cart_to_polar."""
    return torch.sqrt(x * x + y * y)


def cart_to_polar(x: torch.Tensor, y: torch.Tensor):
    """cv2.cartToPolar(x, y): (magnitude, angle-in-radians [0, 2*pi))."""
    return magnitude(x, y), fast_atan2_deg(y, x) * _DEG2RAD
