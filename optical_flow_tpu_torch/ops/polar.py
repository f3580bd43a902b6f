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
    """The magnitude half of cart_to_polar: sqrt(x*x + y*y), correctly
    rounded to f32.  PyTorch's f32 sqrt is on a card, but not on the CPU
    (with AVX512 about 0.7 % of values are 1 ulp off, and which ones
    depends on how the work is split across threads); there the f64 sqrt
    rounded to f32 is used, which is exact since 53 >= 2 * 24 + 2."""
    s = x * x + y * y
    if s.is_cuda:
        return torch.sqrt(s)
    return torch.sqrt(s.double()).float()


def magnitude_sums(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per frame, the sum of `magnitude(x, y)` over the last two axes:
    `np.sum(mag)` of the reference's extractor (`optical_flow.py:64`).
    Summed in f64 and rounded to f32 once, so the order the f64 sum takes
    moves the result by at most one f32 ulp (the plain version of X2,
    `kernels/magnitude_sum.py`)."""
    return magnitude(x, y).double().sum(dim=(-2, -1)).float()


def cart_to_polar(x: torch.Tensor, y: torch.Tensor):
    """cv2.cartToPolar(x, y): (magnitude, angle-in-radians [0, 2*pi))."""
    return magnitude(x, y), fast_atan2_deg(y, x) * _DEG2RAD


def minmax_scale_shift(mag: torch.Tensor):
    """Per-frame (scale, shift) of cv2.normalize NORM_MINMAX to [0, 255],
    in f32, each of shape (..., 1, 1): 255 / (max - min) where the range
    exceeds f32(DBL_EPSILON), else 0 (constant input maps to all zeros)."""
    smin = torch.amin(mag, dim=(-2, -1), keepdim=True)
    smax = torch.amax(mag, dim=(-2, -1), keepdim=True)
    rng = smax - smin
    # a true f32 division: `255.0 / rng` would be reciprocal(rng) * 255
    scale = torch.where(rng > _DBL_EPS, torch.full_like(rng, 255.0) / rng,
                        torch.zeros_like(rng))
    return scale, -smin * scale


def normalize_minmax_u8_value(mag: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(mag, None, 0, 255, NORM_MINMAX) -> f32 in [0, 255],
    per frame over the last two axes."""
    scale, shift = minmax_scale_shift(mag)
    return mag * scale + shift
