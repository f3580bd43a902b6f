"""Plain flow -> BGR colorization and per-pair magnitude sums: the
benchmark's reference for the visualizer's images and the extractor's
sums.  A frozen copy of the port's plain versions (cv2.cartToPolar with
OpenCV's fastAtan2, NORM_MINMAX to [0, 255], HSV -> BGR with cv2's uint8
arithmetic), importing nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

_P1 = float(np.float32(0.9997878412794807 * (180.0 / 3.141592653589793)))
_P3 = float(np.float32(-0.3258083974640975 * (180.0 / 3.141592653589793)))
_P5 = float(np.float32(0.1555786518463281 * (180.0 / 3.141592653589793)))
_P7 = float(np.float32(-0.04432655554792128 * (180.0 / 3.141592653589793)))
_DBL_EPS = float(np.float32(2.220446049250313e-16))
_RAD_PER_DEG = float(np.float32(3.141592653589793 / 180.0))
_DEG_PER_RAD = float(np.float32(180.0 / 3.141592653589793))
_INV255 = float(np.float32(1.0 / 255.0))
_SIX_OVER_180 = float(np.float32(6.0 / 180.0))
# HSV sector -> the (b, g, r) entries of (v, p, q, t), OpenCV's sector_data
_SECTOR_DATA = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x*x + y*y) correctly rounded: the card's sqrt is; the CPU's f32
    sqrt is not, so there the f64 one rounded back is used."""
    s = x * x + y * y
    if s.is_cuda or s.dtype != torch.float32:
        return torch.sqrt(s)
    return torch.sqrt(s.double()).float()


def magnitude_sums(flow: torch.Tensor) -> torch.Tensor:
    """Planar (B, 2, H, W) flow -> (B,) f32: each pair's magnitudes summed
    in f64 and rounded once (`np.sum(mag)` of the reference extractor)."""
    return magnitude(flow[:, 0], flow[:, 1]).double().sum(dim=(-2, -1)).float()


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV fastAtan2 in degrees, [0, 360)."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + _DBL_EPS)
    c2 = c * c
    poly = (((_P7 * c2 + _P5) * c2 + _P3) * c2 + _P1) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _hsv2bgr(h: torch.Tensor, v: torch.Tensor):
    """uint8 (B, G, R) planes of hue h, saturation 255 and value v (f32
    integers), cv2's vectorized uint8 path: truncation, not rounding."""
    s = float(np.float32(255.0) * np.float32(_INV255))
    v = v * _INV255
    hh = h * _SIX_OVER_180
    hh = torch.where(hh >= 6.0, hh - 6.0, hh)
    fl = torch.floor(hh)
    frac = hh - fl
    sector = fl.clamp(0, 5)
    tabs = (v, v * (1.0 - s), v * (-s * frac + 1.0), v * (-s * (1.0 - frac) + 1.0))

    def pick(ch):
        out = tabs[_SECTOR_DATA[5][ch]]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, tabs[_SECTOR_DATA[k][ch]], out)
        return torch.floor(out * 255.0).clamp(0, 255).to(torch.uint8)

    return pick(0), pick(1), pick(2)


def flow_to_bgr(flow: torch.Tensor) -> torch.Tensor:
    """Planar flow (B, 2, H, W) -> planar BGR uint8 (B, 3, H, W): hue
    from fastAtan2 through the deg -> rad -> deg round trip, wrapped mod
    256 (the reference's uint8 cast), value the per-image min-max
    normalized magnitude."""
    fx, fy = flow[:, 0], flow[:, 1]
    rad = fast_atan2_deg(fy, fx) * _RAD_PER_DEG
    hue = torch.remainder(torch.floor(rad * _DEG_PER_RAD), 256.0)
    mag = magnitude(fx, fy)
    lo = torch.amin(mag, dim=(-2, -1), keepdim=True)
    rng = torch.amax(mag, dim=(-2, -1), keepdim=True) - lo
    scale = torch.where(rng > _DBL_EPS, torch.full_like(rng, 255.0) / rng,
                        torch.zeros_like(rng))
    value = torch.floor(mag * scale + (-lo * scale)).clamp(0, 255)
    return torch.stack(_hsv2bgr(hue, value), dim=1)
