"""Synthetic frame pairs with known flow (numpy only).

Copies of `optical_flow_tpu.oracle.synthetic.smooth_texture_pair` and
`motion_boundary_pair`, so that `chip_smoke.py` needs neither JAX nor
cv2, and `translating_clip`, a clip of the same texture moving by known
integer steps, which `chip_smoke.py` feeds to the extractor's device loop
from memory.  `tests/test_torch_params.py` holds the pair functions
byte-equal to the originals.
"""

from __future__ import annotations

import numpy as np


def _texture_base(h: int, w: int, seed: int, smooth_sigma: float) -> np.ndarray:
    """The (2h, 2w) f32 smooth random texture the frames are cropped from."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (h * 2, w * 2)).astype(np.float32)
    k = int(smooth_sigma * 4) | 1
    x = np.arange(k) - k // 2
    g = np.exp(-(x * x) / (2 * smooth_sigma ** 2)).astype(np.float32)
    g /= g.sum()
    base = np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 0, base)
    base = np.apply_along_axis(lambda m: np.convolve(m, g, mode="same"), 1, base)
    return (base - base.min()) / (base.max() - base.min()) * 255.0


def smooth_texture_pair(h: int, w: int, shift=(1, 2), seed: int = 42,
                        smooth_sigma: float = 3.0):
    """Two uint8 frames of smooth random texture, the second displaced by
    integer (dy, dx) via crop shifting.  Ground-truth flow is (-dx, -dy)
    in cv2 convention (content moves opposite to the crop window)."""
    base = _texture_base(h, w, seed, smooth_sigma)
    dy, dx = shift
    f1 = base[h // 2:h // 2 + h, w // 2:w // 2 + w].astype(np.uint8)
    f2 = base[h // 2 + dy:h // 2 + dy + h,
              w // 2 + dx:w // 2 + dx + w].astype(np.uint8)
    return f1, f2


def translating_clip(h: int, w: int, dxs, seed: int = 42,
                     smooth_sigma: float = 3.0) -> list:
    """uint8 frames of smooth_texture_pair's texture, frame i cropped dxs[i]
    columns right of the pair's first frame (|dx| <= w // 2): between
    frames a and b the ground-truth flow is (-(dxs[b] - dxs[a]), 0), and a
    shift (0, dx) frame equals smooth_texture_pair's second frame."""
    base = _texture_base(h, w, seed, smooth_sigma)
    y0, x0 = h // 2, w // 2
    return [base[y0:y0 + h, x0 + dx:x0 + dx + w].astype(np.uint8) for dx in dxs]


def motion_boundary_pair(h: int, w: int, shift_a=(2, 3), shift_b=(-2, -3),
                         seed: int = 7):
    """Two half-frames moving in opposite directions (a vertical motion
    boundary down the middle)."""
    fa1, fa2 = smooth_texture_pair(h, w, shift_a, seed=seed)
    fb1, fb2 = smooth_texture_pair(h, w, shift_b, seed=seed + 1)
    m = w // 2
    f1 = np.concatenate([fa1[:, :m], fb1[:, m:]], axis=1)
    f2 = np.concatenate([fa2[:, :m], fb2[:, m:]], axis=1)
    return f1, f2
