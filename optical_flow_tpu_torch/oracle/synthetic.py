"""Synthetic frame pairs with known flow (numpy only).

Copies of `optical_flow_tpu.oracle.synthetic`'s `smooth_texture_pair`,
`motion_boundary_pair`, `vertical_jump_pair`, `quadratic_pair` and
`write_synthetic_video` (cv2 imported inside it, as there: nothing on a
compute path needs cv2), so that `chip_smoke.py` and the self test need
neither JAX nor cv2, and `translating_clip`, a clip of the same texture
moving by known integer steps, which `chip_smoke.py` feeds to the
extractor's device loop from memory.  `tests/test_torch_params.py` and
`tests/test_torch_oracle.py` hold them byte-equal to the originals.
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


def vertical_jump_pair(h: int, w: int,
                       jumps=((0.37, 0.445, 40), (0.46, 0.535, 104)),
                       seed: int = 13):
    """Two uint8 frames where horizontal content strips jump down by tens
    of pixels between frames while the rest of the frame is static.

    strips are (row_frac_start, row_frac_end, dy_pixels): frame-2 rows in
    the strip show frame-1 content from dy rows above, so the recovered
    flow has flow_y ~ +dy there against ~0 elsewhere.  Two adjacent
    strips at dy 40 and 104 are the geometry of the TPU kernels' spill
    paths (a vertical source spread past their 32-row window, and
    bimodal) at production scale."""
    f1, _ = smooth_texture_pair(h, w, (0, 0), seed=seed)
    f2 = f1.copy()
    for r0f, r1f, dy in jumps:
        r0, r1 = int(h * r0f), int(h * r1f)
        src0 = max(r0 - dy, 0)
        f2[r0:r1] = f1[src0:src0 + (r1 - r0)]
    return f1, f2


def quadratic_pair(h: int, w: int, d=(0.5, -0.3), coeffs=(2.0, 1.5, 0.15, 0.10, 0.05)):
    """A quadratic-surface frame pair with exact sub-pixel shift d=(dx, dy).

    Farnebäck's model is exact on quadratics, so interior flow should equal
    d up to uint8 quantization."""
    bx, by, axx, ayy, axy = coeffs
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def f(y, x):
        yc, xc = y - h / 2, x - w / 2
        return 120 + bx * xc + by * yc + axx * xc ** 2 + ayy * yc ** 2 + axy * xc * yc

    i1 = np.clip(f(ys, xs), 0, 255).astype(np.uint8)
    i2 = np.clip(f(ys - d[1], xs - d[0]), 0, 255).astype(np.uint8)
    return i1, i2


def write_synthetic_video(path: str, n_frames: int = 50, h: int = 120,
                          w: int = 160, fps: float = 25.0, seed: int = 0):
    """Write a small mp4 of translating texture with cv2 (test fixtures
    only).  Returns the per-frame (dx, dy) offsets of the crop window."""
    import cv2  # fixture-only dependency

    r = np.random.default_rng(seed)
    base_h, base_w = h + 4 * n_frames, w + 4 * n_frames
    base = r.uniform(0, 255, (base_h, base_w, 3)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 4) * 4
    base = np.clip(base - base.min(), 0, 255).astype(np.uint8)

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open")
    offs = []
    ox = oy = 0
    for _ in range(n_frames):
        vw.write(base[oy:oy + h, ox:ox + w])
        offs.append((ox, oy))
        ox += int(r.integers(0, 3))
        oy += int(r.integers(0, 3))
    vw.release()
    return offs
