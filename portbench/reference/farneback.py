"""Plain Farnebäck dense flow in PyTorch: the benchmark's reference.

A frozen copy of the port's plain versions (the level plan, the REFLECT_101
Gaussian and bilinear level build, the polynomial expansion, the box-window
iterate with its border weights and 2x2 solve, the x2 flow upsample), kept
here so that what decides `correct` cannot move with the program.  It
imports nothing of the program.  Stencils are sums of shifted slices, never
a convolution, so no TF32 setting reaches them.

`dtype` is the arithmetic's precision: float32 as the configurations state
it, or a lower one for the control (`portbench/control.py`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenCV keeps every pyramid level at min(H, W) >= 32 px.
MIN_LEVEL_SIZE = 32
BORDER_WEIGHTS = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)
BORDER = 5


def cv_round(x: float) -> int:
    """cvRound: round half to even."""
    return int(np.rint(x))


def level_plan(h: int, w: int, levels: int, pyr_scale: float) -> list:
    """[(k, height, width, smoothing taps)] coarse to fine: OpenCV's
    level-clipping rule and per-level Gaussian (sigma (1/scale - 1) / 2,
    cvRound(5 sigma) | 1 taps, at least 3)."""
    n_extra, scale = 0, 1.0
    while n_extra < levels:
        scale *= pyr_scale
        if w * scale < MIN_LEVEL_SIZE or h * scale < MIN_LEVEL_SIZE:
            break
        n_extra += 1
    plan = []
    for k in range(n_extra, -1, -1):
        s = pyr_scale ** k
        sigma = (1.0 / s - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        plan.append((k, cv_round(h * s), cv_round(w * s), gaussian_kernel(ksize, sigma)))
    return plan


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel, with its fixed small-kernel tables."""
    small = {1: [1.0], 3: [0.25, 0.5, 0.25],
             5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
    if sigma <= 0 and n in small:
        return np.asarray(small[n], dtype=np.float64)
    sigma_eff = sigma if sigma > 0 else 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma_eff * sigma_eff))
    return k / k.sum()


@functools.lru_cache(maxsize=16)
def poly_exp_weights(poly_n: int, poly_sigma: float):
    """FarnebackPrepareGaussian: (g, xg, xxg) f32 taps and the inverse Gram
    entries (ig11, ig03, ig33, ig55), computed in f64 as OpenCV does."""
    n = poly_n
    sigma = poly_sigma if poly_sigma >= 1e-7 else n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    G = np.zeros((6, 6), dtype=np.float64)
    for yv in x:
        for xv in x:
            wt = g[int(yv) + n] * g[int(xv) + n]
            G[0, 0] += wt
            G[1, 1] += wt * xv * xv
            G[3, 3] += wt * xv ** 4
            G[5, 5] += wt * xv * xv * yv * yv
    G[2, 2] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return (g.astype(np.float32), (x * g).astype(np.float32),
            (x * x * g).astype(np.float32),
            float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5]))


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis padded by `pad` a side:
    "edge" (replicate) or "reflect" (REFLECT_101)."""
    i = np.arange(-pad, n + pad)
    if mode == "edge" or n == 1:
        return np.clip(i, 0, n - 1)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _corr1d(img: torch.Tensor, taps, dim: int, mode: str = "edge") -> torch.Tensor:
    """Correlation along `dim` with 1-D taps (index 0 = offset -n), each
    tap a multiply and an add in order, border padded by index."""
    n = (len(taps) - 1) // 2
    if n == 0:
        return img * float(taps[0])
    idx = torch.as_tensor(_pad_index(img.shape[dim], n, mode), device=img.device)
    p = img.index_select(dim, idx)
    length = img.shape[dim]
    out = None
    for i, t in enumerate(taps):
        term = float(t) * p.narrow(dim, i, length)
        out = term if out is None else out + term
    return out


def _coeffs(s_len: int, d_len: int):
    """Bilinear (s0, s1, t) with half-pixel centres and edge clamp, t in f32."""
    f = (np.arange(d_len) + 0.5) * (s_len / d_len) - 0.5
    s0 = np.floor(f).astype(np.int64)
    t = (f - s0).astype(np.float32)
    t[s0 < 0] = 0.0
    s0[s0 < 0] = 0
    t[s0 >= s_len - 1] = 1.0
    s0[s0 >= s_len - 1] = max(s_len - 2, 0)
    return s0, np.minimum(s0 + 1, s_len - 1), t


def resize_bilinear(src: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR on the float path: horizontal pass, then
    vertical."""
    sh, sw = src.shape[-2:]
    if (dw, dh) == (sw, sh):
        return src
    dev = src.device

    def tensors(s, d):
        s0, s1, t = _coeffs(s, d)
        return (torch.as_tensor(s0, device=dev), torch.as_tensor(s1, device=dev),
                torch.as_tensor(t, device=dev).to(src.dtype))

    sx0, sx1, tx = tensors(sw, dw)
    sy0, sy1, ty = tensors(sh, dh)
    row = src.index_select(-1, sx0) * (1.0 - tx) + src.index_select(-1, sx1) * tx
    ty = ty[:, None]
    return row.index_select(-2, sy0) * (1.0 - ty) + row.index_select(-2, sy1) * ty


def gaussian_blur_resize(img: torch.Tensor, kern, out_w: int, out_h: int) -> torch.Tensor:
    """A level from the full-resolution frames: the REFLECT_101 Gaussian
    (vertical, then horizontal), then the bilinear resize."""
    k32 = np.asarray(kern, dtype=np.float32)
    blurred = _corr1d(_corr1d(img, k32, -2, "reflect"), k32, -1, "reflect")
    return resize_bilinear(blurred, out_w, out_h)


def poly_exp(img: torch.Tensor, poly_n: int, poly_sigma: float, pre_taps=None) -> torch.Tensor:
    """FarnebackPolyExp: (..., H, W) -> R (..., 5, H, W), channels b_y,
    b_x, a_yy, a_xx, a_xy; the optional pre-smooth is REFLECT_101."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(poly_n, poly_sigma)
    if pre_taps is not None:
        k32 = np.asarray(pre_taps, dtype=np.float32)
        img = _corr1d(_corr1d(img, k32, -2, "reflect"), k32, -1, "reflect")
    row0, row1, row2 = (_corr1d(img, t, -2) for t in (g, xg, xxg))
    b1 = _corr1d(row0, g, -1)
    b2 = _corr1d(row0, xg, -1)
    b3 = _corr1d(row1, g, -1)
    b4 = _corr1d(row0, xxg, -1)
    b5 = _corr1d(row2, g, -1)
    b6 = _corr1d(row1, xg, -1)
    ig11, ig03, ig33, ig55 = (float(np.float32(v)) for v in (ig11, ig03, ig33, ig55))
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=-3)


def _border_field(h: int, w: int) -> np.ndarray:
    def axis(n):
        wv = np.ones(n, np.float32)
        for i in range(min(BORDER, n)):
            wv[i] *= BORDER_WEIGHTS[i]
            wv[n - 1 - i] *= BORDER_WEIGHTS[i]
        return wv
    return axis(h)[:, None] * axis(w)[None, :]


def update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: R1 fetched at the cvRound-ed displaced,
    clamped position (R0's terms alone where it leaves the frame), the
    normal equations (G11, G12, G22, h1, h2), down-weighted near borders."""
    H, W = R0.shape[-2:]
    dev, dt = R0.device, R0.dtype
    dx, dy = flow[..., 0, :, :], flow[..., 1, :, :]
    x1 = torch.round(torch.arange(W, dtype=dt, device=dev)[None, :] + dx)
    y1 = torch.round(torch.arange(H, dtype=dt, device=dev)[:, None] + dy)
    inside = (x1 >= 0) & (x1 <= W - 1) & (y1 >= 0) & (y1 <= H - 1)
    # clamped as integers: in a precision that rounds W - 1 up, a clamp in
    # that precision would index past the row
    flat = y1.long().clamp(0, H - 1) * W + x1.long().clamp(0, W - 1)
    flat = flat.reshape(flow.shape[:-3] + (1, H * W))
    R1r = R1.reshape(R1.shape[:-2] + (H * W,))
    R1d = torch.gather(R1r, -1, flat.expand(R1r.shape)).reshape(R1.shape)

    def c(a, k):
        return a[..., k, :, :]

    zero = torch.zeros((), dtype=dt, device=dev)
    r2 = torch.where(inside, c(R1d, 0), zero)
    r3 = torch.where(inside, c(R1d, 1), zero)
    r4 = torch.where(inside, (c(R0, 2) + c(R1d, 2)) * 0.5, c(R0, 2))
    r5 = torch.where(inside, (c(R0, 3) + c(R1d, 3)) * 0.5, c(R0, 3))
    r6 = torch.where(inside, (c(R0, 4) + c(R1d, 4)) * 0.25, c(R0, 4) * 0.5)
    r2 = (c(R0, 0) - r2) * 0.5 + (r4 * dy + r6 * dx)
    r3 = (c(R0, 1) - r3) * 0.5 + (r6 * dy + r5 * dx)
    sc = torch.as_tensor(_border_field(H, W), device=dev).to(dt)
    r2, r3, r4, r5, r6 = (r * sc for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-3)


def box_sum(M: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize box sum, replicate borders: horizontal pass, then
    vertical, each adding the window's taps left to right."""
    if ksize == 1:
        return M
    m = ksize // 2

    def along(dim, x):
        idx = torch.as_tensor(_pad_index(x.shape[dim], m, "edge"), device=x.device)
        p = x.index_select(dim, idx)
        length = x.shape[dim]
        out = p.narrow(dim, 0, length)
        for i in range(1, 2 * m + 1):
            out = out + p.narrow(dim, i, length)
        return out

    return along(-2, along(-1, M))


def solve_flow(Mb: torch.Tensor, inv_area: float) -> torch.Tensor:
    """Per-pixel 2x2 solve, det regularized by +1e-3 as OpenCV does."""
    s = float(np.float32(inv_area))
    g11, g12, g22, h1, h2 = (Mb[..., k, :, :] * s for k in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + float(np.float32(1e-3)))
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=-3)


def flow_pyramid(frames: torch.Tensor, cfg: dict, chain: bool,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 frames -> planar flow (B, 2, H, W), coarse to fine.

    chain=False: the B first frames, then the B second frames (N = 2B);
    chain=True: N consecutive frames, the N - 1 pairs (i, i + 1).  cfg:
    the configuration's `farneback` dict, box window and no seed (flags 0).
    Every level is built from the full-resolution frames; level 0 is the
    frame, pre-smoothed by the expansion's 3-tap Gaussian."""
    if cfg["flags"] != 0:
        raise ValueError(f"the reference runs flags 0, not {cfg['flags']}")
    frames = frames.to(dtype)
    n, h, w = frames.shape
    B = n - 1 if chain else n // 2
    flow = None
    for k, lh, lw, kern in level_plan(h, w, cfg["levels"], cfg["pyr_scale"]):
        if k > 0:
            R = poly_exp(gaussian_blur_resize(frames, kern, lw, lh), cfg["poly_n"], cfg["poly_sigma"])
        else:
            R = poly_exp(frames, cfg["poly_n"], cfg["poly_sigma"], pre_taps=kern)
        if flow is None:
            flow = torch.zeros((B, 2, lh, lw), dtype=dtype, device=frames.device)
        else:
            flow = resize_bilinear(flow, lw, lh) * float(np.float32(1.0 / cfg["pyr_scale"]))
        R0, R1 = (R[:-1], R[1:]) if chain else (R[:B], R[B:])
        ws = cfg["winsize"]
        for _ in range(cfg["iterations"]):
            flow = solve_flow(box_sum(update_matrices(R0, R1, flow), ws), 1.0 / (ws * ws))
    return flow
