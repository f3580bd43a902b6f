"""Plain-PyTorch building blocks of the Farnebäck dense-flow model.

Twins of `optical_flow_tpu.models.farneback.core` on (..., C, H, W)
tensors, and the plain versions of the CUDA kernels: the kernel wrappers
run these for CPU tensors, the CPU tests hold them to the JAX functions,
and `chip_smoke.py` holds each kernel to them on the card.

Stencils are sums of shifted slices, in the same tap order as the JAX
version, never `F.conv2d` (whose cuDNN path defaults to TF32 on the card).
Borders are index gathers (`_pad_index`), so any frame size works.  The
box sum is a direct windowed sum, winsize shifted adds per axis, as the
`update_blur` kernel accumulates it; the JAX version takes a difference of
prefix sums instead, whose cancellation error grows with the row length.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from optical_flow_tpu_torch.models.farneback.params import poly_exp_weights
from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32

# UpdateMatrices border down-weighting (OpenCV constants): pixels at distance
# d < 5 from any image edge scale by border[d]; factors multiply per edge.
BORDER_WEIGHTS = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)
BORDER = 5


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis of length n padded by
    `pad` on both sides: "edge" (replicate) or "reflect" (REFLECT_101)."""
    i = np.arange(-pad, n + pad)
    if mode == "edge" or n == 1:
        return np.clip(i, 0, n - 1)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def _padded(x: torch.Tensor, dim: int, pad: int, mode: str) -> torch.Tensor:
    idx = torch.as_tensor(_pad_index(x.shape[dim], pad, mode), device=x.device)
    return x.index_select(dim, idx)


def _corr1d(img: torch.Tensor, taps, dim: int, mode: str = "edge"):
    """Correlation of (..., H, W) with 1-D taps along `dim`, padded border.

    taps: length 2n+1 (f32 values), index 0 = offset -n.
    """
    n = (len(taps) - 1) // 2
    if n == 0:
        return img * float(taps[0])
    p = _padded(img, dim, n, mode)
    L = img.shape[dim]
    out = None
    for i, t in enumerate(taps):
        term = float(t) * p.narrow(dim, i, L)
        out = term if out is None else out + term
    return out


def gaussian_blur_reflect101(img: torch.Tensor, kernel) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 (cv2 GaussianBlur):
    vertical pass, then horizontal."""
    k32 = np.asarray(kernel, dtype=np.float32)
    out = _corr1d(img.float(), k32, dim=-2, mode="reflect")
    return _corr1d(out, k32, dim=-1, mode="reflect")


def gaussian_blur_resize(img: torch.Tensor, kernel, out_w: int,
                         out_h: int) -> torch.Tensor:
    """One pyramid level from the full-resolution frame: the REFLECT_101
    Gaussian, then the bilinear resize.  Plain version of the
    `gauss_resize` kernel."""
    return resize_bilinear_f32(gaussian_blur_reflect101(img, kernel),
                               out_w, out_h)


def poly_exp(img: torch.Tensor, poly_n: int, poly_sigma: float,
             pre_taps=None) -> torch.Tensor:
    """FarnebackPolyExp: (..., H, W) -> R (..., 5, H, W) f32.

    Channels: 0 = b_y, 1 = b_x, 2 = a_yy, 3 = a_xx, 4 = a_xy.  Separable
    weighted-least-squares fit of a quadratic per pixel: two correlation
    passes with (g, x*g, x^2*g) taps under replicate borders, then a
    constant linear combination via the inverse Gram entries.  pre_taps:
    an optional REFLECT_101 pre-smooth (the level-0 3-tap Gaussian); the
    replicate border then repeats the smoothed edge.  Plain version of the
    `polyexp` kernel.
    """
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_weights(poly_n, poly_sigma)
    img = img.float()
    if pre_taps is not None:
        img = gaussian_blur_reflect101(img, pre_taps)
    row0 = _corr1d(img, g, dim=-2)
    row1 = _corr1d(img, xg, dim=-2)
    row2 = _corr1d(img, xxg, dim=-2)
    b1 = _corr1d(row0, g, dim=-1)
    b2 = _corr1d(row0, xg, dim=-1)
    b3 = _corr1d(row1, g, dim=-1)
    b4 = _corr1d(row0, xxg, dim=-1)
    b5 = _corr1d(row2, g, dim=-1)
    b6 = _corr1d(row1, xg, dim=-1)
    ig11, ig03, ig33, ig55 = (float(np.float32(v))
                              for v in (ig11, ig03, ig33, ig55))
    return torch.stack([
        b3 * ig11,                      # b_y
        b2 * ig11,                      # b_x
        b1 * ig03 + b5 * ig33,          # a_yy
        b1 * ig03 + b4 * ig33,          # a_xx
        b6 * ig55,                      # a_xy
    ], dim=-3)


def border_axis_weights(n: int) -> np.ndarray:
    """The border down-weighting along one axis of length n (f32, host):
    per k < 5, the leading edge's factor, then the trailing edge's."""
    wv = np.ones(n, np.float32)
    for i in range(min(BORDER, n)):
        wv[i] *= BORDER_WEIGHTS[i]
        wv[n - 1 - i] *= BORDER_WEIGHTS[i]
    return wv


def border_scale_field(h: int, w: int) -> np.ndarray:
    """Separable per-pixel down-weighting near image borders (f32, host)."""
    return border_axis_weights(h)[:, None] * border_axis_weights(w)[None, :]


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: R (..., 5, H, W), flow (..., 2, H, W) ->
    M (..., 5, H, W).

    Fetches R1 at flow-displaced, cvRound-ed (half to even), clamped
    integer coordinates; when the rounded target leaves the image only R0
    terms are used; assembles the per-pixel normal equations G (2x2, 3
    unique) and h (2), down-weighted near borders.
    """
    H, W = R0.shape[-2:]
    dev = R0.device
    dx = flow[..., 0, :, :]
    dy = flow[..., 1, :, :]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    x1 = torch.round(xs + dx)
    y1 = torch.round(ys + dy)
    inside = (x1 >= 0) & (x1 <= W - 1) & (y1 >= 0) & (y1 <= H - 1)
    xi = x1.clamp(0, W - 1).long()
    yi = y1.clamp(0, H - 1).long()
    flat = (yi * W + xi).reshape(flow.shape[:-3] + (1, H * W))
    R1r = R1.reshape(R1.shape[:-2] + (H * W,))
    R1d = torch.gather(R1r, -1, flat.expand(R1r.shape)).reshape(R1.shape)

    def c(a, k):
        return a[..., k, :, :]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    r2 = torch.where(inside, c(R1d, 0), zero)
    r3 = torch.where(inside, c(R1d, 1), zero)
    r4 = torch.where(inside, (c(R0, 2) + c(R1d, 2)) * 0.5, c(R0, 2))
    r5 = torch.where(inside, (c(R0, 3) + c(R1d, 3)) * 0.5, c(R0, 3))
    r6 = torch.where(inside, (c(R0, 4) + c(R1d, 4)) * 0.25, c(R0, 4) * 0.5)

    # residuals: res = (R0_b - R1_b_displaced)/2 + A*d
    r2 = (c(R0, 0) - r2) * 0.5 + (r4 * dy + r6 * dx)
    r3 = (c(R0, 1) - r3) * 0.5 + (r6 * dy + r5 * dx)

    sc = torch.as_tensor(border_scale_field(H, W), device=dev)
    r2 = r2 * sc
    r3 = r3 * sc
    r4 = r4 * sc
    r5 = r5 * sc
    r6 = r6 * sc

    return torch.stack([
        r4 * r4 + r6 * r6,        # G11 (y-y)
        (r4 + r5) * r6,           # G12
        r5 * r5 + r6 * r6,        # G22 (x-x)
        r4 * r2 + r6 * r3,        # h1
        r6 * r2 + r5 * r3,        # h2
    ], dim=-3)


def box_sum_replicate(M: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize box *sum* with replicate borders, as a direct windowed
    sum: the horizontal pass first, then the vertical, each adding the
    window's taps left to right.  Equivalent to OpenCV's running-sum blur
    in FarnebackUpdateFlow_Blur; ksize == 1 is the identity."""
    if ksize == 1:
        return M
    m = ksize // 2

    def along(dim, x):
        L = x.shape[dim]
        p = _padded(x, dim, m, "edge")
        out = p.narrow(dim, 0, L)
        for i in range(1, 2 * m + 1):
            out = out + p.narrow(dim, i, L)
        return out

    return along(-2, along(-1, M))


def gaussian_window_kernel(winsize: int) -> np.ndarray:
    """Separable window for OPTFLOW_FARNEBACK_GAUSSIAN (f32 taps), as the
    JAX package computes it: 2 * (winsize // 2) + 1 taps, sigma 0.3 * m.

    winsize 1 gives sigma 0, where the JAX formula divides 0 by 0 and its
    flow is NaN everywhere (cv2's window there is the single tap 1); the
    port raises instead of returning NaN."""
    m = winsize // 2
    if m == 0:
        raise ValueError(
            f"the Gaussian window needs winsize >= 2, got {winsize}: the "
            "reference's formula has sigma 0 there and returns NaN flow")
    sigma = m * 0.3
    i = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_sum_replicate(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Separable Gaussian-weighted window sum with replicate borders: the
    horizontal pass first, then the vertical, each t0*p0 + t1*p1 + ...
    (the JAX `_corr1d(_corr1d(M, k, axis=-1), k, axis=-2)`)."""
    k = gaussian_window_kernel(winsize)
    return _corr1d(_corr1d(M, k, dim=-1), k, dim=-2)


def blur_solve(M: torch.Tensor, winsize: int, gaussian: bool) -> torch.Tensor:
    """Window sum of M (box, or Gaussian with `gaussian`), then the 2x2
    solve: M (..., 5, H, W) -> flow (..., 2, H, W).  Plain version of the
    `blur_solve` kernel (K5b)."""
    if gaussian:
        return solve_flow(gaussian_sum_replicate(M, winsize), 1.0)
    return solve_flow(box_sum_replicate(M, winsize), 1.0 / (winsize * winsize))


def solve_flow(Mb: torch.Tensor, inv_area: float) -> torch.Tensor:
    """Per-pixel 2x2 solve: blurred M (..., 5, H, W) -> flow (..., 2, H, W).

    det regularized with +1e-3 exactly like OpenCV.
    """
    s = float(np.float32(inv_area))
    g11 = Mb[..., 0, :, :] * s
    g12 = Mb[..., 1, :, :] * s
    g22 = Mb[..., 2, :, :] * s
    h1 = Mb[..., 3, :, :] * s
    h2 = Mb[..., 4, :, :] * s
    idet = 1.0 / (g11 * g22 - g12 * g12 + float(np.float32(1e-3)))
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return torch.stack([fx, fy], dim=-3)


def update_step(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                winsize: int, gaussian: bool = False) -> torch.Tensor:
    """One iterate step, M -> box or Gaussian window sum -> solve.  Plain
    version of the `update_blur` kernel (K1)."""
    return blur_solve(update_matrices(R0, R1, flow), winsize, gaussian)


def update_step_poly(img0: torch.Tensor, img1: torch.Tensor,
                     flow: torch.Tensor, winsize: int, gaussian: bool,
                     poly_n: int, poly_sigma: float,
                     pre_taps=None) -> torch.Tensor:
    """One iterate step from the level images: both expanded, then
    update_step.  Plain version of the `update_blur_poly` kernel (K7)."""
    return update_step(poly_exp(img0, poly_n, poly_sigma, pre_taps),
                       poly_exp(img1, poly_n, poly_sigma, pre_taps),
                       flow, winsize, gaussian)


def update_flow(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                winsize: int, iterations: int,
                gaussian: bool = False) -> torch.Tensor:
    """One pyramid level's iterate loop, M -> window sum -> solve, with
    the box window or, with `gaussian`, the Gaussian one."""
    for _ in range(iterations):
        flow = update_step(R0, R1, flow, winsize, gaussian)
    return flow
