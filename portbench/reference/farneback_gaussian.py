"""Plain Farnebäck dense flow in PyTorch with either window: the
benchmark's reference for flags 0 (the box) and 256
(OPTFLOW_FARNEBACK_GAUSSIAN).

The level plan, the level build, the polynomial expansion, the displaced
fetch and normal equations, the box sum, the 2x2 solve and the x2 flow
upsample are `portbench/reference/farneback.py`'s, so at flags 0 this
reference is that one.  The Gaussian window is the separable weighted sum
of the port's plain version (`core.gaussian_sum_replicate`, then
`core.blur_solve`'s solve at inverse area 1): 2 * (winsize // 2) + 1 f32
taps of sigma 0.3 * (winsize // 2), replicate borders, the horizontal
pass first, then the vertical, each t0 * p0 + t1 * p1 + ... in tap order,
the JAX package's `_corr1d` order of sums (no departure).  It imports
nothing of the program.

`dtype` is the arithmetic's precision: float32 as the configuration
states it, or a lower one for the control.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import farneback as ref

GAUSSIAN = 256          # OPTFLOW_FARNEBACK_GAUSSIAN


@functools.lru_cache(maxsize=16)
def window_taps(winsize: int) -> np.ndarray:
    """The Gaussian window's f32 taps: 2m + 1 of them, m = winsize // 2,
    sigma 0.3 m, normalised in float64."""
    m = winsize // 2
    if m == 0:
        raise ValueError(f"the Gaussian window needs winsize >= 2, got {winsize}")
    sigma = 0.3 * m
    i = np.arange(-m, m + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_sum(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """The Gaussian-weighted window sum of M, replicate borders: the
    horizontal pass, then the vertical."""
    k = window_taps(winsize)
    return ref._corr1d(ref._corr1d(M, k, -1), k, -2)


def step(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor, winsize: int,
         gaussian: bool) -> torch.Tensor:
    """One iterate step: M, the window sum, the solve."""
    M = ref.update_matrices(R0, R1, flow)
    if gaussian:
        return ref.solve_flow(gaussian_sum(M, winsize), 1.0)
    return ref.solve_flow(ref.box_sum(M, winsize), 1.0 / (winsize * winsize))


def flow_pyramid(frames: torch.Tensor, cfg: dict, chain: bool,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W) uint8 frames -> planar flow (B, 2, H, W), coarse to fine.

    chain=False: the B first frames, then the B second frames (N = 2B);
    chain=True: N consecutive frames, the N - 1 pairs (i, i + 1).  cfg:
    the configuration's `farneback` dict, flags 0 or 256 (no seed)."""
    if cfg["flags"] not in (0, GAUSSIAN):
        raise ValueError(f"the reference runs flags 0 and {GAUSSIAN}, not {cfg['flags']}")
    gaussian = cfg["flags"] == GAUSSIAN
    frames = frames.to(dtype)
    n, h, w = frames.shape
    B = n - 1 if chain else n // 2
    flow = None
    for k, lh, lw, kern in ref.level_plan(h, w, cfg["levels"], cfg["pyr_scale"]):
        if k > 0:
            R = ref.poly_exp(ref.gaussian_blur_resize(frames, kern, lw, lh),
                             cfg["poly_n"], cfg["poly_sigma"])
        else:
            R = ref.poly_exp(frames, cfg["poly_n"], cfg["poly_sigma"], pre_taps=kern)
        if flow is None:
            flow = torch.zeros((B, 2, lh, lw), dtype=dtype, device=frames.device)
        else:
            flow = ref.resize_bilinear(flow, lw, lh) * float(np.float32(1.0 / cfg["pyr_scale"]))
        R0, R1 = (R[:-1], R[1:]) if chain else (R[:B], R[B:])
        for _ in range(cfg["iterations"]):
            flow = step(R0, R1, flow, cfg["winsize"], gaussian)
    return flow
