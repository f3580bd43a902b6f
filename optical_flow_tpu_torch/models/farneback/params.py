"""Host-side precomputation for the Farnebäck flow model (numpy only).

A copy of `optical_flow_tpu.models.farneback.params`: the level schedule
with OpenCV's level-clipping rule, the per-level Gaussian smoothing taps
(3/9/19 at the default config) and the polynomial-expansion taps with the
inverse-Gram entries.  These feed the CUDA kernels' constants.  The card's
machine has no JAX, so the module is carried here and pinned to the
original by `tests/test_torch_params.py` (exact equality).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from optical_flow_tpu_torch.utils.config import FarnebackConfig

# OpenCV clips pyramid levels so every level keeps min(H, W) >= 32 px.
MIN_LEVEL_SIZE = 32


def cv_round(x: float) -> int:
    """cvRound: round half to even."""
    return int(np.rint(x))


def effective_levels(h: int, w: int, levels: int, pyr_scale: float) -> int:
    """Number of *extra* pyramid levels after OpenCV's clipping rule.

    Total image scales used = effective_levels + 1 (k = levels .. 0).
    """
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < MIN_LEVEL_SIZE or h * scale < MIN_LEVEL_SIZE:
            break
        k += 1
    return k


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics, incl. the fixed small-kernel tables."""
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if sigma <= 0 and n in small:
        return np.asarray(small[n], dtype=np.float64)
    sigma_eff = sigma if sigma > 0 else 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    c = (n - 1) * 0.5
    x = np.arange(n) - c
    k = np.exp(-(x * x) / (2.0 * sigma_eff * sigma_eff))
    return k / k.sum()


@functools.lru_cache(maxsize=64)
def poly_exp_weights(poly_n: int, poly_sigma: float):
    """FarnebackPrepareGaussian: (g, xg, xxg, ig11, ig03, ig33, ig55).

    g/xg/xxg are the separable correlation taps (length 2*poly_n+1, float32,
    computed in float64 like OpenCV); ig* are the four distinct entries of
    the inverse Gram matrix of the weighted monomial basis
    {1, x, y, x^2, y^2, xy}.
    """
    n = poly_n
    sigma = poly_sigma if poly_sigma >= 1e-7 else n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    G = np.zeros((6, 6), dtype=np.float64)
    for yv in x:
        for xv in x:
            w = g[int(yv) + n] * g[int(xv) + n]
            G[0, 0] += w
            G[1, 1] += w * xv * xv
            G[3, 3] += w * xv ** 4
            G[5, 5] += w * xv * xv * yv * yv
    G[2, 2] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    return (g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32),
            float(invG[1, 1]), float(invG[0, 3]), float(invG[3, 3]),
            float(invG[5, 5]))


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Static per-level shapes and smoothing parameters."""
    k: int                 # level index (0 = full resolution)
    width: int
    height: int
    smooth_ksize: int
    smooth_sigma: float


@dataclasses.dataclass(frozen=True)
class FarnebackPlan:
    """Full static schedule for one (H, W, config) combination."""
    height: int
    width: int
    config: FarnebackConfig
    levels: Tuple[LevelPlan, ...]    # coarse -> fine (k descending to 0)


@functools.lru_cache(maxsize=128)
def build_plan(h: int, w: int, config: FarnebackConfig) -> FarnebackPlan:
    config.validate()
    n_extra = effective_levels(h, w, config.levels, config.pyr_scale)
    levels = []
    for k in range(n_extra, -1, -1):
        scale = config.pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        levels.append(LevelPlan(
            k=k,
            width=cv_round(w * scale),
            height=cv_round(h * scale),
            smooth_ksize=ksize,
            smooth_sigma=sigma,
        ))
    return FarnebackPlan(height=h, width=w, config=config, levels=tuple(levels))
