"""The one generator of every traffic mix: the units a cell's window runs
(shots for the visualizer, videos for the extractor) and the frames they
show, all made from --seed.

A mix file (`portbench/traffic/<name>.json`) gives a unit's length as a
distribution, cut into `strata` equal-probability lengths (each the
distribution's quantile at the stratum's middle).  Every seed runs the same
set of lengths, cycle after cycle, each cycle in its own order drawn from
the seed, so seeds change the order and the content, never the work.

Frames are crops of one smooth random texture made on the device from the
seed: pool frame k is cropped (k // 2, k) px from the first, so stepping
through the pool pans the camera by (1, 0.5) px a step.  A unit walks the
pool as a triangle wave (a pan back and forth) from a phase drawn from the
seed, `stride` pool frames a step.
"""

from __future__ import annotations

import math
import statistics
import zlib
from typing import Iterator, List

import numpy as np
import torch


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of draws per purpose, from a seed of any size."""
    return np.random.default_rng([seed % (1 << 64), zlib.crc32(stream.encode())])


def quantile(dist: dict, q: float) -> float:
    """The q-quantile of a length distribution: `uniform` (low, high),
    `lognormal` (median, sigma_ln, clipped to low, high) or
    `lognormal_between` (median, sigma_ln, only the lengths between low
    and high: a lognormal's tail)."""
    kind, low, high = dist["dist"], dist["low"], dist["high"]
    if kind == "uniform":
        return low + q * (high - low)
    if kind in ("lognormal", "lognormal_between"):
        med, sigma, normal = dist["median"], dist["sigma_ln"], statistics.NormalDist()
        if kind == "lognormal_between":
            lo, hi = (normal.cdf(math.log(x / med) / sigma) for x in (low, high))
            q = lo + q * (hi - lo)
        x = med * math.exp(sigma * normal.inv_cdf(q))
        return min(max(x, low), high)
    raise ValueError(f"unknown distribution {kind!r}")


def strata(traffic: dict) -> List[float]:
    """The mix's unit lengths in seconds, one per stratum, ascending."""
    n = traffic["strata"]
    return [quantile(traffic["seconds"], (i + 0.5) / n) for i in range(n)]


def units(traffic: dict, seed: int) -> Iterator[dict]:
    """Endless units: {seconds, phase, stride, start_ms}, cycling through
    the strata in an order drawn anew each cycle."""
    r = rng(seed, "units")
    lengths = strata(traffic)
    lo, hi = traffic.get("stride", [1, 1])
    while True:
        for i in r.permutation(len(lengths)):
            yield {"seconds": lengths[i], "phase": int(r.integers(0, 1 << 20)),
                   "stride": int(r.integers(lo, hi + 1)),
                   "start_ms": int(r.integers(0, 600_000))}


def check_picks(traffic: dict, seed: int) -> set:
    """Indices, among the window's first `check_among` units, of the ones
    the check compares with the reference: `check_units` of them, drawn
    from the seed, the longest among them."""
    ahead = units(traffic, seed)
    first = [next(ahead)["seconds"] for _ in range(traffic["check_among"])]
    r = rng(seed, "check")
    picks = set(r.choice(len(first), traffic["check_units"] - 1, replace=False).tolist())
    picks.add(max(range(len(first)), key=first.__getitem__))
    return picks


def warm_units(traffic: dict) -> List[dict]:
    """`warm` units of lengths spread over the strata, the shortest and the
    longest among them: the shapes a window will meet."""
    lengths = strata(traffic)
    n = min(traffic["warm"], len(lengths))
    picks = sorted({round(i * (len(lengths) - 1) / max(n - 1, 1)) for i in range(n)})
    return [{"seconds": lengths[i], "phase": 7 * i, "stride": 1, "start_ms": 0}
            for i in picks]


def pool_index(k: int, n: int) -> int:
    """Step k of a triangle wave over 0 .. n - 1."""
    period = 2 * (n - 1)
    k %= period
    return k if k < n else period - k


def _smooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian over the last two axes, zero borders, as sums of
    shifted slices (no convolution, so the same bits on every run)."""
    k = int(sigma * 4) | 1
    t = torch.arange(k, dtype=torch.float64) - k // 2
    taps = torch.exp(-(t * t) / (2 * sigma * sigma))
    taps = (taps / taps.sum()).tolist()
    for dim in (-2, -1):
        n = x.shape[dim]
        pad = [0, 0, 0, 0]
        pad[0 if dim == -1 else 2] = pad[1 if dim == -1 else 3] = k // 2
        p = torch.nn.functional.pad(x[None], pad)[0]
        x = sum(c * p.narrow(dim, i, n) for i, c in enumerate(taps))
    return x


def frame_pool(h: int, w: int, n: int, seed: int, device) -> List[np.ndarray]:
    """n uint8 (h, w) host frames of one texture drawn from the seed on
    `device`, frame k cropped (k // 2, k) px from the first."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    base = torch.rand((h + n // 2, w + n), generator=gen, device=device) * 255.0
    base = _smooth(base, 3.0)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    base = base.to(torch.uint8)
    crops = torch.stack([base[k // 2:k // 2 + h, k:k + w] for k in range(n)])
    return list(crops.cpu().numpy())
