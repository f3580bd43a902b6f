"""The least work of the Farnebäck pipeline, counted from shapes, and the
chip's published peaks: what `kernels.roofline_pct` divides by.

The per-stage counts are frozen copies of `chip_smoke.py`'s `work_level`
(K3), `work_polyexp` (K2), `work_step` (K1), `work_resample` (X1's x2
upsample), `work_magnitude_sum` (X2) and K4's (11 B, 40 operations a
pixel), taken on shapes rather than tensors: (bytes, f32 operations), each
input byte read once, each output byte written once, each multiply and add
counted once.  K1's window sums are counted as running sums (`WINDOW_OPS`),
not as the direct sums `chip_smoke.py` counts.

`least_seconds` is what a chunk needs whatever kernels run it: the
operations of every stage of the algorithm, but only the bytes that must
cross HBM for the call (its frames in, its outputs out); a stage's
intermediate result that a fused kernel keeps on chip is no compulsory
traffic.  So no fusing or splitting of kernels can take a chunk below it.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np

# One H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit): HBM3
# bandwidth and f32 outside the tensor cores (a fused multiply-add is two
# operations, as the counts below count a multiply and an add).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

M_OPS = 36        # displaced fetch + M per pixel
SOLVE_OPS = 19    # scale + 2x2 solve per pixel
BGR_OPS = 40      # magnitude, fastAtan2 and HSV -> BGR per pixel


def work_level(n: int, h: int, w: int, elem: int, ntaps: int, oh: int, ow: int) -> tuple:
    """K3: n frames (h, w) of `elem` bytes read once, the f32 level
    written; vertical sums at two source rows per output row over the
    frame's width, four horizontal sums and the two lerps per output."""
    out = n * oh * ow
    return (n * h * w * elem + 4 * out, n * 2 * oh * w * 2 * ntaps + out * (4 * 2 * ntaps + 6))


def work_polyexp(n: int, h: int, w: int, elem: int, poly_n: int, pre: bool) -> tuple:
    """K2: the frames read, R (5 f32) written; three vertical and six
    horizontal correlations of 2n + 1 taps, the combination, and the 3x3
    pre-smooth at level 0."""
    px = n * h * w
    return px * (elem + 20), px * (18 * (2 * poly_n + 1) + 9 + (20 if pre else 0))


# Five channels' box sums per pixel, the least that any window size needs:
# running sums, each of two passes (vertical, then horizontal) adding the
# value that enters the window and taking away the one that leaves.
WINDOW_OPS = 5 * 2 * 2


def work_step(b: int, h: int, w: int) -> tuple:
    """K1, one iterate step: R0 and the flow read, the R1 gather, the new
    flow written (56 B/px); M, the window sums and the solve."""
    px = b * h * w
    return 56 * px, px * (M_OPS + WINDOW_OPS + SOLVE_OPS)


def work_upsample(b: int, h: int, w: int, dh: int, dw: int) -> tuple:
    """X1's x2 flow upsample with its scale, (b, 2) planes (h, w) ->
    (dh, dw): the source read once, the output written once, the
    horizontal pass over the source rows (3 operations a value) and the
    vertical (2 taps, 2 operations each) with the scale."""
    n = 2 * b
    return n * h * w * 4 + n * dh * dw * 4, n * h * dw * 3 + n * dh * dw * 4


def work_magnitude_sum(b: int, h: int, w: int) -> tuple:
    """X2: the planar flow read once, the sums written; two multiplies,
    an add and a sqrt a pixel."""
    return b * 2 * h * w * 4 + b * 4, 4 * b * h * w


def work_colorize(b: int, h: int, w: int) -> tuple:
    """K4: the flow read once, BGR written once (11 B/px)."""
    return 11 * b * h * w, BGR_OPS * b * h * w


class Chunk(NamedTuple):
    """One dispatch of the pipeline: `pairs` frame pairs of (h, w) uint8
    frames, chained (pairs + 1 frames) or not (2 * pairs), ending in
    magnitude sums ("sums") or BGR images ("bgr")."""
    pairs: int
    h: int
    w: int
    chain: bool
    output: str


def chunk_work(chunk: Chunk, levels: Iterable[tuple], fb: dict) -> dict:
    """Per stage of the algorithm, (bytes, ops) of one chunk.  levels:
    [(k, height, width, ntaps)] coarse to fine."""
    b, h, w = chunk.pairs, chunk.h, chunk.w
    frames = b + 1 if chunk.chain else 2 * b
    work = {"level": [0, 0], "polyexp": [0, 0], "iterate": [0, 0], "upsample": [0, 0]}

    def add(stage, bo):
        work[stage][0] += bo[0]
        work[stage][1] += bo[1]

    prev = None
    for k, lh, lw, ntaps in levels:
        if k > 0:
            add("level", work_level(frames, h, w, 1, ntaps, lh, lw))
            add("polyexp", work_polyexp(frames, lh, lw, 4, fb["poly_n"], False))
        else:
            add("polyexp", work_polyexp(frames, lh, lw, 1, fb["poly_n"], True))
        if prev is not None:
            add("upsample", work_upsample(b, prev[0], prev[1], lh, lw))
        for _ in range(fb["iterations"]):
            add("iterate", work_step(b, lh, lw))
        prev = (lh, lw)
    if chunk.output == "sums":
        work["magnitude_sum"] = list(work_magnitude_sum(b, h, w))
    else:
        work["colorize"] = list(work_colorize(b, h, w))
    return {k: tuple(v) for k, v in work.items()}


def compulsory_bytes(chunk: Chunk) -> int:
    """The bytes a chunk must move whatever runs it: its uint8 frames read
    once and its outputs (f32 sums, or 3-byte BGR pixels) written once."""
    frames = chunk.pairs + 1 if chunk.chain else 2 * chunk.pairs
    out = 4 * chunk.pairs if chunk.output == "sums" else 3 * chunk.pairs * chunk.h * chunk.w
    return frames * chunk.h * chunk.w + out


def least_seconds(chunk: Chunk, levels, fb: dict) -> tuple:
    """(seconds, "ops" or "bytes"): the larger of the algorithm's f32
    operations over the f32 peak and the compulsory bytes over HBM's."""
    ops = sum(v[1] for v in chunk_work(chunk, levels, fb).values())
    t_ops = ops / F32_FLOPS
    t_bytes = compulsory_bytes(chunk) / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def level_taps(plan) -> list:
    """A reference level plan [(k, h, w, taps)] as [(k, h, w, ntaps)]."""
    return [(k, lh, lw, len(np.asarray(t))) for k, lh, lw, t in plan]
