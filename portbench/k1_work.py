"""The least work of K1, the iterate step (`csrc/update_blur.cu`), with the
window the configuration asks for: what `kernels.k1_roofline_pct` divides
by.

A step of one pixel reads R0 and the flow, gathers R1 and writes the new
flow: 56 B (`yardstick.work_step`).  It computes M (`yardstick.M_OPS`),
the five channels' window sums and the solve (`yardstick.SOLVE_OPS`).  The
window sums count the least that the window needs:

- the box (flags 0): running sums, 2 operations a channel a pass, 20 a
  pixel at any window size (`yardstick.WINDOW_OPS`);
- the Gaussian (flags 256): 2m + 1 taps of a symmetric window, m =
  winsize // 2, folded: m adds of the mirrored values, m + 1 multiplies
  and m adds a channel a pass, 10 (3m + 1) a pixel (220 at winsize 15).
  `chip_smoke.py` counts the direct sum, 10 (4m + 1).

A step's least time is the larger of its bytes over the HBM peak and its
operations over the f32 peak; the sum runs over every level and
iteration of every pair, so a share of it cannot pass 100 %.
"""

from __future__ import annotations

from portbench import yardstick

GAUSSIAN = 256          # OPTFLOW_FARNEBACK_GAUSSIAN
STEP_BYTES = 56         # R0 (20 B), the flow (8 B) and R1 (20 B) read; the flow (8 B) written


def window_ops(winsize: int, flags: int) -> int:
    """The f32 operations of a pixel's five window sums."""
    if flags & GAUSSIAN:
        return 10 * (3 * (winsize // 2) + 1)
    return yardstick.WINDOW_OPS


def work_step(b: int, h: int, w: int, winsize: int, flags: int) -> tuple:
    """(bytes, f32 operations) of one K1 step on b pairs at (h, w)."""
    px = b * h * w
    return STEP_BYTES * px, px * (yardstick.M_OPS + window_ops(winsize, flags)
                                  + yardstick.SOLVE_OPS)


def step_seconds(b: int, h: int, w: int, winsize: int, flags: int) -> float:
    nbytes, ops = work_step(b, h, w, winsize, flags)
    return max(nbytes / yardstick.HBM_BYTES_PER_S, ops / yardstick.F32_FLOPS)


def least_seconds(chunks, levels, fb: dict) -> float:
    """K1's least time over every level and iteration of every chunk.
    levels: [(k, height, width, ntaps)] coarse to fine; fb: the
    configuration's `farneback` dict."""
    per_pair = sum(step_seconds(1, lh, lw, fb["winsize"], fb["flags"])
                   for _, lh, lw, _ in levels) * fb["iterations"]
    return per_pair * sum(c.pairs for c in chunks)
