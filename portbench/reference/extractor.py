"""The reference extractor's host arithmetic (`optical_flow.py:69-125` of
JacobLoe/optical_flow): the window schedule, the per-position aggregate,
the percentile scaling and the CSV line.  Plain Python and NumPy, a frozen
copy that imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def window_schedule(tot_frames: int, fps: float, step_ms: int, window_ms: int):
    """([(start, end)] centred every `step` frames, step), ms -> frames
    truncated as the reference does."""
    step = int(fps * step_ms / 1000)
    half = int(int(fps * window_ms / 1000) / 2.0)
    if step <= 0:
        raise ValueError(f"step of {step_ms} ms is under one frame at {fps} fps")
    return [(max(0, c - half), min(tot_frames - 1, c + half))
            for c in range(0, tot_frames, step)], step


def aggregate(sums, windows, tot_frames: int, fps: float, step: int):
    """Per sampled position, the mean of the sums of the windows with
    start <= pos < end; ([means], [start_ms, end_ms]) of the first and
    last position that had one.  Each window adds its sum to the positions
    it covers, in window order, so every position's list is the one the
    reference's scan over all windows builds."""
    covered = {}
    for v, (s, e) in zip(sums, windows):
        for pos in range(-(-s // step) * step, min(e, tot_frames), step):
            covered.setdefault(pos, []).append(v)
    agg = [(pos, float(np.mean(covered[pos]))) for pos in range(0, tot_frames, step)
           if pos in covered]
    if not agg:
        raise ValueError("no window to aggregate")
    return [a[1] for a in agg], [int(agg[0][0] / fps * 1000), int(agg[-1][0] / fps * 1000)]


def scale_magnitudes(mag, top_percentile: int) -> list:
    """Divided by the top_percentile-th percentile, clipped to [0, 1],
    x100, rounded to 2 decimals."""
    mag = np.asarray(mag)
    scaled = np.clip(mag / np.percentile(mag, top_percentile), a_min=0, a_max=1) * 100.0
    return list(np.round(scaled, decimals=2))


def csv_line(mag, stamps) -> str:
    """`<start_ms>\\t<end_ms>\\t<m1 m2 ...>`."""
    return f"{stamps[0]}\t{stamps[1]}\t" + " ".join(str(m) for m in mag)
