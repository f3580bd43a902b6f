"""device.idle_pct: the share of the traced window in which no operation
ran on a card (the union of its kernels' and copies' intervals, so streams
that overlap count once), in %, averaged over the cell's cards."""

from portbench import trace


def read(r):
    if r.trace is None or not r.devices:
        return None
    busy = trace.busy_by_device(r.trace, r.devices)
    return sum(100.0 * (1.0 - b / r.trace.window_s) for b in busy.values()) / len(busy)
