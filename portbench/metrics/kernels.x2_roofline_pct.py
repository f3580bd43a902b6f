"""kernels.x2_roofline_pct: the least time of X2's compulsory bytes
(`yardstick.work_magnitude_sum`: each pair's planar f32 flow read once and
its sum written once, for every pair the traced window ran) at the HBM
peak, over X2's own device time in the window (the trace's kernels
`span_sum_kernel` and `combine_kernel` of `csrc/magnitude_sum.cu`), in %.
The span sums the first launch writes and the second reads are
intermediate, as `yardstick` counts them, so the share cannot pass 100 %."""

from portbench import yardstick

KERNELS = ("span_sum_kernel", "combine_kernel")


def read(r):
    if r.trace is None:
        return None
    ns = sum(o.end - o.start for o in r.trace.kernels() if any(k in o.name for k in KERNELS))
    if ns <= 0:
        return None
    need = sum(yardstick.work_magnitude_sum(c.pairs, c.h, c.w)[0] for c in r.runner.chunks())
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / (ns * 1e-9)
