"""kernels.k1_roofline_pct: K1's least time (`portbench/k1_work.py`: 56 B
a pixel a step over 3.35 TB/s, or its f32 operations over 67 TFLOP/s, the
larger, with the window sums the configuration's flags ask for), over
every level and iteration of every pair the traced window ran, over the
device time of the trace's `update_blur_kernel` operations
(`csrc/update_blur.cu`), in %.  None without a trace or without K1 in it."""

from portbench import k1_work, yardstick
from portbench.reference import farneback as ref_farneback

KERNEL = "update_blur_kernel"


def read(r):
    if r.trace is None:
        return None
    ns = sum(o.end - o.start for o in r.trace.kernels() if KERNEL in o.name)
    if ns <= 0:
        return None
    fb = r.cfg["farneback"]
    levels = yardstick.level_taps(ref_farneback.level_plan(
        r.runner.h, r.runner.w, fb["levels"], fb["pyr_scale"]))
    return 100.0 * k1_work.least_seconds(r.runner.chunks(), levels, fb) / (ns * 1e-9)
