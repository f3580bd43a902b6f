"""kernels.roofline_pct: the least time the chip needs for the algorithm's
work on every unit the traced window ran (`yardstick.least_seconds`: its
f32 operations over 67 TFLOP/s, or its compulsory bytes over 3.35 TB/s,
the larger), over the device time of every kernel in the window (copies
aside), in %."""


def read(r):
    if r.trace is None:
        return None
    k = r.kernel_seconds()
    if k <= 0:
        return None
    return 100.0 * r.least_seconds() / k
