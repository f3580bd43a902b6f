"""kernels.device_ms_per_pair: the device time of every kernel in the
traced window (copies aside), in ms, over the frame pairs it ran."""


def read(r):
    if r.trace is None or not r.pairs:
        return None
    return r.kernel_seconds() * 1e3 / r.pairs
