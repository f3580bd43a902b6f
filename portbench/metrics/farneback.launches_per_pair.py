"""farneback.launches_per_pair: the port's own count of kernel launches
(`kernels.LAUNCHES`, summed over the kernels) in the traced window, over the
frame pairs it ran."""


def read(r):
    if not r.pairs:
        return None
    return r.launches / r.pairs
