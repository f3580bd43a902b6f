"""pairs_per_s: frame pairs whose output reached the host inside the
window (a window's magnitude sum, or a BGR image handed to the write
callback), over the whole window."""


def read(r):
    return sum(u["pairs_in_time"] for u in r.runner.records) / r.seconds
