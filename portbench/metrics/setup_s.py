"""setup_s: seconds from the process's start to the window's: imports,
loading (or, in a checkout's first run, building) the kernels, the frame
pool made from the seed, and the warm-up of the cell's shapes."""


def read(r):
    return r.setup_s
