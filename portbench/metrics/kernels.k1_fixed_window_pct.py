"""kernels.k1_fixed_window_pct: the device time of K1's instantiation with
the window's half-width built in (`update_blur_kernel<true, 7>`,
`<false, 7>` in `csrc/update_blur.cu`) over that of every
`update_blur_kernel` operation in the traced window, in %.  A program
whose K1 has no such instantiation (`update_blur_kernel<true>`, or
`<true, 0>`: the run-time half-width) reads 0; None without a trace or
without K1 in it."""

import re

KERNEL = "update_blur_kernel"
# the template arguments as a traced run prints them (`void (anonymous
# namespace)::update_blur_kernel<true, 7>(float const*, ...)`): the
# window, then the half-width, 0 where it is read at run time
FIXED = re.compile(r"update_blur_kernel<(?:true|false), ([0-9]+)>")


def fixed(name: str) -> bool:
    match = FIXED.search(name)
    return match is not None and int(match.group(1)) > 0


def read(r):
    if r.trace is None:
        return None
    ops = [o for o in r.trace.kernels() if KERNEL in o.name]
    ns = sum(o.end - o.start for o in ops)
    if ns <= 0:
        return None
    return 100.0 * sum(o.end - o.start for o in ops if fixed(o.name)) / ns
