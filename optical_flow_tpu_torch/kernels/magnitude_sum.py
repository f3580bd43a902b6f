"""X2: per-pair sums of the flow magnitude (`csrc/magnitude_sum.cu`).

Replaces what the JAX package leaves to one XLA fusion (no
`pl.pallas_call`): `cart_to_polar(...)[0]` then `jnp.sum` over each
pair's pixels (`optical_flow_tpu/pipeline/extractor.py:113-114`; the
angle is never read).  Planar (B, 2, H, W) f32 -> (B,) f32 in one launch
(two past 2^17 pixels a pair), where the eager version makes five (mul,
mul, add, sqrt, sum).

Each pixel's magnitude is `sqrt(x*x + y*y)` as `ops/polar.py:magnitude`
computes it (two products and a sum, `--fmad=false`, correctly rounded
sqrt); each pair's magnitudes are summed in f64 and rounded to f32 once.
A pair is cut into spans of 2^17 pixels, one block each, which sums its
span thread by thread in a fixed stride and then by a fixed tree; a pair
of one span is rounded there, else a second launch adds the span sums in
span order.  No atomics: the order depends on (H, W) alone, so a pair's
sum is the same in any batch and on every run, and within one f32 ulp of
the plain version (`ops/polar.py:magnitude_sums`).  `LAUNCHES["X2"]`
counts the kernels a call launches: one a batch of pairs of one span,
two past it.  Bound on the card by bytes: the flow read once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from optical_flow_tpu_torch.kernels import (LAUNCHES, _build, check, on_cuda,
                                            raise_on_error)
from optical_flow_tpu_torch.ops import polar

# Pairs one launch takes: the grid's second axis.
_MAX_PAIRS = 65535


@functools.lru_cache(maxsize=None)
def _kernel():
    """(the C entry, the spans a pair of hw pixels is cut into)."""
    lib = _build.library("magnitude_sum")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    run, spans = lib.oft_magnitude_sum, lib.oft_magnitude_sum_spans
    run.argtypes, run.restype = [p, i, q, p, p, i, p], i
    spans.argtypes, spans.restype = [q], i
    return run, spans


def magnitude_sum(flow: torch.Tensor) -> torch.Tensor:
    """Planar (B, 2, H, W) f32 flow -> (B,) f32 sums of its magnitude per
    pair.  A CUDA tensor launches X2 (contiguous input, as
    `calc_flow_batched(...).movedim(-1, 1)` gives it); a CPU tensor runs
    `ops/polar.py:magnitude_sums`."""
    if flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"expected planar (B, 2, H, W) flow, got {tuple(flow.shape)}")
    if not on_cuda(flow):
        return polar.magnitude_sums(flow[:, 0], flow[:, 1])
    dev = flow.device
    check(flow, "flow", dev, (torch.float32,), 4)
    b, _, h, w = flow.shape
    if b == 0 or h * w == 0:
        return torch.zeros((b,), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    run, spans_of = _kernel()
    spans = spans_of(h * w)
    partial = (torch.empty((min(b, _MAX_PAIRS), spans), dtype=torch.float64, device=dev)
               if spans > 1 else None)
    for lo in range(0, b, _MAX_PAIRS):
        part = flow[lo:lo + _MAX_PAIRS]
        rc = run(part.data_ptr(), part.shape[0], h * w,
                 None if partial is None else partial.data_ptr(), out[lo:].data_ptr(),
                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
        raise_on_error(rc, "magnitude_sum")
        LAUNCHES["X2"] += 1 if spans == 1 else 2
    return out
