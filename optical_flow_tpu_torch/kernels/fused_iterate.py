"""A pyramid level's iterate loop on the card: K1, or K5a -> K5b.

Replaces `optical_flow_tpu/pallas/fused_iterate.py` (`update_flow_fused`,
`:146-272`, with its column-chunked branch for wide frames, `:237-262`)
and the unfused Pallas loop of
`optical_flow_tpu/models/farneback/flow.py:316-342` (K5a, then K5b, per
iteration).  `update_flow` picks by the window alone: a box or Gaussian
window goes to K1 while K1's tile fits (`k1_fits`, winsize <= 61),
larger windows to K5a -> K5b.  Both give the same flow to the bit; K1 is
the faster of the two on the smooth flow the pyramid iterates on, with
either window (chip_smoke.py's `ab_K1_vs_K5a_K5b_box` and `ab_K1_vs_K5a_K5b_gauss`,
PERF.md).  Buffers are allocated once per level and the caller's flow
is never written.

`update_flow_fused_poly` replaces `update_flow_fused_poly`
(`optical_flow_tpu/pallas/fused_iterate.py:283-334`): the level's
iterations on K7, from the level images, with no K2.  The JAX package
keeps it behind `FUSE_POLYEXP` (`:88`, off); so does the port, where
`chip_smoke.py`'s `ab_K7_vs_K2_K1` measured K7 slower than K2 + K1 at
every level shape it drives (PERF.md), so `use_fused_poly` sends a level
to K7 only where a caller sets the switch.  The TPU kernel's replay of
spilled frames through the unfused path (`:316-328`) has no counterpart:
the card's gather is exact for any displacement.
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.kernels import on_cuda
from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
from optical_flow_tpu_torch.kernels.update_gather import (k1_fits, k7_fits,
                                                          update_blur,
                                                          update_blur_poly,
                                                          update_matrices)
from optical_flow_tpu_torch.models.farneback import core

# The JAX package's switch of the same name (off there too): with it on,
# every level whose window and expansion fit K7's tile iterates on K7.
FUSE_POLYEXP = False


def update_flow_fused(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                      winsize: int, iterations: int,
                      gaussian: bool = False) -> torch.Tensor:
    """`iterations` K1 steps, box or Gaussian window: flow (B, 2, H, W) ->
    new flow.  A step reads its neighbours' flow, so it cannot write in
    place; the loop ping-pongs between two buffers."""
    if not on_cuda(flow):
        return core.update_flow(R0, R1, flow, winsize, iterations, gaussian)
    bufs = (torch.empty_like(flow), torch.empty_like(flow))
    for i in range(iterations):
        flow = update_blur(R0, R1, flow, winsize, gaussian, out=bufs[i % 2])
    return flow


def update_flow_unfused(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                        winsize: int, iterations: int,
                        gaussian: bool = False) -> torch.Tensor:
    """`iterations` K5a -> K5b steps, box or Gaussian window.  K5b reads
    only M, and K5a has read the flow before K5b writes it (one stream),
    so one M buffer and one flow buffer serve every iteration."""
    if not on_cuda(flow):
        return core.update_flow(R0, R1, flow, winsize, iterations, gaussian)
    M = torch.empty(R0.shape, dtype=torch.float32, device=flow.device)
    new = torch.empty_like(flow)
    for _ in range(iterations):
        flow = blur_solve(update_matrices(R0, R1, flow, out=M), winsize,
                          gaussian, out=new)
    return flow


def update_flow(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                winsize: int, iterations: int,
                gaussian: bool = False) -> torch.Tensor:
    """One pyramid level's iterations: flow (B, 2, H, W) -> new flow, on
    K1 for a window that fits its tile, else on K5a -> K5b; a CPU tensor
    runs the plain loop."""
    if not on_cuda(flow):
        return core.update_flow(R0, R1, flow, winsize, iterations, gaussian)
    if k1_fits(winsize):
        return update_flow_fused(R0, R1, flow, winsize, iterations, gaussian)
    return update_flow_unfused(R0, R1, flow, winsize, iterations, gaussian)


def use_fused_poly(winsize: int, poly_n: int) -> bool:
    """Whether a level iterates on K7 (`update_flow_fused_poly`) instead
    of K2 + K1: where `FUSE_POLYEXP` is on and K7's tile fits."""
    return FUSE_POLYEXP and k7_fits(winsize, poly_n)


def update_flow_fused_poly(imgs0: torch.Tensor, imgs1: torch.Tensor,
                           flow: torch.Tensor, winsize: int, iterations: int,
                           gaussian: bool = False, *, poly_n: int,
                           poly_sigma: float, pre_taps=None) -> torch.Tensor:
    """`iterations` K7 steps from the level images imgs0, imgs1 (B, H, W)
    (the raw frames with `pre_taps` at level 0): flow (B, 2, H, W) -> new
    flow, ping-ponging between two buffers.  A CPU tensor runs the plain
    loop, which expands each image once."""
    if not on_cuda(flow):
        R0 = core.poly_exp(imgs0, poly_n, poly_sigma, pre_taps)
        R1 = core.poly_exp(imgs1, poly_n, poly_sigma, pre_taps)
        return core.update_flow(R0, R1, flow, winsize, iterations, gaussian)
    bufs = (torch.empty_like(flow), torch.empty_like(flow))
    for i in range(iterations):
        flow = update_blur_poly(imgs0, imgs1, flow, winsize, gaussian, poly_n,
                                poly_sigma, pre_taps, out=bufs[i % 2])
    return flow
