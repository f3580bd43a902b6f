"""The per-level iterate loop over K1 (`update_gather.update_blur`).

Replaces `optical_flow_tpu/pallas/fused_iterate.py` (`update_flow_fused`,
`:146-272`): `iterations` launches of the fused step.  A step reads its
neighbours' flow, so it cannot write in place; the loop ping-pongs
between two buffers allocated once per level, and never writes the
caller's flow.
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.kernels import on_cuda
from optical_flow_tpu_torch.kernels.update_gather import update_blur
from optical_flow_tpu_torch.models.farneback import core


def update_flow_fused(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor,
                      winsize: int, iterations: int) -> torch.Tensor:
    """One pyramid level's iterations: flow (B, 2, H, W) -> new flow."""
    if not on_cuda(flow):
        return core.update_flow(R0, R1, flow, winsize, iterations)
    bufs = (torch.empty_like(flow), torch.empty_like(flow))
    for i in range(iterations):
        flow = update_blur(R0, R1, flow, winsize, out=bufs[i % 2])
    return flow
