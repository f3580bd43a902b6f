"""Farnebäck dense optical flow: the batched entry point of the port.

Port of `optical_flow_tpu.models.farneback.flow` (`_flow_pyramid`,
`_jitted_batched`, `calc_flow_batched`) for independent pairs with no
initial flow.  Every level runs the same three stages on the tensors'
device: K3 `gauss_resize` builds the level from the full-resolution frame
(levels k > 0), K2 `poly_exp` expands both frames (with the 3-tap
pre-smooth at level 0), and the K1 loop iterates the flow.  Between
levels the flow is upsampled x2 in plain PyTorch.  CUDA tensors go
through the kernels, CPU tensors through their plain versions; there is
no shape gate.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels.fused_iterate import update_flow_fused
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.params import (FarnebackPlan,
                                                            build_plan,
                                                            gaussian_kernel)
from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32
from optical_flow_tpu_torch.utils.config import FarnebackConfig


def _flow_pyramid(both: torch.Tensor, plan: FarnebackPlan,
                  plain: bool) -> torch.Tensor:
    """Coarse-to-fine schedule on a (2B, H, W) uint8/f32 batch holding the
    B first frames, then the B second frames.  Returns (B, 2, H, W) f32.
    plain=True runs the kernels' plain versions on any device."""
    cfg = plan.config
    if plain:
        level_fn, poly_fn, iterate_fn = (core.gaussian_blur_resize,
                                         core.poly_exp, core.update_flow)
    else:
        level_fn, poly_fn, iterate_fn = (gauss_resize, poly_exp,
                                         update_flow_fused)
    B = both.shape[0] // 2
    flow = None
    for lv in plan.levels:
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        if lv.k > 0:
            # every level is built from the original frame, never from
            # another level
            imgs = level_fn(both, kern, lv.width, lv.height)
            R = poly_fn(imgs, cfg.poly_n, cfg.poly_sigma)
        else:
            R = poly_fn(both, cfg.poly_n, cfg.poly_sigma, pre_taps=kern)
        if flow is None:
            flow = torch.zeros((B, 2, lv.height, lv.width),
                               dtype=torch.float32, device=both.device)
        else:
            flow = resize_bilinear_f32(flow, lv.width, lv.height)
            flow = flow * float(np.float32(1.0 / cfg.pyr_scale))
        flow = iterate_fn(R[:B], R[B:], flow, cfg.winsize, cfg.iterations)
    return flow


def calc_flow_batched(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
                      *, device=None, plain: bool = False) -> torch.Tensor:
    """Dense Farnebäck flow for a batch of frame pairs.

    prev, nxt: (B, H, W) uint8 or float frames, numpy arrays or tensors.
    device: where to run; by default the device of `prev`.  uint8 frames
    are uploaded as uint8 and cast on the device.  Returns (B, H, W, 2)
    f32 flow (x-displacement, y-displacement), a view of the planar
    (B, 2, H, W) result.  plain=True runs the plain PyTorch versions of
    the kernels on the device as well: the reference that the kernel path
    is held to on the card.
    """
    prev = torch.as_tensor(prev)
    nxt = torch.as_tensor(nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    if prev.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(prev.shape)}")
    if config.use_initial_flow or config.gaussian_window:
        raise NotImplementedError(
            "the port runs flags=0 only: no initial flow, box window")
    device = prev.device if device is None else torch.device(device)
    both = torch.cat([prev, nxt.to(prev.device)]).to(device)
    if both.dtype != torch.uint8:
        both = both.float()
    _, h, w = prev.shape
    flow = _flow_pyramid(both, build_plan(h, w, config), plain)
    return flow.movedim(1, -1)
