"""Farnebäck dense optical flow: the batched entry points of the port.

Port of `optical_flow_tpu.models.farneback.flow` (`_flow_pyramid`,
`calc_flow_batched`, `calc_flow_chain_batched`, `calc_flow_bgr_batched`,
`calc_flow_bgr_chain_batched`) with no initial flow and the box window.
Every level runs the same three stages on the tensors' device: K3
`gauss_resize` builds the level from the full-resolution frame (levels
k > 0), K2 `poly_exp` expands the frames (with the 3-tap pre-smooth at
level 0), and the K1 loop iterates the flow.  Between levels the flow is
upsampled x2 in plain PyTorch.  The BGR entries end with K4
`flow_to_bgr_planar`.  CUDA tensors go through the kernels, CPU tensors
through their plain versions; there is no shape gate.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels.fused_iterate import update_flow_fused
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.params import (FarnebackPlan,
                                                            build_plan,
                                                            gaussian_kernel)
from optical_flow_tpu_torch.ops import colorize
from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32
from optical_flow_tpu_torch.utils.config import FarnebackConfig


def _flow_pyramid(frames: torch.Tensor, plan: FarnebackPlan, plain: bool,
                  chain: bool) -> torch.Tensor:
    """Coarse-to-fine schedule on an (N, H, W) uint8/f32 frame batch.

    chain=False: the batch holds the B first frames, then the B second
    frames (N = 2B).  chain=True: N consecutive frames, and the flow is
    that of the N-1 pairs (i, i+1); each frame is resized and expanded
    once, and R[:-1] / R[1:] (contiguous views) are the iterate's
    operands.  Returns (B, 2, H, W) f32 with B = N // 2 or N - 1.
    plain=True runs the kernels' plain versions on any device."""
    cfg = plan.config
    if plain:
        level_fn, poly_fn, iterate_fn = (core.gaussian_blur_resize,
                                         core.poly_exp, core.update_flow)
    else:
        level_fn, poly_fn, iterate_fn = (gauss_resize, poly_exp,
                                         update_flow_fused)
    B = frames.shape[0] - 1 if chain else frames.shape[0] // 2
    flow = None
    for lv in plan.levels:
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        if lv.k > 0:
            # every level is built from the original frame, never from
            # another level
            imgs = level_fn(frames, kern, lv.width, lv.height)
            R = poly_fn(imgs, cfg.poly_n, cfg.poly_sigma)
        else:
            R = poly_fn(frames, cfg.poly_n, cfg.poly_sigma, pre_taps=kern)
        if flow is None:
            flow = torch.zeros((B, 2, lv.height, lv.width),
                               dtype=torch.float32, device=frames.device)
        else:
            flow = resize_bilinear_f32(flow, lv.width, lv.height)
            flow = flow * float(np.float32(1.0 / cfg.pyr_scale))
        R0, R1 = (R[:-1], R[1:]) if chain else (R[:B], R[B:])
        flow = iterate_fn(R0, R1, flow, cfg.winsize, cfg.iterations)
    return flow


def _on_device(frames: torch.Tensor, device) -> torch.Tensor:
    """Frames moved to `device`: uint8 stays uint8 (cast on the device by
    the kernels), anything else becomes f32."""
    frames = frames.to(device)
    return frames if frames.dtype == torch.uint8 else frames.float()


def _pair_batch(prev, nxt, device) -> torch.Tensor:
    """(B, H, W) prev and next frames -> the (2B, H, W) batch of both."""
    prev = torch.as_tensor(prev)
    nxt = torch.as_tensor(nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    if prev.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(prev.shape)}")
    device = prev.device if device is None else torch.device(device)
    return _on_device(torch.cat([prev, nxt.to(prev.device)]), device)


def _chain_batch(frames, device) -> torch.Tensor:
    frames = torch.as_tensor(frames)
    if frames.dim() != 3:
        raise ValueError(f"expected (N, H, W), got {tuple(frames.shape)}")
    if frames.shape[0] < 2:
        raise ValueError("chain needs at least 2 frames")
    device = frames.device if device is None else torch.device(device)
    return _on_device(frames, device)


def _flow(frames: torch.Tensor, config: FarnebackConfig, plain: bool,
          chain: bool) -> torch.Tensor:
    if config.use_initial_flow or config.gaussian_window:
        raise NotImplementedError(
            "the port runs flags=0 only: no initial flow, box window")
    _, h, w = frames.shape
    return _flow_pyramid(frames, build_plan(h, w, config), plain, chain)


def _bgr(flow: torch.Tensor, plain: bool) -> torch.Tensor:
    return (colorize.flow_to_bgr_planar(flow) if plain
            else flow_to_bgr_planar(flow))


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
    both = _pair_batch(prev, nxt, device)
    return _flow(both, config, plain, chain=False).movedim(1, -1)


def calc_flow_chain_batched(frames, config: FarnebackConfig = FarnebackConfig(),
                            *, device=None, plain: bool = False) -> torch.Tensor:
    """Dense flow for the N-1 consecutive pairs of an (N, H, W) frame
    batch: (N-1, H, W, 2), equal to calc_flow_batched(frames[:-1],
    frames[1:]) with each frame resized and expanded once, not twice (the
    visualizer's workload, `visualize_optical_flow.py:62`).  `device` and
    `plain` as in calc_flow_batched."""
    frames = _chain_batch(frames, device)
    return _flow(frames, config, plain, chain=True).movedim(1, -1)


def calc_flow_bgr_batched(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
                          *, device=None, plain: bool = False) -> torch.Tensor:
    """Dense flow + the reference's colorization for a batch of pairs:
    (B, H, W) frames -> planar BGR uint8 (B, 3, H, W)
    (`visualize_optical_flow.py:38-55`)."""
    both = _pair_batch(prev, nxt, device)
    return _bgr(_flow(both, config, plain, chain=False), plain)


def calc_flow_bgr_chain_batched(frames,
                                config: FarnebackConfig = FarnebackConfig(),
                                *, device=None, plain: bool = False) -> torch.Tensor:
    """Chained-pair flow + colorization: (N, H, W) frames -> planar BGR
    uint8 (N-1, 3, H, W) for the pairs (i, i+1)."""
    frames = _chain_batch(frames, device)
    return _bgr(_flow(frames, config, plain, chain=True), plain)
