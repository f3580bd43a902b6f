"""Farnebäck dense optical flow: the entry points of the port.

Port of `optical_flow_tpu.models.farneback.flow` (`_flow_pyramid`,
`calc_flow`, `calc_flow_batched`, `calc_flow_chain_batched`,
`calc_flow_bgr_batched`, `calc_flow_bgr_chain_batched`), every flag of
cv2's contract: the box or Gaussian window (OPTFLOW_FARNEBACK_GAUSSIAN)
and the seeded start (OPTFLOW_USE_INITIAL_FLOW).  Every level runs the
same three stages on the tensors' device: K3 `gauss_resize` builds the
level from the full-resolution frame (levels k > 0; the deeper levels
whose Gaussian K3 does not take run K6 `gaussian_blur` and the bilinear
resize), K2 `poly_exp` expands the frames (with the 3-tap pre-smooth at
level 0), and `fused_iterate.update_flow` iterates the flow, on K1 for a
window that fits its tile and on K5a -> K5b otherwise.  Where
`fused_iterate.FUSE_POLYEXP` is on and K7's tile fits, a level skips K2
and iterates on K7 from the level images instead (`update_flow_fused_poly`,
the same flow to the bit).  Between levels X1 `resample` upsamples the
flow x2 with its scale in one launch; a seed is downsampled to the
coarsest level with INTER_AREA and its scale, X1 too, read in its
(B, H, W, 2) layout (plain: `ops/resize.py:resize_bilinear_f32`,
`resize_area_f32`, then the multiply).  The BGR entries
end with K4 `flow_to_bgr_planar`.  CUDA tensors go through the kernels,
CPU tensors through their plain versions; there is no shape gate.
"""

from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.kernels import fused_iterate, resample
from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize, k3_fits
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.params import (FarnebackPlan,
                                                            build_plan,
                                                            gaussian_kernel)
from optical_flow_tpu_torch.ops import colorize
from optical_flow_tpu_torch.ops.resize import (resize_area_f32,
                                               resize_bilinear_f32)
from optical_flow_tpu_torch.utils.config import FarnebackConfig
from optical_flow_tpu_torch.utils.device import device_of


def _level_images(frames: torch.Tensor, kern, out_w: int,
                  out_h: int) -> torch.Tensor:
    """A pyramid level from the full-resolution frames: K3 where it takes
    the level (`k3_fits`, by tap count and shapes alone), else K6 and the
    bilinear resize (X1), the JAX package's route for levels its fused level
    kernel does not take (`flow.py:229-231`).  Both compute
    `core.gaussian_blur_resize`."""
    _, h, w = frames.shape
    if k3_fits(len(kern), h, w, out_w):
        return gauss_resize(frames, kern, out_w, out_h)
    return resample.resize_bilinear(gaussian_blur(frames, kern), out_w, out_h)


def _plain_upsample(flow, w: int, h: int, scale: float) -> torch.Tensor:
    """X1's flow upsample in plain PyTorch: the bilinear resize, * scale."""
    return resize_bilinear_f32(flow, w, h) * scale


def _plain_area(seed, w: int, h: int, scale: float) -> torch.Tensor:
    """X1's seed downsample in plain PyTorch: INTER_AREA, * scale."""
    return resize_area_f32(seed, w, h) * scale


def _flow_pyramid(frames, plan: FarnebackPlan, plain: bool, chain: bool,
                  initial_flow: torch.Tensor | None = None, sp_kernels=None):
    """Coarse-to-fine schedule on an (N, H, W) uint8/f32 frame batch.

    chain=False: the batch holds the B first frames, then the B second
    frames (N = 2B).  chain=True: N consecutive frames, and the flow is
    that of the N-1 pairs (i, i+1); each frame is resized and expanded
    once, and R[:-1] / R[1:] (contiguous views) are the iterate's
    operands.  Returns (B, 2, H, W) f32 with B = N // 2 or N - 1.
    initial_flow: an optional (B, 2, H, W) f32 seed on the frames' device
    (OPTFLOW_USE_INITIAL_FLOW): the coarsest level starts from its
    INTER_AREA downsample scaled to the level, as cv2 does.  plain=True
    runs the kernels' plain versions on any device.

    sp_kernels: a `parallel.halo.HaloKernels`, with `frames` the row
    blocks (`halo.Blocks`) of one spatial group: every stage then runs
    per block with a halo exchange, the JAX package's sp route
    (`optical_flow_tpu/models/farneback/flow.py:184-195, 316-330`): level
    0 is `sp.gauss` then `sp.poly_exp` (no pre-smooth in the expansion),
    coarser levels `sp.gauss` and the bilinear resize, the iterate
    `sp.update_matrices_stats` -> `sp.blur_solve`.  No K1, K3 or K7 runs,
    and the flow comes back as row blocks."""
    cfg = plan.config
    # (x, w, h, scale) -> the bilinear / INTER_AREA resize of x, * scale
    area_fn = resample.resize_area
    if sp_kernels is not None:
        if initial_flow is not None:
            raise ValueError("the spatially sharded pyramid takes no seed")
        level_fn, poly_fn, iterate_fn = (sp_kernels.level_images,
                                         sp_kernels.poly_exp,
                                         sp_kernels.update_flow)
        upsample_fn = sp_kernels.resize_bilinear
    elif plain:
        level_fn, poly_fn, iterate_fn = (core.gaussian_blur_resize,
                                         core.poly_exp, core.update_flow)
        upsample_fn, area_fn = _plain_upsample, _plain_area
    else:
        level_fn, poly_fn, iterate_fn = (_level_images, poly_exp,
                                         fused_iterate.update_flow)
        upsample_fn = resample.resize_bilinear
    B = frames.shape[0] - 1 if chain else frames.shape[0] // 2
    # K7 takes the level images and derives R in the step (no K2 launch)
    poly_fused = (not plain and sp_kernels is None
                  and fused_iterate.use_fused_poly(cfg.winsize, cfg.poly_n))
    flow = None
    for lv in plan.levels:
        kern = gaussian_kernel(lv.smooth_ksize, lv.smooth_sigma)
        # every level is built from the original frame, never from another
        # level; level 0 is the frame itself, pre-smoothed by the expansion
        # (or, under sp, by the sharded Gaussian)
        if lv.k > 0:
            imgs, pre = level_fn(frames, kern, lv.width, lv.height), None
        elif sp_kernels is not None:
            imgs, pre = sp_kernels.gauss(frames, kern), None
        else:
            imgs, pre = frames, kern
        if not poly_fused:
            R = poly_fn(imgs, cfg.poly_n, cfg.poly_sigma, pre_taps=pre)
        if flow is None and initial_flow is not None:
            scale = float(np.float32(cfg.pyr_scale ** lv.k))
            flow = area_fn(initial_flow, lv.width, lv.height, scale)
        elif flow is None and sp_kernels is not None:
            flow = sp_kernels.zeros((B, 2, lv.height, lv.width), frames)
        elif flow is None:
            flow = torch.zeros((B, 2, lv.height, lv.width),
                               dtype=torch.float32, device=frames.device)
        else:
            flow = upsample_fn(flow, lv.width, lv.height,
                               float(np.float32(1.0 / cfg.pyr_scale)))
        if poly_fused:
            img0, img1 = (imgs[:-1], imgs[1:]) if chain else (imgs[:B], imgs[B:])
            flow = fused_iterate.update_flow_fused_poly(
                img0, img1, flow, cfg.winsize, cfg.iterations,
                cfg.gaussian_window, poly_n=cfg.poly_n,
                poly_sigma=cfg.poly_sigma, pre_taps=pre)
            continue
        R0, R1 = (R[:-1], R[1:]) if chain else (R[:B], R[B:])
        flow = iterate_fn(R0, R1, flow, cfg.winsize, cfg.iterations,
                          cfg.gaussian_window)
    return flow


def _on_device(frames: torch.Tensor, device) -> torch.Tensor:
    """Frames moved to `device`: uint8 stays uint8 (cast on the device by
    the kernels), anything else becomes f32."""
    frames = frames.to(device)
    return frames if frames.dtype == torch.uint8 else frames.float()


def _pair_batch(prev, nxt, device) -> torch.Tensor:
    """(B, H, W) prev and next frames -> the (2B, H, W) batch of both, on
    `device_of(prev, device)`: host arrays go to the current card."""
    device = device_of(prev, device)
    prev = torch.as_tensor(prev)
    nxt = torch.as_tensor(nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {tuple(prev.shape)} vs {tuple(nxt.shape)}")
    if prev.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(prev.shape)}")
    return _on_device(torch.cat([prev, nxt.to(prev.device)]), device)


def _chain_batch(frames, device) -> torch.Tensor:
    device = device_of(frames, device)
    frames = torch.as_tensor(frames)
    if frames.dim() != 3:
        raise ValueError(f"expected (N, H, W), got {tuple(frames.shape)}")
    if frames.shape[0] < 2:
        raise ValueError("chain needs at least 2 frames")
    return _on_device(frames, device)


def _seed(initial_flow, config: FarnebackConfig, B: int, h: int, w: int,
          device) -> torch.Tensor | None:
    """The (B, H, W, 2) seed as a (B, 2, H, W) f32 view on `device` (the
    seed's own layout, which X1 reads in place), when the flags ask for
    one (JAX `flow.py:532-536`); None otherwise."""
    if not config.use_initial_flow:
        return None
    if initial_flow is None:
        raise ValueError(
            "flags include OPTFLOW_USE_INITIAL_FLOW but no initial_flow "
            "was provided")
    seed = torch.as_tensor(initial_flow)
    if tuple(seed.shape) != (B, h, w, 2):
        raise ValueError(f"initial_flow has shape {tuple(seed.shape)}, "
                         f"expected {(B, h, w, 2)}")
    return seed.to(device, torch.float32).movedim(-1, 1)


def _flow(frames: torch.Tensor, config: FarnebackConfig, plain: bool,
          chain: bool, seed: torch.Tensor | None = None) -> torch.Tensor:
    """Only calc_flow_batched passes a seed: the chain and BGR entries
    start from zero flow under every flag, as in the JAX package."""
    _, h, w = frames.shape
    return _flow_pyramid(frames, build_plan(h, w, config), plain, chain, seed)


def flow_bgr(flow: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Planar flow (B, 2, H, W) -> planar BGR uint8 (B, 3, H, W): K4 on a
    CUDA tensor, its plain version on the CPU or with `plain`."""
    return (colorize.flow_to_bgr_planar(flow) if plain
            else flow_to_bgr_planar(flow))


def calc_flow(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
              initial_flow=None) -> torch.Tensor:
    """Dense Farnebäck flow for one frame pair, cv2's contract: (H, W)
    uint8 or float frames -> (H, W, 2) f32 flow, on the device of a
    tensor `prev` (a CPU tensor runs the plain versions), and on the
    current CUDA card for host arrays, which raise where there is none.
    initial_flow: an (H, W, 2) seed, used when config.flags has
    OPTFLOW_USE_INITIAL_FLOW."""
    device = device_of(prev)
    prev, nxt = torch.as_tensor(prev), torch.as_tensor(nxt)
    if prev.dim() != 2:
        raise ValueError(f"expected (H, W) grayscale, got {tuple(prev.shape)}")
    seed = None if initial_flow is None else torch.as_tensor(initial_flow)[None]
    return calc_flow_batched(prev[None], nxt[None], config, seed, device=device)[0]


def calc_flow_batched(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
                      initial_flow=None, *, device=None,
                      plain: bool = False) -> torch.Tensor:
    """Dense Farnebäck flow for a batch of frame pairs.

    prev, nxt: (B, H, W) uint8 or float frames, numpy arrays or tensors.
    initial_flow: a (B, H, W, 2) seed, numpy or tensor, required when
    config.flags has OPTFLOW_USE_INITIAL_FLOW and ignored otherwise.
    device: where to run; by default the device of a tensor `prev` (a CPU
    tensor runs the plain versions on the CPU) and the current CUDA card
    for host arrays, which raise where there is none.  uint8 frames are
    uploaded as uint8 and cast on the device.  Returns (B, H, W, 2)
    f32 flow (x-displacement, y-displacement), a view of the planar
    (B, 2, H, W) result.  plain=True runs the plain PyTorch versions of
    the kernels on the device as well: the reference that the kernel path
    is held to on the card.
    """
    both = _pair_batch(prev, nxt, device)
    B, h, w = both.shape[0] // 2, both.shape[1], both.shape[2]
    seed = _seed(initial_flow, config, B, h, w, both.device)
    return _flow(both, config, plain, chain=False, seed=seed).movedim(1, -1)


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
    return flow_bgr(_flow(both, config, plain, chain=False), plain)


def calc_flow_bgr_chain_batched(frames,
                                config: FarnebackConfig = FarnebackConfig(),
                                *, device=None, plain: bool = False) -> torch.Tensor:
    """Chained-pair flow + colorization: (N, H, W) frames -> planar BGR
    uint8 (N-1, 3, H, W) for the pairs (i, i+1)."""
    frames = _chain_batch(frames, device)
    return flow_bgr(_flow(frames, config, plain, chain=True), plain)
