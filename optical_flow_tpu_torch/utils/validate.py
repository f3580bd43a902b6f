"""Validation mode, the `--validate` path of both CLIs, and the NaN
check: a port of `optical_flow_tpu.utils.validate`.

  * `sampled_epe(prev, next, cfg)`: mean endpoint error of the port's flow
    against `cv2.calcOpticalFlowFarneback` on one grey frame pair; None
    (logged) when cv2 is not importable, so hosts without OpenCV still run.
  * `log_validation(...)`: logs the EPE and warns above the 0.5-px gate
    (BASELINE.json accuracy target).
  * `maybe_enable_debug_nans()`: with OFT_DEBUG_NANS=1, sets `DEBUG_NANS`,
    which makes the extractor's and the visualizer's device loops check
    each chunk's flow with `torch.isfinite(flow).all()` on the device and
    raise FloatingPointError for a chunk with a NaN or an infinity.  The
    flag is read on the host when the chunk's results come back, with the
    sync the loop makes anyway.  The JAX package switches on
    `jax.debug_nans` there; both CLIs call it first, as the JAX CLIs do.
    Off (the default), no check is queued and nothing is read.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from optical_flow_tpu_torch.utils.config import FarnebackConfig
from optical_flow_tpu_torch.utils.device import resolve_device
from optical_flow_tpu_torch.utils.logging import get_logger

logger = get_logger("optical_flow_tpu_torch.validate")

# north-star accuracy gate (BASELINE.json: mean EPE vs cv2 <= 0.5 px)
EPE_GATE = 0.5

# Whether the device loops check each chunk's flow; set by
# maybe_enable_debug_nans().
DEBUG_NANS = False


def maybe_enable_debug_nans() -> bool:
    """Turn on the per-chunk flow check when OFT_DEBUG_NANS=1.  Returns
    whether it is on."""
    global DEBUG_NANS
    if os.environ.get("OFT_DEBUG_NANS") == "1":
        DEBUG_NANS = True
        logger.info("flow NaN check enabled (OFT_DEBUG_NANS=1)")
    return DEBUG_NANS


def sampled_epe(prev_gray: np.ndarray, next_gray: np.ndarray,
                cfg: Optional[FarnebackConfig] = None,
                device=None) -> Optional[float]:
    """Mean endpoint error of the port's flow vs cv2 on ONE uint8 grey
    pair.  device: where the port's flow runs (by default the current
    card; "cpu" for the plain versions)."""
    device = resolve_device(device)
    try:
        import cv2
    except ImportError:
        logger.info("validate: cv2 not importable; skipping sampled EPE")
        return None
    cfg = cfg or FarnebackConfig()
    prev = np.asarray(prev_gray, dtype=np.uint8)
    nxt = np.asarray(next_gray, dtype=np.uint8)
    ref = cv2.calcOpticalFlowFarneback(
        prev, nxt, None, cfg.pyr_scale, cfg.levels, cfg.winsize,
        cfg.iterations, cfg.poly_n, cfg.poly_sigma, cfg.flags)
    from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
    ours = calc_flow_batched(prev[None], nxt[None], cfg, device=device)[0]
    ours = ours.cpu().numpy()
    return float(np.sqrt(((ours - ref) ** 2).sum(-1)).mean())


def log_validation(epe: Optional[float], context: str) -> None:
    if epe is None:
        return
    if epe > EPE_GATE:
        logger.warning(
            "validate[%s]: sampled mean EPE vs cv2 = %.4f px EXCEEDS the "
            "%.1f px gate", context, epe, EPE_GATE)
    else:
        logger.info("validate[%s]: sampled mean EPE vs cv2 = %.4f px "
                    "(gate %.1f px)", context, epe, EPE_GATE)
