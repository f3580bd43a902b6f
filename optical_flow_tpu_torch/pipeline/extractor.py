"""The extractor's device step: summed flow magnitude per frame pair.

Port of `optical_flow_tpu.pipeline.extractor._magnitude_sums` (one-device
branch, `extractor.py:111-114`): `np.sum(mag)` of the reference's
`calculate_optical_flow` (`optical_flow.py:49-66`), batched on the
device.  Decode, windowing, CSV output and the CLI are not ported yet.
"""

from __future__ import annotations

import torch

from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
from optical_flow_tpu_torch.ops.polar import magnitude
from optical_flow_tpu_torch.utils.config import FarnebackConfig


def magnitude_sums(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
                   *, device=None, plain: bool = False) -> torch.Tensor:
    """(B, H, W) frame pairs -> (B,) f32 sums of the flow magnitude, left
    on the device.  The magnitude is cart_to_polar's; its angle, which
    the sum does not read, is not computed.  `device` and `plain` as in
    calc_flow_batched."""
    flow = calc_flow_batched(prev, nxt, config, device=device, plain=plain)
    return magnitude(flow[..., 0], flow[..., 1]).sum(dim=(-2, -1))
