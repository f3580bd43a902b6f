"""Synthetic inputs with a known flow, for tests and chip_smoke.py; nothing
in the compute path imports this package."""

from optical_flow_tpu_torch.oracle.synthetic import (
    smooth_texture_pair,
    motion_boundary_pair,
)

__all__ = ["smooth_texture_pair", "motion_boundary_pair"]
