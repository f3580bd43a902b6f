"""Synthetic inputs with a known flow and mp4 fixtures, for tests, the
self test and chip_smoke.py; nothing in the compute path imports this
package."""

from optical_flow_tpu_torch.oracle.synthetic import (
    smooth_texture_pair,
    motion_boundary_pair,
    quadratic_pair,
    vertical_jump_pair,
    write_synthetic_video,
)

__all__ = [
    "smooth_texture_pair",
    "motion_boundary_pair",
    "quadratic_pair",
    "vertical_jump_pair",
    "write_synthetic_video",
]
