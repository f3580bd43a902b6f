from optical_flow_tpu_torch.ops.color import bgr2gray_u8, hsv2bgr_u8
from optical_flow_tpu_torch.ops.polar import cart_to_polar, normalize_minmax_u8_value
from optical_flow_tpu_torch.ops.resize import (
    resize_bilinear_f32,
    resize_area_f32,
    resize_u8_cv,
    resize_frame_u8,
    aspect_preserving_size,
)
from optical_flow_tpu_torch.ops.colorize import flow_to_bgr_u8

__all__ = [
    "bgr2gray_u8",
    "hsv2bgr_u8",
    "cart_to_polar",
    "normalize_minmax_u8_value",
    "resize_bilinear_f32",
    "resize_area_f32",
    "resize_u8_cv",
    "resize_frame_u8",
    "aspect_preserving_size",
    "flow_to_bgr_u8",
]
