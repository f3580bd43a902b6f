from optical_flow_tpu_torch.io.video import VideoReader
from optical_flow_tpu_torch.io.jpeg import write_jpeg_bgr
from optical_flow_tpu_torch.io.sidecar import write_mag_to_csv, DoneSentinel

__all__ = ["VideoReader", "write_jpeg_bgr", "write_mag_to_csv", "DoneSentinel"]
