from optical_flow_tpu_torch.utils.config import FarnebackConfig, ExtractorConfig
from optical_flow_tpu_torch.utils.logging import get_logger

__all__ = ["FarnebackConfig", "ExtractorConfig", "get_logger"]
