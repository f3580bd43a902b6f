from optical_flow_tpu_torch.pipeline.extractor import (
    extract_video,
    scale_magnitudes,
    run_corpus,
)
from optical_flow_tpu_torch.pipeline.visualizer import visualize_shot

__all__ = ["extract_video", "scale_magnitudes", "run_corpus", "visualize_shot"]
