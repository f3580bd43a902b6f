"""Visualizer CLI, arg-compatible with the reference
(`visualize_optical_flow.py:66-77`) and with
`optical_flow_tpu.cli.visualize_optical_flow`:

    python -m optical_flow_tpu_torch.cli.visualize_optical_flow \
        <video_path> <images_path> <shot_begin_ms> <shot_end_ms>

(As in the reference, the first positional is named video_dir but is a
video FILE path.)  It runs on the current CUDA card (`--device cuda`, the
default; it raises where there is none) or, with `--device cpu`, runs the
plain PyTorch versions on the CPU.  As for the JAX CLI, OFT_DEBUG_NANS=1
checks each chunk's flow for NaNs (`utils/validate.py`) and
OFT_COMPILE_CACHE says where the kernels are built and found
(`utils/compile_cache.py`).
"""

from __future__ import annotations

import argparse

from optical_flow_tpu_torch.pipeline.visualizer import visualize_shot
from optical_flow_tpu_torch.utils.config import VisualizerConfig
from optical_flow_tpu_torch.utils.validate import maybe_enable_debug_nans


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        epilog="VFR inputs raise a loud error (OFIO_ALLOW_VFR=1 forces "
               "cv2-4.2-style fps indexing).")
    parser.add_argument("video_dir",
                        help="the directory where the video-files are stored")
    parser.add_argument("images_path",
                        help="the directory where the images are saved")
    parser.add_argument("shot_begin", type=int,
                        help="the begin of a shot in milliseconds")
    parser.add_argument("shot_end", type=int,
                        help="the end of a shot in milliseconds")
    parser.add_argument("--validate", action="store_true",
                        help="compute one sampled frame pair with cv2 and log "
                             "mean EPE vs the 0.5-px gate")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the current card, the default) or cpu "
                             "(the plain PyTorch versions)")
    return parser


def main(argv=None) -> None:
    maybe_enable_debug_nans()
    args = build_parser().parse_args(argv)
    visualize_shot(args.video_dir, args.images_path, args.shot_begin,
                   args.shot_end,
                   config=VisualizerConfig(validate=args.validate),
                   device=args.device)


if __name__ == "__main__":
    main()
