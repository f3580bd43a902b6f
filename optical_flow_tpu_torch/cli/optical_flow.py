"""Extractor CLI, flag-compatible with the reference (`optical_flow.py:171-185`)
and with `optical_flow_tpu.cli.optical_flow`:

    python -m optical_flow_tpu_torch.cli.optical_flow <features_root> [videoids...]
        [--frame_width 129] [--step_size 300] [--window_size 300]
        [--top_percentile 5] [--force_run False] [--device cuda|cpu]

Same positional and flag names, same defaults, the same string-typed
--force_run; `--device` (default `cuda`, the current card, which raises
where there is none; `cpu` runs the plain PyTorch versions) is the
port's.  As for the JAX CLI, OFT_DEBUG_NANS=1 checks each chunk's flow
for NaNs (`utils/validate.py`) and OFT_COMPILE_CACHE says where the
kernels are built and found (`utils/compile_cache.py`).  `--num_workers` and `--worker_index` shard the
corpus; without them, OFT_COORDINATOR_ADDRESS, OFT_NUM_PROCESSES and
OFT_PROCESS_ID do, as for the JAX CLI (`parallel/corpus.py`).  A progress bar shows where `tqdm` is
installed.
"""

from __future__ import annotations

import argparse

from optical_flow_tpu_torch.parallel.corpus import (maybe_init_distributed,
                                                    shard_videoids)
from optical_flow_tpu_torch.pipeline.extractor import run_corpus
from optical_flow_tpu_torch.utils.config import ExtractorConfig
from optical_flow_tpu_torch.utils.validate import maybe_enable_debug_nans


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        epilog="Variable-frame-rate inputs: fps-based frame indexing would "
               "silently select wrong frames on VFR streams, so they are "
               "skipped per-video with a logged warning (the run "
               "continues).  Set OFIO_ALLOW_VFR=1 to force cv2-4.2-style "
               "fps-based indexing instead.")
    parser.add_argument("features_root",
                        help="the directory where the images are to be stored")
    parser.add_argument("videoids", nargs="*",
                        help="List of video ids. If empty, entire corpus is "
                             "iterated.")
    parser.add_argument("--frame_width", type=int, default=129,
                        help="set the width at which to which the frames are "
                             "rescaled, default is 129")
    parser.add_argument("--step_size", type=int, default=300,
                        help="defines at which distances the optical flow is "
                             "calculated, in milliseconds, default is 300")
    parser.add_argument("--window_size", type=int, default=300,
                        help="defines the range in which images for optical "
                             "flow calculation are extracted, if window_size "
                             "is equal to step_size two frames are extracted,"
                             " default is 300")
    parser.add_argument("--top_percentile", type=int, default=5,
                        help="set the percentage of magnitudes that are used "
                             "to determine the max magnitude,")
    parser.add_argument("--force_run", default="False",
                        help="sets whether the script runs regardless of the "
                             "version of .done-files")
    parser.add_argument("--worker_index", type=int, default=0,
                        help="this worker's index for sharded corpus runs")
    parser.add_argument("--num_workers", type=int, default=1,
                        help="total workers sharding the corpus "
                             "(round-robin by videoid; .done files keep "
                             "reruns idempotent)")
    parser.add_argument("--robust", action="store_true",
                        help="skip videos that fail instead of aborting "
                             "the whole corpus run")
    parser.add_argument("--video_workers", type=int, default=1,
                        help="videos processed concurrently (threads) — "
                             "default 1 matches the reference's sequential "
                             "loop")
    parser.add_argument("--validate", action="store_true",
                        help="per video, compute one sampled frame pair "
                             "with cv2.calcOpticalFlowFarneback (when cv2 "
                             "is importable) and log the mean EPE vs the "
                             "0.5-px gate")
    parser.add_argument("--resume", action="store_true",
                        help="shot-granular intra-video checkpointing: a "
                             "killed run resumes from its <videoid>"
                             ".progress high-water mark instead of "
                             "redoing the whole video")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the current card, the default) or cpu "
                             "(the plain PyTorch versions)")
    return parser


def _progress_bar():
    """tqdm where it is installed, else None (no progress bar)."""
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm


def main(argv=None) -> None:
    maybe_enable_debug_nans()
    args = build_parser().parse_args(argv)
    config = ExtractorConfig(
        frame_width=args.frame_width,
        step_size=args.step_size,
        window_size=args.window_size,
        top_percentile=args.top_percentile,
        force_run=args.force_run,
        validate=args.validate,
        resume=args.resume,
    )
    videoids = args.videoids
    # multi-host: each process takes the shard of its OFT_PROCESS_ID
    # unless the worker grid was given on the command line
    pid, nproc = maybe_init_distributed()
    worker_index, num_workers = args.worker_index, args.num_workers
    if nproc > 1 and num_workers == 1:
        worker_index, num_workers = pid, nproc
    if num_workers > 1:
        videoids = shard_videoids(videoids, worker_index, num_workers)
    run_corpus(args.features_root, videoids, config, progress=_progress_bar(),
               robust=args.robust, video_workers=args.video_workers,
               device=args.device)


if __name__ == "__main__":
    main()
