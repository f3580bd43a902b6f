"""Shot-window flow visualizer, a port of `optical_flow_tpu.pipeline.visualizer`
(the reference's `visualize_optical_flow.py:9-63`).

Behavioral contract:
  * `start_frame = fps*start_ms/1000` stays FLOAT, `end_frame` and the step
    are truncated ints (`visualize_optical_flow.py:15-17`); seeks receive
    float indices and decode floor(pos);
  * loop `while ts < end_frame`, advancing by the step; the first failed
    read breaks (`:21-27`); a step of 0 frames raises ValueError; an
    unopenable video writes nothing and returns 0;
  * flow between consecutive *sampled* frames (`:62-63`), at full native
    resolution;
  * `flow_<ms>.jpeg` + `source_<ms>.jpeg` with `ms = int(ts/fps*1000)`,
    from the SECOND sampled timestamp on (`:29-31,57-60`); each source
    image is written as its frame arrives;
  * `validate=True` keeps the first grey pair and, after the shot, logs
    its mean EPE against cv2 and records it as the metrics counter
    `validate_mean_epe` (`utils/validate.py`).

Sampled frames stream through the decode-ahead threads, which also convert
them to gray; `visualize_frames` runs the chained pyramid and K4 on the
device, a chunk of pairs per dispatch, and keeps one chunk in flight while
it downloads the one before; JPEG encode runs on a host thread pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.io.jpeg import write_jpeg_bgr
from optical_flow_tpu_torch.io.video import VideoReader
from optical_flow_tpu_torch.models.farneback.flow import (
    calc_flow_chain_batched, flow_bgr)
from optical_flow_tpu_torch.ops.host import bgr2gray_host
from optical_flow_tpu_torch.pipeline.prefetch import (DecodePrefetcher,
                                                      pair_chunk_for, upload)
from optical_flow_tpu_torch.utils.config import (FarnebackConfig,
                                                 VisualizerConfig)
from optical_flow_tpu_torch.utils import validate
from optical_flow_tpu_torch.utils.device import resolve_device
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics


def _download(bgr: torch.Tensor, ready, stream) -> np.ndarray:
    """A chunk's BGR to host numpy.  On a card the copy runs on its own
    stream and waits only for its chunk's `ready` event, so the next
    chunk's kernels keep running meanwhile."""
    if stream is None:
        return bgr.numpy()
    host = torch.empty(bgr.shape, dtype=bgr.dtype, pin_memory=True)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host.copy_(bgr, non_blocking=True)
    stream.synchronize()
    return host.numpy()


def visualize_frames(frames: Iterable[Tuple[float, object]],
                     write: Callable[[float, np.ndarray], None],
                     config: FarnebackConfig = FarnebackConfig(), *,
                     chunk_size: int, device=None, plain: bool = False,
                     metrics: Optional[PipelineMetrics] = None) -> int:
    """The visualizer's device loop.

    frames: (pos, gray uint8 (H, W)) in order.  For every consecutive pair
    (i-1, i), calls write(pos_i, planar BGR uint8 (3, H, W) numpy) in
    order.  Pairs go to the device `chunk_size` at a time as one chain
    (`calc_flow_chain_batched`, then K4), each chunk restacking the previous
    chunk's last frame; a chunk is downloaded once the next one is
    dispatched.  device: where the flow runs, by default the current card
    (raises without one; "cpu" runs the plain versions).  `plain` as in
    calc_flow_batched.  Returns the number of pairs written."""
    device = resolve_device(device)
    metrics = metrics or PipelineMetrics("visualize")
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    stamps, gray, pend, inflight = [], [], [], []
    written = 0

    def drain_one():
        nonlocal written
        dpend, bgr, ready, finite = inflight.pop(0)
        with metrics.stage("download"):
            host = _download(bgr, ready, copy_stream)
        if finite is not None and not bool(finite):
            raise FloatingPointError(
                f"non-finite flow in the chunk from frame {dpend[0] - 1} "
                f"(position {stamps[dpend[0] - 1]}; OFT_DEBUG_NANS=1)")
        with metrics.stage("encode"):
            for j, i in enumerate(dpend):
                write(stamps[i], host[j])
                written += 1

    def flush(pend):
        with metrics.stage("flow"):
            chain = torch.stack([gray[pend[0] - 1]] + [gray[i] for i in pend])
            flow = calc_flow_chain_batched(chain, config, plain=plain).movedim(-1, 1)
            finite = torch.isfinite(flow).all() if validate.DEBUG_NANS else None
            bgr = flow_bgr(flow, plain)
            ready = None
            if copy_stream is not None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(device))
        metrics.add("frame_pairs", len(pend))
        for i in pend:
            gray[i - 1] = None     # pairs are consecutive: frame i-1 is done
        inflight.append((list(pend), bgr, ready, finite))
        if len(inflight) > 1:
            drain_one()

    for pos, g in frames:
        stamps.append(pos)
        i = len(gray)
        gray.append(upload(g, device))
        if i >= 1:
            pend.append(i)
            if len(pend) >= chunk_size:
                flush(pend)
                pend = []
    if pend:
        flush(pend)
    while inflight:
        drain_one()
    return written


def _write_planar(path: str, planar: np.ndarray, quality: int) -> None:
    # (3, H, W) -> HWC inside the pool worker, off the device loop
    write_jpeg_bgr(path, np.ascontiguousarray(planar.transpose(1, 2, 0)),
                   quality)


def visualize_shot(v_path: str, images_path: str, start_ms: int, end_ms: int,
                   config: Optional[VisualizerConfig] = None, *,
                   device=None) -> int:
    """Write flow/source JPEG pairs for one shot.  Returns #pairs written.
    device: as in visualize_frames (by default the current card)."""
    device = resolve_device(device)
    config = config or VisualizerConfig()
    os.makedirs(images_path, exist_ok=True)

    vid = VideoReader(v_path)
    fps = vid.fps
    h, w = vid.height, vid.width
    opened = vid.is_opened()
    vid.release()
    if not opened or fps <= 0:
        # the reference's while-loop is vacuous at fps=0: nothing written
        return 0
    start_frame = fps * start_ms / 1000          # float, like the reference
    end_frame = int(fps * end_ms / 1000)
    step = int(fps * config.step_size / 1000)
    if step <= 0:
        raise ValueError(
            f"step_size={config.step_size}ms is shorter than one frame at "
            f"fps={fps}")
    positions = []
    ts = start_frame
    while ts < end_frame:
        positions.append(ts)
        ts += step
    if len(positions) < 2:
        return 0

    metrics = PipelineMetrics("visualize")
    prefetch = DecodePrefetcher(v_path, positions,
                                transform=lambda f: (f, bgr2gray_host(f)))
    pool = ThreadPoolExecutor(max_workers=4)
    encodes = []
    validate_sample = []          # the first grey pair, host copies

    def path_of(kind: str, pos: float) -> str:
        return os.path.join(images_path, f"{kind}_{int(pos / fps * 1000)}.jpeg")

    def gray_frames():
        for i, (pos, item) in enumerate(prefetch):
            if item is None:
                return
            frame, gray = item
            if config.validate and i < 2:
                validate_sample.append(np.asarray(gray))
            if i >= 1:
                # the source image is written on arrival (bounded memory)
                encodes.append(pool.submit(write_jpeg_bgr, path_of("source", pos),
                                           frame, config.jpeg_quality))
            yield pos, gray

    def write_flow(pos: float, planar: np.ndarray) -> None:
        encodes.append(pool.submit(_write_planar, path_of("flow", pos), planar,
                                   config.jpeg_quality))

    try:
        with metrics.stage("stream"):
            written = visualize_frames(
                gray_frames(), write_flow, config.farneback,
                chunk_size=pair_chunk_for(h or 1080, w or 1920, device=device),
                device=device, metrics=metrics)
            for f in encodes:
                f.result()                  # surface encode errors
    finally:
        pool.shutdown()
    if len(validate_sample) == 2:
        epe = validate.sampled_epe(validate_sample[0], validate_sample[1],
                                   config.farneback, device=device)
        validate.log_validation(epe, f"visualize:{os.path.basename(v_path)}")
        if epe is not None:
            metrics.counters["validate_mean_epe"] = epe
    metrics.log_summary()
    return written
