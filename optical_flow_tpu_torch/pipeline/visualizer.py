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
them to gray; `visualize_frames` stages them to the device
(`prefetch.DeviceStager`), runs the chained pyramid and K4 there, a chunk
of pairs per dispatch, and keeps one chunk in flight while it downloads
the one before; JPEG encode runs on a host thread pool.  A chunk is
dispatched at `prefetch.dispatch_pairs` pairs, so the card runs and
downloads a long shot's first chunks while the host still uploads the
rest.  On a host with several visible cards
(`parallel/mesh.py:dp_mesh`) a chunk is split into overlapping
sub-chains, one a card (`parallel/mesh.py:chain_shards`), as the JAX
visualizer splits it over the local chips.
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
from optical_flow_tpu_torch.parallel.mesh import _bgr_chain_shards, chain_shards, dp_mesh
from optical_flow_tpu_torch.pipeline.prefetch import (DecodePrefetcher, DeviceStager,
                                                      dispatch_pairs, pair_chunk_for)
from optical_flow_tpu_torch.utils.config import (FarnebackConfig,
                                                 VisualizerConfig)
from optical_flow_tpu_torch.utils import validate
from optical_flow_tpu_torch.utils.device import resolve_device
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

def _start_download(parts, streams: dict):
    """Starts a chunk's BGR, [(shard's BGR, its `ready` event)] in pair
    order, on its way to one host tensor: (the host tensor, the events to
    wait for before reading it).  On a card each shard's copy is enqueued
    on its card's copy stream (`streams`) into pinned memory behind that
    shard's `ready` event, so it runs once the chunk's kernels end, beside
    the next chunk's uploads and kernels; the shards' BGR must stay alive
    until the events have passed."""
    if parts[0][1] is None:
        return (parts[0][0] if len(parts) == 1
                else torch.cat([bgr for bgr, _ in parts])), []
    n = sum(bgr.shape[0] for bgr, _ in parts)
    host = torch.empty((n,) + tuple(parts[0][0].shape[1:]), dtype=torch.uint8,
                       pin_memory=True)
    off = 0
    for bgr, ready in parts:
        stream = streams[bgr.device]
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            host[off:off + bgr.shape[0]].copy_(bgr, non_blocking=True)
        off += bgr.shape[0]
    # an event a stream, not the stream itself: the next chunk's copies,
    # queued behind its kernels, follow on the same streams
    copied = []
    for stream in {streams[bgr.device] for bgr, _ in parts}:
        copied.append(torch.cuda.Event())
        copied[-1].record(stream)
    return host, copied


def visualize_frames(frames: Iterable[Tuple[float, object]],
                     write: Callable[[float, np.ndarray], None],
                     config: FarnebackConfig = FarnebackConfig(), *,
                     chunk_size: int, device=None, plain: bool = False,
                     metrics: Optional[PipelineMetrics] = None) -> int:
    """The visualizer's device loop.

    frames: (pos, gray uint8 (H, W)) in order.  For every consecutive pair
    (i-1, i), calls write(pos_i, planar BGR uint8 (3, H, W) numpy) in
    order.  Pending pairs go to the device as one chain
    (`calc_flow_chain_batched`, then K4) `dispatch_pairs` at a time, and
    at the end of the frames; each chunk restacks the
    previous chunk's last frame.  K4 normalises each image on its own, so
    the images do not depend on where the chain is cut.  A chunk's copy to
    the host is enqueued with its kernels, on a copy stream, and the chunk
    is written once the next one is dispatched.  device: where the flow
    runs, by default the current card, and every visible card where
    `dp_mesh` gives a mesh (each takes one sub-chain of a chunk,
    `chain_shards`); raises without a card; "cpu" runs the plain
    versions.  `plain` as in calc_flow_batched (one device).  `metrics`
    gets the stages `upload` (a frame's staging), `flow` (a chunk's
    dispatch, after the send of its last group, and the enqueue of its
    copy), `download` (the wait for a chunk's BGR on the host) and
    `write` (the calls of `write`), which do not nest, the counters
    `dispatches` and `early_dispatches` (those smaller than `chunk_size`,
    before the end of the frames) and the stager's.  Returns the number
    of pairs written."""
    mesh = None if plain else dp_mesh(device)
    device = resolve_device(device)
    cards = 1 if mesh is None else mesh.devices.size
    metrics = metrics or PipelineMetrics("visualize")
    streams = {}              # a copy stream per card that holds a shard
    gray = DeviceStager(device, metrics)     # frame index -> frame on the device
    stamps, pend, inflight = [], [], []
    written = 0

    def drain_one():
        nonlocal written
        # the chunk's BGR on the card (its second item) lives until here
        dpend, _, host, copied, finite = inflight.pop(0)
        with metrics.stage("download"):
            for event in copied:
                event.synchronize()
            host = host.numpy()
        if finite is not None and not all(bool(f) for f in finite):
            raise FloatingPointError(
                f"non-finite flow in the chunk from frame {dpend[0] - 1} "
                f"(position {stamps[dpend[0] - 1]}; OFT_DEBUG_NANS=1)")
        with metrics.stage("write"):
            for j, i in enumerate(dpend):
                write(stamps[i], host[j])
                written += 1

    def flush(pend, early=False):
        with metrics.stage("flow"):
            gray.send()
            chain = torch.stack([gray[pend[0] - 1]] + [gray[i] for i in pend])
            if mesh is not None:
                shards = _bgr_chain_shards(
                    mesh, chain_shards(chain, mesh.shape["data"]), config,
                    nan_check=validate.DEBUG_NANS)
            else:
                flow = calc_flow_chain_batched(chain, config, plain=plain).movedim(-1, 1)
                shards = [(flow_bgr(flow, plain),
                           torch.isfinite(flow).all() if validate.DEBUG_NANS else None)]
            parts = []
            for bgr, _ in shards:
                ready = None
                if bgr.is_cuda:
                    if bgr.device not in streams:
                        streams[bgr.device] = torch.cuda.Stream(bgr.device)
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(bgr.device))
                parts.append((bgr, ready))
            host, copied = _start_download(parts, streams)
        metrics.add("frame_pairs", len(pend))
        metrics.add("dispatches")
        metrics.add("early_dispatches", int(early))
        for i in pend:
            del gray[i - 1]        # pairs are consecutive: frame i-1 is done
        finite = None if not validate.DEBUG_NANS else [f for _, f in shards]
        inflight.append((list(pend), parts, host, copied, finite))
        if len(inflight) > 1:
            drain_one()

    for i, (pos, g) in enumerate(frames):
        stamps.append(pos)
        with metrics.stage("upload"):
            gray.put(i, g)
        if i == 0:
            per = dispatch_pairs(*g.shape, chunk_size, cards)
            continue
        pend.append(i)
        if len(pend) >= per:
            flush(pend, early=per < chunk_size)
            pend = []
    if pend:
        flush(pend)
    while inflight:
        drain_one()
    gray.finish()
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
    card = resolve_device(device)
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
                chunk_size=pair_chunk_for(h or 1080, w or 1920, device=card),
                device=device, metrics=metrics)
            for f in encodes:
                f.result()                  # surface encode errors
    finally:
        pool.shutdown()
    if len(validate_sample) == 2:
        epe = validate.sampled_epe(validate_sample[0], validate_sample[1],
                                   config.farneback, device=card)
        validate.log_validation(epe, f"visualize:{os.path.basename(v_path)}")
        if epe is not None:
            metrics.counters["validate_mean_epe"] = epe
    metrics.log_summary()
    return written
