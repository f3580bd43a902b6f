"""Streamed decode with parallel segment readers and decode-ahead, the
upload of a decoded frame and the chunk size of a device dispatch; a port
of `optical_flow_tpu.pipeline.prefetch`.

The position list is split into contiguous segments, each decoded by its
own native VideoReader on its own thread, feeding bounded queues that the
consumer drains strictly in order: the reference's early-break contract
(the first failed read aborts everything after it) holds while decode
runs N wide, at most `depth` frames ahead of the consumer.  An optional
`transform` runs in the worker threads.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.io.video import VideoReader


def default_decode_workers(n_positions: int) -> int:
    """Segment count for parallel decode: up to 16, one per 8 positions,
    at most the host's cores.  `OFT_DECODE_WORKERS` overrides."""
    env = os.environ.get("OFT_DECODE_WORKERS")
    if env:
        return max(1, int(env))
    if n_positions < 8:
        return 1
    cap = min(16, max(1, n_positions // 8))
    return max(1, min(cap, os.cpu_count() or 1))


class DecodePrefetcher:
    """Background decode of a list of frame positions, yielded in order.

    Yields (pos, frame_or_transform(frame) | None); a failed read yields
    (pos, None) and stops (the reference's early-break contract, even when
    later segments decoded successfully).  depth: the frames decoded ahead
    of the consumer, over all segments (at least 2 a segment).
    """

    def __init__(self, v_path: str, positions: Iterable[float],
                 depth: int = 16,
                 transform: Optional[Callable[[np.ndarray], object]] = None,
                 workers: Optional[int] = None):
        self._positions = list(positions)
        n = len(self._positions)
        if workers is None:
            workers = default_decode_workers(n)
        workers = max(1, min(workers, max(n, 1)))
        self._stop = threading.Event()
        self._queues = []
        qdepth = max(2, depth // workers)
        bounds = [round(i * n / workers) for i in range(workers + 1)]
        for i in range(workers):
            seg = self._positions[bounds[i]:bounds[i + 1]]
            if not seg:
                continue
            q: "queue.Queue" = queue.Queue(maxsize=qdepth)
            self._queues.append(q)
            threading.Thread(target=self._run,
                             args=(v_path, seg, q, transform),
                             daemon=True).start()
        if not self._queues:           # empty position list
            q = queue.Queue(maxsize=1)
            q.put(None)
            self._queues.append(q)

    def _run(self, v_path: str, seg, q: "queue.Queue", transform) -> None:
        def put(item) -> bool:
            # bounded put that aborts when the consumer went away
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        vid = VideoReader(v_path)
        try:
            for pos in seg:
                if self._stop.is_set():
                    return
                ret, frame = vid.read_at(pos)
                if not ret:
                    put((pos, None))
                    return
                out = transform(frame) if transform is not None else frame
                if not put((pos, out)):
                    return
            put(None)                  # sentinel: segment done
        finally:
            vid.release()

    def __iter__(self) -> Iterator[Tuple[float, Optional[object]]]:
        try:
            for q in self._queues:
                while True:
                    item = q.get()
                    if item is None:
                        break          # segment exhausted, next one
                    yield item
                    if item[1] is None:
                        return         # failed read: drop the tail
        finally:
            self._stop.set()


def upload(frame, device: torch.device) -> torch.Tensor:
    """A decoded host frame to the device; to a card through pinned memory
    and without waiting for the kernels already queued."""
    t = torch.as_tensor(frame)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_REF_DEVICE_BYTES = 16 << 30    # the 16 GiB chip the pixel budget was sized on


def pair_chunk_for(h: int, w: int, budget_pixels: Optional[int] = None,
                   cap: int = 128, *, device=None) -> int:
    """Frame pairs per device dispatch, bounded by a device-memory pixel
    budget, the JAX package's rule: `budget_pixels`, by default 32 M
    pixels per 16 GiB of the device's memory,
    `torch.cuda.mem_get_info(device)[1]` for a CUDA device (other devices
    keep the 16 GiB budget), with a scale between 0.85 and 1.15 snapped
    to exactly 1.0; at most `cap` pairs.  At 1080p that is 16 pairs, and
    80 on an 80 GB card."""
    if budget_pixels is None:
        scale = 1.0
        if device is not None and torch.device(device).type == "cuda":
            scale = torch.cuda.mem_get_info(device)[1] / _REF_DEVICE_BYTES
        # a device reporting a little under (or over) the 16 GiB the budget
        # was sized on keeps that device's chunk sizes
        if 0.85 <= scale <= 1.15:
            scale = 1.0
        budget_pixels = int((32 << 20) * scale)
    return max(1, min(cap, budget_pixels // (h * w)))
