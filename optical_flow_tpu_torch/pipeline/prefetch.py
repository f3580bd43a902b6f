"""Streamed decode with parallel segment readers and decode-ahead, the
staging of decoded frames to the device and the sizes of a device
dispatch; a port of `optical_flow_tpu.pipeline.prefetch`.

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


# The most bytes of frames one host-to-device copy carries (one frame at
# least): 112 frames at 72x129; a 1080p frame (2,073,600 B) is a group of
# its own.
GROUP_BYTES = 1 << 20


class DeviceStager(dict):
    """A device loop's decoded host frames on their way to the device: a
    dict of key -> the frame's device tensor, None while it is staged.

    `put` copies a frame (numpy or a CPU tensor) into the next slot of a
    group buffer, a fresh block of torch's caching host allocator (pinned
    on a card).  A group goes to the device in one copy once one more
    frame would take it past GROUP_BYTES, or at `send`, which the caller
    calls before it reads a frame.  A frame's device tensor is a slot of
    its group's, which stays whole while any slot is held.  `metrics`
    gets `h2d_copies` (one a group sent) and, at `finish`, `staged_bytes`
    and on a card the pinned pool's growth since the stager was made."""

    def __init__(self, device: torch.device, metrics):
        super().__init__()
        self.device = device
        self.metrics = metrics
        self._group = self._slots = None   # the open group and its numpy view
        self._staged = []          # the keys in its slots
        self._bytes = 0            # of the groups sent
        metrics.pinned_baseline(device)

    def put(self, key, frame) -> None:
        # once a frame: the state in locals, the bytes counted a group
        slots, staged = self._slots, self._staged
        if slots is None:
            t = torch.from_numpy(np.asarray(frame))
            cap = max(1, GROUP_BYTES // max(t.nbytes, 1))
            self._group = torch.empty((cap, *t.shape), dtype=t.dtype,
                                      pin_memory=self.device.type == "cuda")
            slots = self._slots = self._group.numpy()
        np.copyto(slots[len(staged)], frame)
        staged.append(key)
        self[key] = None
        if len(staged) == len(slots):
            self.send()

    def send(self) -> None:
        """The open group, if any, to the device in one copy; its pinned
        block goes back to the pool with the last reference, here."""
        if self._group is None:
            return
        part = self._group[:len(self._staged)]
        self._bytes += part.nbytes
        sent = part.to(self.device, non_blocking=True)
        for key, f in zip(self._staged, sent.unbind()):
            if key in self:
                self[key] = f
        self._group = self._slots = None
        self._staged = []
        self.metrics.add("h2d_copies")

    def finish(self) -> None:
        if self._group is not None:        # staged, never read: not sent
            self._bytes += self._group[:len(self._staged)].nbytes
        self.metrics.add("staged_bytes", self._bytes)
        self.metrics.add_pinned_growth(self.device)


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


# Pixels of frame pairs (pairs x H x W) that the visualizer dispatches at
# once, per card of a mesh.  Each dispatch costs the loop's thread about
# 1.5 ms of host work; the last one's kernels and download are waited for
# when the shot ends.  16 pairs at 1080p, the fastest of 16, 24, 32, 48
# and 80 in the long shots on an H100 (PERF.md).
DISPATCH_PIXELS = 16 * 1080 * 1920


def dispatch_pairs(h: int, w: int, chunk_size: int, cards: int = 1) -> int:
    """Frame pairs of (h, w) per visualizer dispatch: the fewest that hold
    DISPATCH_PIXELS pixels per card, at most `chunk_size` (the memory
    cap).  16 at 1080p on one card."""
    return min(chunk_size, -(-DISPATCH_PIXELS * cards // (h * w)))
