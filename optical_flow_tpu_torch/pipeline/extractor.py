"""Corpus motion-magnitude extractor, a port of
`optical_flow_tpu.pipeline.extractor` (the reference's
`optical_flow.py:69-168`).

Behavioral contract, the JAX package's:
  * ms -> frame conversion truncates: `int(fps*ms/1000)`
    (`optical_flow.py:77-78`);
  * centered windows `(max(0, c-w//2), min(tot-1, c+w//2))` for
    `c in range(0, tot, step)` (`:80`);
  * the first failed frame read aborts all remaining windows (`:89-96`);
  * zero successful windows raises (`:101-102`);
  * per-position aggregation means all window magnitudes with
    `start <= pos < end` (`:107-112`), logging empty positions;
  * timestamps `int(pos/fps*1000)` of the first and last aggregated
    position (`:114-115`);
  * magnitudes scaled by the `top_percentile`-th percentile, clipped to
    [0, 1], x100, rounded to 2 decimals (`:120-125`; the default 5 is the
    5th, low, percentile, kept as it is);
  * `.done` versioning and the `force_run == 'True'` string comparison
    (`:149-168`), `--resume` (ShotProgress), `--robust`, the per-video
    skip of variable-frame-rate videos and `video_workers`.

Each needed frame is decoded once, in order, by the decode-ahead threads,
which also resize it to `frame_width` and convert it to gray
(`ops/host.py`); `extract_frames` stages it to the card
(`prefetch.DeviceStager`: pinned group buffers, one copy a group) and
sends the window pairs to the card `pair_chunk_for` at a time, two
chunks in flight, one host sync per chunk for its sums.  A chunk of a
shape seen before, small enough for its launches' host work to matter
(`graph_engaged`), replays a captured CUDA graph of its dispatch
(`ChunkGraphs`) instead of launching its kernels one by one.  On a host with
more than one visible card, where the caller names no device (None, or
"cuda" without an index), a chunk is split over every card as the JAX
package splits it over the local chips (`parallel/mesh.py:dp_mesh`,
`_sharded_magnitude_sums`); `OFT_DISABLE_MESH=1` keeps it on one card.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from optical_flow_tpu_torch.io.sidecar import (DoneSentinel, ShotProgress,
                                               write_mag_to_csv)
from optical_flow_tpu_torch.io.video import VFRStreamError, VideoReader
from optical_flow_tpu_torch.kernels import (add_launches, fused_iterate, hold_device_tables,
                                            launch_counts)
from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
from optical_flow_tpu_torch.ops import polar
from optical_flow_tpu_torch.ops.host import bgr2gray_host, resize_gray_host
from optical_flow_tpu_torch.ops.resize import aspect_preserving_size
from optical_flow_tpu_torch.parallel.mesh import Mesh, _shard_magnitude_sums, dp_mesh
from optical_flow_tpu_torch.pipeline.prefetch import (DecodePrefetcher, DeviceStager,
                                                      pair_chunk_for)
from optical_flow_tpu_torch.utils.config import (EXTRACTOR, ExtractorConfig,
                                                 FarnebackConfig)
from optical_flow_tpu_torch.utils import validate
from optical_flow_tpu_torch.utils.device import resolve_device
from optical_flow_tpu_torch.utils.logging import get_logger
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

logger = get_logger("optical_flow_tpu_torch.extractor")

# Counters of the most recent extract_video run (frames decoded, frame
# pairs, peak_live_frames: the device-residency bound in frames, each a
# slot of its group's device tensor (`prefetch.DeviceStager`), and
# validate_mean_epe with --validate).
LAST_RUN_COUNTERS: dict = {}

Window = Tuple[int, Tuple[int, int]]          # (window index, (start, end))


def _window_schedule(tot_frames: int, fps: float, step_ms: int, window_ms: int):
    step = int(fps * step_ms / 1000)
    win = int(fps * window_ms / 1000)
    if step <= 0:
        # the reference crashes with range(0, tot, 0); a clear error instead
        raise ValueError(
            f"step_size={step_ms}ms is shorter than one frame at fps={fps}")
    windows = [
        (max(0, c - int(win / 2.0)), min(tot_frames - 1, c + int(win / 2.0)))
        for c in range(0, tot_frames, step)
    ]
    return windows, step


def magnitude_sums(prev, nxt, config: FarnebackConfig = FarnebackConfig(),
                   *, device=None, plain: bool = False) -> torch.Tensor:
    """(B, H, W) frame pairs -> (B,) f32 sums of the flow magnitude, left
    on the device: `np.sum(mag)` of the reference's
    `calculate_optical_flow` (`optical_flow.py:49-66`), batched.  The
    magnitude is cart_to_polar's; its angle, which the sum does not read,
    is not computed.  Each pair's magnitudes are summed in f64 and
    rounded to f32 once: by X2 on a card, by `ops/polar.py:magnitude_sums`
    on the CPU and with `plain`.  `device` and `plain` as in
    calc_flow_batched."""
    return _flow_and_sums(prev, nxt, config, device=device, plain=plain)[1]


def _flow_and_sums(prev, nxt, config: FarnebackConfig, *, device, plain: bool):
    flow = calc_flow_batched(prev, nxt, config, device=device, plain=plain)
    if plain:
        return flow, polar.magnitude_sums(flow[..., 0], flow[..., 1])
    return flow, magnitude_sum(flow.movedim(-1, 1))


def _sharded_magnitude_sums(mesh: Mesh, prev_batch, next_batch,
                            config: ExtractorConfig, nan_check: bool = False):
    """The mesh branch of the JAX package's `_magnitude_sums`
    (`extractor.py:96-110`): the batch padded to a multiple of the mesh's
    devices by repeating the last pair, `sharded_extract_step`'s shards,
    and the first b pairs' sums, on the mesh's first device.  Each pair's
    sum depends on that pair alone (X2), so the sums are those of
    `_magnitude_sums` without a mesh to the bit.  (sums, finite) as
    `_magnitude_sums`."""
    prev_batch, next_batch = torch.as_tensor(prev_batch), torch.as_tensor(next_batch)
    n = mesh.devices.size
    b = prev_batch.shape[0]
    pad = -(-b // n) * n - b
    if pad:
        prev_batch = torch.cat([prev_batch, prev_batch[-1:].expand(pad, *prev_batch.shape[1:])])
        next_batch = torch.cat([next_batch, next_batch[-1:].expand(pad, *next_batch.shape[1:])])
    sums, finite = _shard_magnitude_sums(mesh, prev_batch, next_batch,
                                         config.farneback, nan_check)
    return sums[:b], finite


def _magnitude_sums(prev_batch, next_batch, config: ExtractorConfig, *, device,
                    plain: bool = False, nan_check: bool = False,
                    mesh: Optional[Mesh] = None):
    """The JAX package's `_magnitude_sums` (`extractor.py:83-114`):
    (sums, finite), sums a device tensor (B,), so that chunks pipeline
    without a host sync each, and finite, with nan_check, a device bool:
    whether every component of the chunk's flow is finite
    (`utils/validate.py:DEBUG_NANS`); None without.  With a mesh
    (`dp_mesh`), the sharded branch, on the mesh's first device."""
    if mesh is not None:
        return _sharded_magnitude_sums(mesh, prev_batch, next_batch, config,
                                       nan_check)
    flow, sums = _flow_and_sums(prev_batch, next_batch, config.farneback,
                                device=device, plain=plain)
    return sums, (torch.isfinite(flow).all() if nan_check else None)


# Pixels (pairs x H x W) of the chunk dispatches a process keeps captured,
# all shapes together; a chunk past what is left runs eagerly.  A graph's
# private pool on an H100 is 79 bytes a pixel at 1080p and up to 142 for a
# 36-pair 72x129 chunk, whose pool rounds up to whole segments (PERF.md):
# at most some 1.2 GB of pools.  The 16 shapes of a mix of 7-10 s clips
# at 72x129 and 97x129 took 5.5 M pixels of it (0.64 GB); all 24 pair
# counts of such clips at both heights take 8.0 M.
GRAPH_PIXELS = 8 << 20


def graph_engaged(device_type: str, b: int, h: int, w: int, *, plain: bool,
                  mesh: Optional[Mesh], nan_check: bool) -> bool:
    """Whether a chunk of b (h, w) pairs may replay a captured CUDA graph
    of its dispatch: the kernels on one card (not `plain`, no mesh, no
    NaN check, which reads the flow the graph keeps inside), and at most
    `GRAPH_PIXELS` pixels (a 36-pair 72x129 chunk: 0.7 ms to launch its
    11 kernels, 20 us to replay them, on an H100's host).  A 1080p clip's
    kernels take tens of ms, which hide their launches."""
    return (device_type == "cuda" and not plain and mesh is None and not nan_check
            and b * h * w <= GRAPH_PIXELS)


class ChunkGraphs:
    """Captured chunk dispatches by key, in front of the eager code.  A
    key's first sight runs eagerly; its second sight captures the
    dispatch (`capture(key)` gives a callable (prev, nxt) -> sums) and
    replays it, if its pixels fit in what is left of `pixels`, and later
    sights replay.  So a one-off shape, such as a video's last partial
    chunk, stays eager.  A graph is kept for the process: no shape is
    captured twice, and one past the budget stays eager.  A graph's
    static buffers are written and replayed under one lock, on the
    caller's current stream."""

    def __init__(self, capture: Callable, pixels: int = GRAPH_PIXELS):
        self._capture = capture
        self._left = pixels
        self._graphs = {}
        self._seen = set()
        self._lock = threading.Lock()

    def sums(self, key, pixels: int, prev, nxt):
        """The chunk's sums from the graph of `key`, a chunk of `pixels`,
        or None where this dispatch is to run eagerly."""
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                if key not in self._seen or pixels > self._left:
                    self._seen.add(key)
                    return None
                graph = self._graphs[key] = self._capture(key)
                self._left -= pixels
            return graph(prev, nxt)


class _ChunkGraph:
    """The one-device dispatch of a chunk (`_flow_and_sums` on the halves
    of a static (2B, H, W) batch), captured once, after one eager run on
    the batch that makes every device table its launches read (their
    caches may have evicted them since the key's first sight); the graph
    keeps those tables (`kernels.hold_device_tables`), and neither run
    counts in the launch counters (`kernels.launch_counts`).  A call
    stacks the chunk's frames into the batch, replays, adds the captured
    launches to the counters, and returns a copy of the sums made on the
    stream after the replay: the graph's own output is rewritten by the
    next replay while these sums are still in flight."""

    def __init__(self, key):
        device, b, h, w, dtype, config, _fused = key
        self.batch = torch.zeros((2 * b, h, w), dtype=dtype, device=device)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        _flow_and_sums(self.batch[:b], self.batch[b:], config, device=device, plain=False)
        warm = launch_counts()
        # thread-local: other threads (another video's loop) may use the
        # card while this one captures
        with hold_device_tables() as self.tables, torch.cuda.device(device), \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = _flow_and_sums(self.batch[:b], self.batch[b:], config,
                                      device=device, plain=False)[1]
        now = launch_counts()
        self.launches = {k: n - warm[k] for k, n in now.items() if n != warm[k]}
        add_launches({k: before[k] - n for k, n in now.items()})

    def __call__(self, prev, nxt) -> torch.Tensor:
        b = len(prev)
        torch.stack(prev, out=self.batch[:b])
        torch.stack(nxt, out=self.batch[b:])
        self.graph.replay()
        add_launches(self.launches)
        return self.out.clone()


_GRAPHS = ChunkGraphs(_ChunkGraph)


def _chunk_sums(prev: Sequence[torch.Tensor], nxt: Sequence[torch.Tensor],
                config: ExtractorConfig, *, device: torch.device, plain: bool,
                nan_check: bool, mesh: Optional[Mesh]):
    """A chunk's (sums, finite, replayed) from its pairs' (H, W) frames on
    the device: the captured graph of its shape (`ChunkGraphs`), keyed by
    (device, B, H, W, dtype, the Farnebäck config and `FUSE_POLYEXP`),
    where `graph_engaged` and the key was seen before, else the frames'
    stacks through `_magnitude_sums`.  Equal sums either way: the same
    kernels on the same inputs."""
    f = prev[0]
    if graph_engaged(device.type, len(prev), *f.shape, plain=plain, mesh=mesh,
                     nan_check=nan_check):
        key = (f.device, len(prev), *f.shape, f.dtype, config.farneback,
               fused_iterate.FUSE_POLYEXP)
        sums = _GRAPHS.sums(key, len(prev) * f.numel(), prev, nxt)
        if sums is not None:
            return sums, None, True
    sums, finite = _magnitude_sums(torch.stack(prev), torch.stack(nxt), config,
                                   device=device, plain=plain, nan_check=nan_check,
                                   mesh=mesh)
    return sums, finite, False


def extract_frames(frames: Iterable[Tuple[int, Optional[np.ndarray]]],
                   windows: Sequence[Window], config: ExtractorConfig, *,
                   chunk_size: int, device=None, plain: bool = False,
                   metrics: Optional[PipelineMetrics] = None,
                   on_result: Optional[Callable[[int, int, int, float], None]] = None,
                   validate_sample: Optional[list] = None) -> dict:
    """The extractor's device loop.

    frames: (pos, gray uint8 (h, w)) in ascending pos, each needed frame
    once; a None frame is a failed read and ends the stream.  windows:
    (index, (start, end)) in index order.  Returns {index: (start, end,
    magnitude sum)} of the windows whose two frames arrived before any
    failure.  Each frame is staged (`prefetch.DeviceStager`), its group
    sent at the latest when the chunk it feeds is flushed; a chunk of
    `chunk_size` pairs goes to the device as one batch, two chunks stay
    in flight, and a chunk's sums come back with one host sync, each then
    passed to on_result(index, start, end, sum); a chunk of a shape seen
    before replays its captured dispatch (`_chunk_sums`).  Frames below the
    earliest start still needed are dropped.  device: by default the
    current card, and every visible card where `dp_mesh` gives a mesh;
    "cpu" runs the plain versions.  `plain` as in calc_flow_batched (one
    device).  With `validate_sample` (a list), the first chunk's first
    pair is appended to it as host arrays.  Under OFT_DEBUG_NANS=1
    (`utils/validate.py`) each chunk's flow is checked on the device and
    read with its sums; a non-finite chunk raises FloatingPointError.
    `metrics` gets the stages `upload` (a frame's staging), `flow` (a
    chunk's dispatch, after the send of its last group) and `drain` (the
    wait for a chunk's sums and their hand-off), which do not nest, the
    counters `dispatches` (one a chunk) and `graph_replays` (those a
    captured graph served), and the stager's counters."""
    mesh = None if plain else dp_mesh(device)
    device = resolve_device(device)
    metrics = metrics or PipelineMetrics("extract")
    results = {}
    live = DeviceStager(device, metrics)     # pos -> frame on the device
    inflight = []
    win_iter = iter(windows)
    pending = next(win_iter, None)
    chunk: List[Window] = []

    def drain_one():
        chk, sums, finite = inflight.pop(0)
        with metrics.stage("drain"):
            if finite is not None and not bool(finite):
                raise FloatingPointError(
                    f"non-finite flow in the chunk from frame {chk[0][1][0]} "
                    "(OFT_DEBUG_NANS=1)")
            for (idx, (s, e)), v in zip(chk, sums.cpu().tolist()):
                results[idx] = (s, e, v)
                if on_result is not None:
                    on_result(idx, s, e, v)

    def flush(chunk):
        with metrics.stage("flow"):
            live.send()
            prev = [live[w[0]] for _, w in chunk]
            nxt = [live[w[1]] for _, w in chunk]
            sums, finite, replayed = _chunk_sums(prev, nxt, config, device=device,
                                                 plain=plain, nan_check=validate.DEBUG_NANS,
                                                 mesh=mesh)
        if validate_sample is not None and not validate_sample:
            validate_sample.append((prev[0].cpu().numpy(), nxt[0].cpu().numpy()))
        metrics.add("frame_pairs", len(chunk))
        metrics.add("dispatches")
        metrics.add("graph_replays", int(replayed))
        inflight.append((chunk, sums, finite))
        # two chunks in flight; older results are complete by now, so
        # draining them checkpoints without a stall
        while len(inflight) > 2:
            drain_one()

    evict_th = 0
    peak_live = 0
    for pos, frame in frames:
        if frame is None:
            break
        with metrics.stage("upload"):
            live.put(pos, frame)
        metrics.add("frames_decoded")
        peak_live = max(peak_live, len(live))
        while (pending is not None and pending[1][0] in live
               and pending[1][1] in live):
            chunk.append(pending)
            pending = next(win_iter, None)
            if len(chunk) >= chunk_size:
                flush(chunk)
                chunk = []
        # window starts are monotone in the center (`optical_flow.py:80`):
        # every frame below the earliest start still needed is dead
        th = chunk[0][1][0] if chunk else (
            pending[1][0] if pending is not None else pos + 1)
        if th > evict_th:
            for k in [k for k in live if k < th]:
                del live[k]
            evict_th = th
    # windows not fully decoded before a failure are dropped, as the
    # reference's early break drops them
    if chunk:
        flush(chunk)
    while inflight:
        drain_one()
    metrics.counters["peak_live_frames"] = peak_live
    live.finish()
    return results


def extract_video(v_path: str, config: ExtractorConfig,
                  progress_ckpt: ShotProgress | None = None, *,
                  device=None) -> Tuple[List[float], List[int]]:
    """Per-video pipeline: ([aggregated mags], [start_ms, end_ms]), as
    `get_optical_flow` (`optical_flow.py:69-117`).

    progress_ckpt (optional, --resume): windows already recorded in the
    checkpoint are not decoded or computed again; newly completed chunks
    are appended to it as their results land.  Results are aggregated in
    window-index order, so a resumed run's CSV is byte-identical to an
    uninterrupted one.  device: as in extract_frames (raises without a
    card unless it is "cpu")."""
    card = resolve_device(device)
    metrics = PipelineMetrics("extract")
    vid = VideoReader(v_path)
    if not vid.is_opened():
        raise IOError(f"Unable to read from video: '{v_path}'")

    tot_frames = vid.frame_count
    fps = vid.fps
    windows, step = _window_schedule(tot_frames, fps, config.step_size,
                                     config.window_size)
    completed = progress_ckpt.load() if progress_ckpt is not None else {}
    mags_by_idx = {i: t for i, t in completed.items() if i < len(windows)
                   and (t[0], t[1]) == windows[i]}
    todo = [(i, w) for i, w in enumerate(windows) if i not in mags_by_idx]
    # the chunk follows the FLOW resolution (frames are resized to
    # frame_width before the flow), not the source's
    if config.frame_width:
        fw, fh = aspect_preserving_size(vid.height, vid.width,
                                        config.frame_width)
    else:
        fw, fh = vid.width, vid.height
    vid.release()

    # each needed frame decoded once, ascending, resized and converted to
    # gray in the decode threads; the stream stops at the first failure
    needed = sorted({f for _, w in todo for f in w})
    if config.frame_width:
        def transform(frame, _w=config.frame_width):
            return resize_gray_host(frame, _w)
    else:
        transform = bgr2gray_host
    prefetch = DecodePrefetcher(v_path, needed, transform=transform)
    validate_sample = [] if config.validate else None
    try:
        with metrics.stage("stream"):
            mags_by_idx.update(extract_frames(
                prefetch, todo, config,
                chunk_size=pair_chunk_for(max(fh, 1), max(fw, 1), device=card),
                device=device, metrics=metrics,
                on_result=None if progress_ckpt is None else progress_ckpt.record,
                validate_sample=validate_sample))
    finally:
        if progress_ckpt is not None:
            progress_ckpt.close()   # flushed records survive a crash

    aggregated, timestamps = aggregate(mags_by_idx, tot_frames, fps, step)
    if validate_sample:
        epe = validate.sampled_epe(*validate_sample[0], config.farneback,
                                   device=card)
        validate.log_validation(epe, f"extract:{os.path.basename(v_path)}")
        if epe is not None:
            metrics.counters["validate_mean_epe"] = epe
    LAST_RUN_COUNTERS.clear()
    LAST_RUN_COUNTERS.update(metrics.counters)
    metrics.log_summary()
    return aggregated, timestamps


def aggregate(mags_by_idx: dict, tot_frames: int, fps: float,
              step: int) -> Tuple[List[float], List[int]]:
    """{window index: (start, end, magnitude sum)} -> ([the mean of the
    windows covering each sampled position], [start_ms, end_ms])
    (`optical_flow.py:101-115`), windows taken in index order, so that a
    resumed run sums in the order of a fresh one; raises when no window
    succeeded."""
    mags = [mags_by_idx[i] for i in sorted(mags_by_idx)]
    if not mags:
        raise Exception(
            "Unable to extract the optical flow, no frames where found.")
    agg: List[Tuple[int, float]] = []
    for pos in range(0, tot_frames, step):
        vals = [m[2] for m in mags if pos >= m[0] and pos < m[1]]
        if vals:
            agg.append((pos, float(np.mean(vals))))
        else:
            logger.info("WARN: no entry for pos={pos}".format(pos=pos))
    start_ms = int(agg[0][0] / fps * 1000)
    end_ms = int(agg[-1][0] / fps * 1000)
    return [a[1] for a in agg], [start_ms, end_ms]


def scale_magnitudes(mag: Sequence[float], top_percentile: int):
    """`scale_magnitudes` (`optical_flow.py:120-125`), numerics kept."""
    mag = np.asarray(mag)
    scaled = mag / np.percentile(mag, top_percentile)
    scaled = np.clip(scaled, a_min=0, a_max=1) * 100.0
    return list(np.round(scaled, decimals=2))


def _process_one(features_root: str, videoid: str, config: ExtractorConfig,
                 device) -> bool:
    """One video of the corpus loop: paths, .done gate, extract, CSV.
    Returns True if work ran (or was skipped cleanly); raises on failure."""
    features_dir = os.path.join(features_root, videoid, EXTRACTOR)
    v_path = os.path.join(features_root, videoid, "media", videoid + ".mp4")
    if not os.path.isdir(features_dir):
        os.makedirs(features_dir)
    f_path_csv = os.path.join(features_dir, f"{videoid}.csv")
    sentinel = DoneSentinel(features_dir, config.done_version)

    if not sentinel.is_done() or config.force_run == "True":
        ckpt = None
        if config.resume:
            ckpt = ShotProgress(
                os.path.join(features_dir, f"{videoid}.progress"),
                config.done_version)
        aggregated, timestamps = extract_video(v_path, config,
                                               progress_ckpt=ckpt, device=device)
        scaled = scale_magnitudes(aggregated, config.top_percentile)
        write_mag_to_csv(f_path_csv, scaled, timestamps)
        sentinel.mark_done()
        if ckpt is not None:
            ckpt.discard()      # .done supersedes the partial checkpoint
    else:
        logger.info("optical flow was already done")
    return True


def run_corpus(features_root: str, videoids: Sequence[str],
               config: ExtractorConfig, progress=None, robust: bool = False,
               video_workers: int = 1, *, device=None) -> list:
    """Corpus loop (`optical_flow.py:135-168`): paths, .done gating, CSV.
    Returns the list of videoids that failed.

    robust=True turns per-video failures into logged skips; by default
    the first failure raises, as in the reference.  A variable-frame-rate
    video (VFRStreamError) is always a logged skip, robust or not: the
    reference completes such a corpus with fps-based indexing, which
    would select wrong frames here (OFIO_ALLOW_VFR=1 forces it).
    video_workers > 1 overlaps whole videos in threads; outputs and
    `.done` are per video and unaffected.  device: where every video
    runs, as in extract_frames (raises without a card, before any video,
    unless it is "cpu")."""
    resolve_device(device)
    logger.info("Computing optical flow for {0} videos".format(len(videoids)))
    failures = []
    if video_workers <= 1:
        iterator = progress(videoids) if progress else videoids
        for videoid in iterator:
            try:
                _process_one(features_root, videoid, config, device)
            except Exception as e:
                if not robust and not isinstance(e, VFRStreamError):
                    raise
                failures.append(videoid)
                logger.warning("skipping %s after failure: %s: %s",
                               videoid, type(e).__name__, e)
        return failures

    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(max_workers=video_workers) as pool:
        futs = {pool.submit(_process_one, features_root, v, config, device): v
                for v in videoids}
        done_iter = cf.as_completed(futs)
        if progress:
            done_iter = progress(done_iter, total=len(futs))
        first_error = None
        for fut in done_iter:
            videoid = futs[fut]
            try:
                fut.result()
            except Exception as e:
                if robust or isinstance(e, VFRStreamError):
                    failures.append(videoid)
                    logger.warning("skipping %s after failure: %s: %s",
                                   videoid, type(e).__name__, e)
                elif first_error is None:
                    first_error = e
                    # fail fast like the sequential loop: drop queued videos
                    # (running ones finish; their outputs stay valid)
                    pool.shutdown(wait=False, cancel_futures=True)
                    break
        if first_error is not None:
            raise first_error
    return failures
