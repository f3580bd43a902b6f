"""Stage timers and work counters, a port of `optical_flow_tpu.utils.metrics`.

A stage keeps its wall time and count.  While a `torch.profiler` collects,
it is also a named range (`<name>/<stage>`) in the trace, on the
profiler's clock; otherwise it costs two clock reads.  Per-run throughput
(frame pairs per second) is logged, with the growth of CUDA's pinned host
pool where a loop samples it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from optical_flow_tpu_torch.utils.logging import get_logger

logger = get_logger("optical_flow_tpu_torch.metrics")

# counter -> key of `torch.cuda.host_memory_stats()`: blocks the caching
# host allocator created to grow its pool, and microseconds spent doing so
PINNED_STATS = {"pinned_allocs": "num_host_alloc",
                "pinned_alloc_us": "host_alloc_time.total"}


_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


@dataclasses.dataclass(slots=True)
class StageStats:
    """A stage's wall time and count; entered, it times one pass."""

    seconds: float = 0.0
    count: int = 0
    range_name: str = dataclasses.field(default="", repr=False, compare=False)
    _t0: float = dataclasses.field(default=0.0, init=False, repr=False, compare=False)

    def __enter__(self):
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.seconds += _clock() - self._t0
        self.count += 1


class _Ranged:
    """A stage entered while a profiler collects: its range around its timer."""

    __slots__ = ("_st", "_rf")

    def __init__(self, st: StageStats):
        self._st = st
        self._rf = torch.profiler.record_function(st.range_name)

    def __enter__(self):
        self._rf.__enter__()
        return self._st.__enter__()

    def __exit__(self, *exc):
        self._st.__exit__(*exc)
        self._rf.__exit__(*exc)


class PipelineMetrics:
    """Accumulates per-stage wall time and work counters for one run."""

    def __init__(self, name: str):
        self.name = name
        self.stages: Dict[str, StageStats] = {}
        self.counters: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self._pinned: Optional[dict] = None   # host_memory_stats at the last sample

    def stage(self, stage: str):
        """`with metrics.stage(name):` times a stage and, while a profiler
        collects, names it in the trace.  Stages of one loop do not nest,
        nor does a stage in itself."""
        st = self.stages.get(stage)
        if st is None:
            st = self.stages[stage] = StageStats(range_name=f"{self.name}/{stage}")
        return _Ranged(st) if _profiling() else st

    def add(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def pinned_baseline(self, device: torch.device) -> None:
        """On a card, the first call of an instance reads the pinned pool's
        statistics that `add_pinned_growth` counts from."""
        if device.type == "cuda" and self._pinned is None:
            self._pinned = torch.cuda.host_memory_stats()

    def add_pinned_growth(self, device: torch.device) -> None:
        """On a card, adds the pinned pool's growth since the last sample
        to the counters `pinned_allocs` and `pinned_alloc_us`; a torch
        whose statistics lack a key leaves its counter out."""
        if device.type != "cuda":
            return
        now = torch.cuda.host_memory_stats()
        last = self._pinned or {}
        for counter, key in PINNED_STATS.items():
            if now.get(key) is not None:
                self.add(counter, now[key] - last.get(key, 0))
        self._pinned = now

    def log_summary(self) -> None:
        total = time.perf_counter() - self._t0
        pairs = self.counters.get("frame_pairs", 0)
        parts = [f"{self.name}: {total:.2f}s total"]
        if pairs:
            parts.append(f"{pairs} pairs ({pairs / total:.1f} pairs/s)")
        for k, v in sorted(self.stages.items()):
            parts.append(f"{k}={v.seconds:.2f}s/{v.count}x")
        for k in ("frames_decoded", "h2d_copies", "staged_bytes", "dispatches",
                  "graph_replays", "early_dispatches", *PINNED_STATS):
            if k in self.counters:
                parts.append(f"{k}={self.counters[k]}")
        upload = self.stages.get("upload")
        if self.counters.get("staged_bytes") and upload and upload.seconds > 0:
            rate = self.counters["staged_bytes"] / upload.seconds / 1e9
            parts.append(f"upload_gb_per_s={rate:.3f}")
        logger.info("; ".join(parts))
