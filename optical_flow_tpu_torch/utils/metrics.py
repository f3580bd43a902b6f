"""Stage timers and work counters, a port of `optical_flow_tpu.utils.metrics`.

Every stage is wrapped in `torch.profiler.record_function`, so it shows as
a named range in a `torch.profiler` trace, and per-run throughput
(frame pairs per second) is logged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict

import torch

from optical_flow_tpu_torch.utils.logging import get_logger

logger = get_logger("optical_flow_tpu_torch.metrics")


@dataclasses.dataclass
class StageStats:
    seconds: float = 0.0
    count: int = 0


class PipelineMetrics:
    """Accumulates per-stage wall time and work counters for one run."""

    def __init__(self, name: str):
        self.name = name
        self.stages: Dict[str, StageStats] = {}
        self.counters: Dict[str, int] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, stage: str):
        """Times a stage and names it in the profiler's trace."""
        st = self.stages.setdefault(stage, StageStats())
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{self.name}/{stage}"):
            yield
        st.seconds += time.perf_counter() - t0
        st.count += 1

    def add(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def log_summary(self) -> None:
        total = time.perf_counter() - self._t0
        pairs = self.counters.get("frame_pairs", 0)
        parts = [f"{self.name}: {total:.2f}s total"]
        if pairs:
            parts.append(f"{pairs} pairs ({pairs / total:.1f} pairs/s)")
        for k, v in sorted(self.stages.items()):
            parts.append(f"{k}={v.seconds:.2f}s/{v.count}x")
        logger.info("; ".join(parts))
