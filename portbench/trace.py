"""From a `torch.profiler` trace of a window to the intervals the per-layer
readers and the breakdown read: the device's operations by card, the host's
stage ranges, the union of busy time and the idle gaps.

Times are the profiler's own nanoseconds; the window is the host range the
harness records around it (`WINDOW`), on the same clock.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple

import torch

WINDOW = "portbench/window"
# host ranges of the program's stages (`PipelineMetrics`) and of the
# harness's calls into the program; the profiler mirrors them on the
# device's timeline, which is no work
STAGE_PREFIXES = ("extract/", "visualize/")
SPAN_PREFIX = "portbench/"
COPY_PREFIXES = ("Memcpy", "Memset")


class Op(NamedTuple):
    name: str
    device: int
    start: int
    end: int


class Trace(NamedTuple):
    window: tuple                # (start, end) ns
    device_ops: List[Op]         # kernels and copies inside the window
    stages: List[Op]             # the program's stage ranges (device -1)
    spans: List[Op]              # the harness's calls into the program
    host_ops: List[Op]           # the host's operator and CUDA calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self) -> List[Op]:
        return [o for o in self.device_ops if not o.name.startswith(COPY_PREFIXES)]

    def copies(self, kind: str = "") -> List[Op]:
        return [o for o in self.device_ops
                if o.name.startswith(COPY_PREFIXES) and kind in o.name]


def read(prof) -> Trace:
    """The window's device operations, stage ranges and host calls."""
    cuda = torch.autograd.DeviceType.CUDA
    window, dev_ops, stages, spans, host = None, [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith(STAGE_PREFIXES + (SPAN_PREFIX,)):
                dev_ops.append(Op(name, e.device_index(), start, end))
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith(STAGE_PREFIXES):
            stages.append(Op(name, -1, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append(Op(name, -1, start, end))
        elif name.startswith(("aten::", "cuda")):
            host.append(Op(name, -1, start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    dev_ops = [o for o in dev_ops if o.end > window[0] and o.start < window[1]]
    return Trace(window, dev_ops, stages, spans, host)


def _union(spans) -> List[tuple]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_by_device(trace: Trace, devices) -> Dict[int, float]:
    """Seconds of the window in which some operation ran, per card: the
    union of the intervals, so overlapping streams count once."""
    w0, w1 = trace.window
    busy = {}
    for d in devices:
        spans = [(max(o.start, w0), min(o.end, w1)) for o in trace.device_ops if o.device == d]
        busy[d] = sum(e - s for s, e in _union(spans)) * 1e-9
    return busy


def idle_gaps(trace: Trace, device: int) -> List[tuple]:
    """(start, end) ns of each stretch of the window with nothing on `device`."""
    w0, w1 = trace.window
    gaps, t = [], w0
    for s, e in _union((max(o.start, w0), min(o.end, w1))
                       for o in trace.device_ops if o.device == device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


class _Ranges:
    """Host ranges sorted by start, for the one that overlaps a gap most."""

    def __init__(self, ops: List[Op]):
        self.ops = sorted(ops, key=lambda o: o.start)
        self.starts = [o.start for o in self.ops]
        self.longest = max((o.end - o.start for o in self.ops), default=0)

    def busiest(self, lo: int, hi: int) -> tuple:
        best, best_ov = None, 0
        i = bisect.bisect_left(self.starts, lo - self.longest)
        while i < len(self.ops) and self.ops[i].start < hi:
            ov = min(self.ops[i].end, hi) - max(self.ops[i].start, lo)
            if ov > best_ov:
                best, best_ov = self.ops[i], ov
            i += 1
        return best, best_ov


def breakdown(trace: Trace, device: int, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of `device`, each named by what the host did over most of it: the
    program's stage, else a host call, else the harness's call into the
    program that holds it ("host" where none does)."""
    totals: Dict[str, float] = {}
    for o in trace.device_ops:
        totals[o.name] = totals.get(o.name, 0.0) + (o.end - o.start) * 1e-9
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    stages, host, spans = _Ranges(trace.stages), _Ranges(trace.host_ops), _Ranges(trace.spans)
    gaps = sorted(idle_gaps(trace, device), key=lambda g: g[0] - g[1])[:n]
    named = []
    for g0, g1 in gaps:
        name = "host"
        for ranges in (stages, host, spans):
            who, ov = ranges.busiest(g0, g1)
            if who is not None and (2 * ov >= g1 - g0 or ranges is spans):
                name = who.name
                break
        named.append([name, (g1 - g0) * 1e-9])
    return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": named}
