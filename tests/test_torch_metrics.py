"""The port's stages and counters (`utils/metrics.py`) in its two device
loops: a stage enters no profiler range unless a profiler collects; under
one, each stage is a range `<loop>/<stage>` and no two of a loop nest; the
`upload`, `drain` and `flow` stages count the frames and chunks the loops
move; the pinned pool's counters are deltas of
`torch.cuda.host_memory_stats()` between samples, and absent on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from optical_flow_tpu_torch.pipeline import extractor, prefetch, visualizer
from optical_flow_tpu_torch.utils import metrics as metrics_mod
from optical_flow_tpu_torch.utils.config import ExtractorConfig
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics


def _sequence(n, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, (h, w), dtype=np.uint8)) for i in range(n)]


WINDOWS = list(enumerate([(0, 3), (2, 5), (4, 8), (6, 9), (9, 11)]))


def _extract(chunk, m):
    return extractor.extract_frames(_sequence(12), WINDOWS, ExtractorConfig(),
                                    chunk_size=chunk, device="cpu", metrics=m)


def _visualize(n, chunk, m):
    seq = [(0.5 + 3 * i, g) for i, g in _sequence(n)]
    return visualizer.visualize_frames(seq, lambda pos, bgr: None, chunk_size=chunk,
                                       device="cpu", metrics=m)


class _CountingRange:
    """Stands in for `torch.profiler.record_function`, counting entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        pass


@pytest.fixture
def counting_ranges(monkeypatch):
    _CountingRange.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    return _CountingRange


def test_stage_enters_no_range_without_a_profiler(counting_ranges):
    m = PipelineMetrics("extract")
    for _ in range(3):
        with m.stage("upload"):
            pass
    _extract(2, m)
    assert counting_ranges.entered == 0
    assert m.stages["upload"].count == 3 + 12 and m.stages["drain"].count == 3


def test_stage_enters_its_range_while_a_profiler_collects(counting_ranges):
    m = PipelineMetrics("extract")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with m.stage("upload"):
                pass
    assert counting_ranges.entered == 3 == m.stages["upload"].count
    with m.stage("upload"):
        pass
    assert counting_ranges.entered == 3 and m.stages["upload"].count == 4


def test_stage_times_and_counts_through_an_exception():
    m = PipelineMetrics("t")
    with pytest.raises(KeyError):
        with m.stage("a"):
            raise KeyError("x")
    assert m.stages["a"].count == 1 and m.stages["a"].seconds >= 0


def _ranges(prof, prefix):
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith(prefix))


@pytest.mark.parametrize("loop", ["extract", "visualize"])
def test_stages_are_disjoint_ranges_in_a_trace(loop):
    """Under the profiler each stage is a `<loop>/<stage>` range, as many
    as its count, and no range of a loop opens inside another."""
    m = PipelineMetrics(loop)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _extract(2, m) if loop == "extract" else _visualize(7, 3, m)
    got = _ranges(prof, f"{loop}/")
    names = {n for _, _, n in got}
    want = {"upload", "flow", "drain"} if loop == "extract" else {
        "upload", "flow", "download", "write"}
    assert names == {f"{loop}/{s}" for s in want}
    for s in want:
        assert sum(n == f"{loop}/{s}" for _, _, n in got) == m.stages[s].count
    for (_, end, a), (start, _, b) in zip(got, got[1:]):
        assert start >= end, f"{b} opens inside {a}"


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_extract_frames_counts_uploads_and_drains(chunk):
    m = PipelineMetrics("extract")
    res = _extract(chunk, m)
    assert len(res) == len(WINDOWS)
    assert m.stages["upload"].count == m.counters["frames_decoded"] == 12
    chunks = -(-len(WINDOWS) // chunk)
    assert m.stages["drain"].count == m.stages["flow"].count == chunks
    assert "pinned_allocs" not in m.counters and "pinned_alloc_us" not in m.counters


def test_extract_frames_counts_to_a_failed_read():
    """Frames after a failed read are not uploaded; a chunk that never
    filled is dispatched and drained once."""
    seq = _sequence(12)
    seq[7] = (7, None)
    m = PipelineMetrics("extract")
    res = extractor.extract_frames(seq, WINDOWS, ExtractorConfig(), chunk_size=5,
                                   device="cpu", metrics=m)
    assert sorted(res) == [0, 1]
    assert m.stages["upload"].count == m.counters["frames_decoded"] == 7
    assert m.stages["drain"].count == m.stages["flow"].count == 1


@pytest.mark.parametrize("n, chunk", [(2, 4), (7, 3), (10, 2)])
def test_visualize_frames_counts_uploads(n, chunk):
    m = PipelineMetrics("visualize")
    assert _visualize(n, chunk, m) == n - 1
    assert m.stages["upload"].count == n
    chunks = -(-(n - 1) // chunk)
    for s in ("flow", "download", "write"):
        assert m.stages[s].count == chunks
    assert "encode" not in m.stages
    assert "pinned_allocs" not in m.counters and "pinned_alloc_us" not in m.counters


def test_pinned_growth_is_the_delta_between_samples(monkeypatch):
    """On a card the counters add each sample's growth of the pool since
    the last (the first from the baseline); keys a torch lacks leave their
    counter out; the CPU reads nothing."""
    stats = iter([
        {"num_host_alloc": 4, "host_alloc_time.total": 100},
        {"num_host_alloc": 6, "host_alloc_time.total": 130},
        {"num_host_alloc": 9},
    ])
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: next(stats))
    card = torch.device("cuda", 0)
    m = PipelineMetrics("visualize")
    m.pinned_baseline(torch.device("cpu"))
    m.add_pinned_growth(torch.device("cpu"))
    assert m.counters == {}
    m.pinned_baseline(card)
    m.pinned_baseline(card)               # only an instance's first call reads
    m.add_pinned_growth(card)
    assert m.counters == {"pinned_allocs": 2, "pinned_alloc_us": 30}
    m.add_pinned_growth(card)
    assert m.counters == {"pinned_allocs": 5, "pinned_alloc_us": 30}
    fresh = PipelineMetrics("extract")
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {"num_host_alloc": 1})
    fresh.pinned_baseline(card)
    fresh.add_pinned_growth(card)
    assert fresh.counters == {"pinned_allocs": 0}
    assert set(metrics_mod.PINNED_STATS) == {"pinned_allocs", "pinned_alloc_us"}


def test_log_summary_names_the_pinned_counters(monkeypatch):
    lines = []
    monkeypatch.setattr(metrics_mod.logger, "info", lines.append)
    m = PipelineMetrics("visualize")
    with m.stage("upload"):
        pass
    m.log_summary()
    assert "upload=" in lines[0] and "pinned" not in lines[0]
    m.add("pinned_allocs", 3)
    m.add("pinned_alloc_us", 1250)
    m.log_summary()
    assert "pinned_allocs=3" in lines[1] and "pinned_alloc_us=1250" in lines[1]


def test_log_summary_names_the_frames_and_their_copies(monkeypatch):
    """The extractor's summary line gives `frames_decoded` beside
    `h2d_copies`, one a group of staged frames sent."""
    lines = []
    monkeypatch.setattr(metrics_mod.logger, "info", lines.append)
    monkeypatch.setattr(prefetch, "GROUP_BYTES", 5 * 24 * 32)
    m = PipelineMetrics("extract")
    _extract(5, m)
    m.log_summary()
    # groups of 5 frames: 0-4 and 5-9 sent as they fill, 10-11 by the flush
    assert "frames_decoded=12" in lines[0] and "h2d_copies=3" in lines[0]
