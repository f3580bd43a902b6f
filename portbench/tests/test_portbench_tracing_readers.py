"""The readers of the program's `upload` and `drain` stages and of its
pinned-pool counter: each reads None where the program has no such stage
or counter (as a program from before them has not), or where the window
ran no pair, and the stage's seconds or the counter's microseconds over
the pairs where it has."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests import tiny

# reader -> (what it reads: a stage or a counter, its name)
READERS = {
    "extractor.upload_us_per_window": ("stage", "upload"),
    "extractor.drain_us_per_window": ("stage", "drain"),
    "extractor.pinned_alloc_us_per_window": ("counter", "pinned_alloc_us"),
    "visualizer.upload_us_per_pair": ("stage", "upload"),
    "visualizer.pinned_alloc_us_per_pair": ("counter", "pinned_alloc_us"),
}


def reading(pairs, stages=(), counters=()):
    """What a reader sees of a window: `Reading`'s stages (name: (seconds,
    count)) and pairs, and the program's counters through its runner."""
    program = SimpleNamespace(metrics=SimpleNamespace(counters=dict(counters)))
    return SimpleNamespace(pairs=pairs, stages=dict(stages),
                           runner=SimpleNamespace(program=program))


def reader(name):
    return harness.load_module(tiny.BENCH / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_without_its_stage_or_counter(name):
    others = {"flow": (0.5, 3), "download": (0.25, 3)}
    assert reader(name)(reading(40, others, {"frame_pairs": 40})) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_microseconds_per_pair(name):
    kind, key = READERS[name]
    if kind == "stage":
        r = reading(40, {key: (0.002, 80)})
    else:
        r = reading(40, counters={key: 2000})
    assert reader(name)(r) == pytest.approx(50.0)
    empty = reading(0, {key: (0.0, 0)}, {key: 0})
    assert reader(name)(empty) is None


def test_every_reader_is_a_per_layer_metric_of_its_cell():
    spec = harness.load_json(tiny.ROOT / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name, (kind, _) in READERS.items():
        m = per_layer[name]
        assert m["source"] == ("program_span" if kind == "stage" else "program_counter")
        cell = "extractor_w129.corpus" if name.startswith("extractor") else \
            "visualizer_1080p.long_shots"
        assert m["workloads"] == [cell] and m["layer"] == name.split(".")[0]
