"""The reader of the visualizer's dispatch counters: None where the
program keeps no such counters (as a program from before them does not)
or dispatched nothing, 0 where no dispatch was early, and the early
dispatches' share of all dispatches, in %, otherwise."""

import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.tests.test_portbench_tracing_readers import reader, reading

NAME = "visualizer.early_dispatch_pct"


@pytest.mark.parametrize("counters, want", [
    ({"frame_pairs": 40}, None),
    ({"frame_pairs": 40, "dispatches": 0, "early_dispatches": 0}, None),
    ({"frame_pairs": 40, "dispatches": 4}, None),
    ({"frame_pairs": 40, "dispatches": 4, "early_dispatches": 0}, 0.0),
    ({"frame_pairs": 40, "dispatches": 4, "early_dispatches": 3}, 75.0),
    ({"frame_pairs": 40, "dispatches": 5, "early_dispatches": 5}, 100.0),
])
def test_early_dispatch_share(counters, want):
    got = reader(NAME)(reading(40, {"flow": (0.01, 4)}, counters))
    assert got == (None if want is None else pytest.approx(want))


def test_it_is_a_per_layer_metric_of_the_long_shots():
    spec = harness.load_json(tiny.ROOT / "BENCHMARK.json")
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["better"], m["unit"]) == (
        "program_counter", "visualizer", "pairs_per_s", "higher", "%")
    assert m["workloads"] == ["visualizer_1080p.long_shots"]
