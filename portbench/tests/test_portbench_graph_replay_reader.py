"""The reader of the extractor's graph counters: None where the program
keeps no such counters (as a program from before them does not) or
dispatched nothing, and the replayed dispatches' share of all
dispatches, in %, otherwise."""

import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.tests.test_portbench_tracing_readers import reader, reading

NAME = "extractor.graph_replay_pct"


@pytest.mark.parametrize("counters, want", [
    ({"frame_pairs": 360}, None),
    ({"frame_pairs": 360, "dispatches": 0, "graph_replays": 0}, None),
    ({"frame_pairs": 360, "dispatches": 10}, None),
    ({"frame_pairs": 360, "dispatches": 10, "graph_replays": 0}, 0.0),
    ({"frame_pairs": 360, "dispatches": 10, "graph_replays": 9}, 90.0),
    ({"frame_pairs": 360, "dispatches": 10, "graph_replays": 10}, 100.0),
])
def test_graph_replay_share(counters, want):
    got = reader(NAME)(reading(360, {"flow": (0.01, 10)}, counters))
    assert got == (None if want is None else pytest.approx(want))


def test_it_is_a_per_layer_metric_of_the_corpus():
    spec = harness.load_json(tiny.ROOT / "BENCHMARK.json")
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["better"], m["unit"]) == (
        "program_counter", "extractor", "pairs_per_s", "higher", "%")
    assert m["workloads"] == ["extractor_w129.corpus"]
