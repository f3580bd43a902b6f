"""The control on the card at each cell's own size: the reference in
bfloat16, put in the program's place, reads not correct on three seeds,
and the port reads correct on the same seeds (`portbench/control.py`).
On the card: python -m pytest -m cuda portbench/tests -q"""

import json

import pytest
import torch

from portbench import control
from portbench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_port_passes(cell):
    chips = {w["name"]: w["chips"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}[cell]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA card(s)")
    device = "cuda:0" if chips == 1 else None
    assert not any(r["correct"] for r in control.readings(cell, SEEDS, False, device))
    assert all(r["correct"] for r in control.readings(cell, SEEDS, True, device))
