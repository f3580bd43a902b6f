"""The two controls of `calc_flow_1080p.gaussian` on the card, at the
cell's size and load (the first `check_among` clips of its traffic): the
port with the box window (flags 0) in place of the Gaussian one, and the
reference in bfloat16 in the program's place, each read not correct on
two seeds.  Each run's compared numbers are printed as a JSON line.
On the card: python -m pytest -m cuda portbench/tests -q -s"""

import json

import pytest
import torch

from portbench import control, harness
from portbench.entries import calc_flow
from portbench.tests.tiny import ROOT

CELL = "calc_flow_1080p.gaussian"
SEEDS = [2**31 + 211, 2**31 + 212]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return "cuda:0"


def box_window(cfg):
    program = calc_flow.Program()
    make = program.FarnebackConfig
    program.FarnebackConfig = lambda **kw: make(**dict(kw, flags=0))
    return program


CONTROLS = {"box_window": box_window, "bfloat16_reference": control.Control}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_the_control_reads_not_correct(card, name):
    _, _, cfg, traffic = harness.find(ROOT, CELL)
    for seed in SEEDS:
        out = harness.run_cell(ROOT, CELL, seed, float("inf"), False, device=card,
                               program=CONTROLS[name](cfg), max_units=traffic["check_among"])
        print(json.dumps({"control": name, "seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "checked_units": out["setup"]["checked_units"]}), flush=True)
        assert out["setup"]["checked_units"] == traffic["check_units"]
        assert not out["correct"], out["checks"]
