"""K1's instantiation with the window built in (winsize 15), on the CPU:
which windows take it, that its host taps are the device taps' values,
that the CPU path counts no launch, that the launch counters are taken,
restored and replayed together, and the benchmark's reader of its
share (`kernels.k1_fixed_window_pct`) on hand-made traces: the device
time of `update_blur_kernel<*, 7>` over that of every
`update_blur_kernel` operation, in %; 0 for a program whose K1 has no
fixed instantiation (its kernels print as `update_blur_kernel<true>`),
and None without a trace or without K1 in it.  The kernel itself runs
in tests/test_torch_cuda.py on the card."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels import update_gather
from optical_flow_tpu_torch.kernels.update_gather import k1_fixed, update_blur
from optical_flow_tpu_torch.models.farneback import core
from portbench import harness, trace

ROOT = Path(__file__).resolve().parent.parent
NAME = "kernels.k1_fixed_window_pct"
ARGS = "(float const*, float const*, float const*, float*, int, int, int, float const*"
BEFORE = "void (anonymous namespace)::update_blur_kernel<{}>" + ARGS + ", float, int)"
AFTER = ("void (anonymous namespace)::update_blur_kernel<{}>" + ARGS
         + ", (anonymous namespace)::FixedTaps, float, int)")
FIXED_GAUSS = AFTER.format("true, 7")
FIXED_BOX = AFTER.format("false, 7")
RUNTIME_GAUSS = AFTER.format("true, 0")
PARENT_GAUSS = BEFORE.format("true")
PARENT_BOX = BEFORE.format("false")
OTHER = "void (anonymous namespace)::polyexp_kernel<unsigned char, true, 5>(...)"


@pytest.mark.parametrize("winsize, fixed", [(15, True), (14, True), (13, False),
                                            (16, False), (9, False), (21, False),
                                            (61, False)])
def test_the_fixed_instantiation_takes_half_width_7(winsize, fixed):
    assert k1_fixed(winsize) == fixed


@pytest.mark.parametrize("winsize", [14, 15])
def test_host_taps_are_the_device_taps(winsize):
    taps = update_gather._host_taps(winsize)
    assert taps.dtype == np.float32 and taps.flags["C_CONTIGUOUS"]
    assert taps.shape == (15,)
    assert np.array_equal(taps, core.gaussian_window_kernel(winsize))


@pytest.mark.parametrize("gaussian", [False, True])
def test_the_cpu_path_counts_no_launch(gaussian):
    rng = np.random.default_rng(3)
    R0, R1 = (torch.as_tensor(rng.standard_normal((1, 5, 9, 11)).astype(np.float32))
              for _ in range(2))
    flow = torch.zeros(1, 2, 9, 11)
    kernels.reset_launches()
    got = update_blur(R0, R1, flow, 15, gaussian)
    assert torch.equal(got, core.update_step(R0, R1, flow, 15, gaussian))
    assert not any(kernels.launch_counts().values())


def test_the_counters_are_taken_and_replayed_together():
    """`launch_counts` keys both counters, `add_launches` adds such a
    delta back (a captured graph's restore and replay), and
    `reset_launches` zeroes both."""
    kernels.reset_launches()
    before = kernels.launch_counts()
    assert before[("launches", "K1")] == before[("fixed_window", "K1")] == 0
    assert set(before) == ({("launches", k) for k in kernels.LAUNCHES}
                           | {("fixed_window", "K1")})
    delta = {("launches", "K1"): 3, ("launches", "K2"): 1, ("fixed_window", "K1"): 3}
    kernels.add_launches(delta)
    kernels.add_launches(delta)
    assert kernels.LAUNCHES["K1"] == 6 and kernels.LAUNCHES["K2"] == 2
    assert kernels.FIXED_WINDOW == {"K1": 6}
    kernels.add_launches({k: before[k] - n for k, n in kernels.launch_counts().items()})
    assert kernels.launch_counts() == before
    kernels.add_launches(delta)
    kernels.reset_launches()
    assert not any(kernels.launch_counts().values())


def _reader():
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{NAME}.py").read


def _window(*ops):
    """A reading whose traced window holds `ops`, (name, ns) each, one
    after another on card 0, then a copy."""
    device_ops, t = [], 1000
    for name, ns in ops + (("Memcpy HtoD (Pinned -> Device)", 500),):
        device_ops.append(trace.Op(name, 0, t, t + ns))
        t += ns + 10
    return SimpleNamespace(trace=trace.Trace((0, t + 1000), device_ops, [], [], []))


@pytest.mark.parametrize("ops, want", [
    (((FIXED_GAUSS, 3000), (OTHER, 700), (FIXED_GAUSS, 1000)), 100.0),
    (((FIXED_BOX, 2500), (FIXED_GAUSS, 500)), 100.0),
    (((PARENT_GAUSS, 3000), (OTHER, 700)), 0.0),
    (((PARENT_BOX, 1000), (PARENT_GAUSS, 1000)), 0.0),
    (((RUNTIME_GAUSS, 4000),), 0.0),
    (((FIXED_GAUSS, 3000), (RUNTIME_GAUSS, 1000), (OTHER, 5000)), 75.0),
    (((FIXED_BOX, 1000), (PARENT_BOX, 3000)), 25.0),
    (((OTHER, 700),), None),
    ((), None),
], ids=["all_fixed", "both_windows_fixed", "parent", "parent_both_windows",
        "run_time", "mix", "mix_box", "no_k1", "no_kernels"])
def test_fixed_share(ops, want):
    got = _reader()(_window(*ops))
    assert got == (None if want is None else pytest.approx(want))


def test_no_trace_reads_none():
    assert _reader()(SimpleNamespace(trace=None)) is None


def test_it_is_a_per_layer_metric_of_the_four_cells():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    m = {m["name"]: m for m in spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["better"], m["unit"]) == (
        "device_trace", "kernels", "pairs_per_s", "higher", "%")
    assert m["workloads"] == ["visualizer_1080p.long_shots", "extractor_w129.corpus",
                              "extractor_w1920.corpus", "calc_flow_1080p.gaussian"]
    assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}
