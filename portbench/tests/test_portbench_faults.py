"""The check decides `correct`: a run of each entry, on the CPU at a small
size, skips the harness's look for a card and drives the rest of a run; it
reads correct with the program as it is, and not correct with the timed
path broken underneath in each way the cell can be broken, or with the
control (the reference in bfloat16) in the program's place.  Every cell
runs on one card, so no cell has an exchange between cards to leave out."""

import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny
from optical_flow_tpu_torch.kernels import fused_iterate
from optical_flow_tpu_torch.pipeline import extractor, visualizer

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


def run(root, cell, **kw):
    return harness.run_cell(root, cell, SEED, 0.5, False, device="cpu", **kw)


def state_unchanged(R0, R1, flow, *args, **kw):
    return flow


def half_chain(frames, config, plain=False):
    """The flow of the first half of the pairs; the rest their mean."""
    frames = torch.as_tensor(frames)
    b = (frames.shape[0] - 1 + 1) // 2
    head = CHAIN(frames[:b + 1], config, plain=plain)
    rest = head.mean(0, keepdim=True).expand(frames.shape[0] - 1 - b, *head.shape[1:])
    return torch.cat([head, rest])


def half_sums(prev, nxt, config, *, device, plain=False, nan_check=False, mesh=None):
    b = (prev.shape[0] + 1) // 2
    sums, finite = SUMS(prev[:b], nxt[:b], config, device=device, plain=plain,
                        nan_check=nan_check, mesh=mesh)
    rest = sums.mean().expand(prev.shape[0] - b)
    return torch.cat([sums, rest]), finite


def altered_bgr(flow, plain=False):
    bgr = BGR(flow, plain).clone()
    bgr[-1, :, 8:16, 8:16] ^= 0x10
    return bgr


def altered_sums(prev, nxt, config, *, device, plain):
    flow, sums = FLOW_SUMS(prev, nxt, config, device=device, plain=plain)
    return flow, sums * torch.where(torch.arange(sums.shape[0]) == sums.shape[0] - 1, 1.001, 1.0)


CHAIN = visualizer.calc_flow_chain_batched
SUMS = extractor._magnitude_sums
BGR = visualizer.flow_bgr
FLOW_SUMS = extractor._flow_and_sums

FAULTS = {
    "tiny_vis.shots": [
        ("state_unchanged", fused_iterate, "update_flow", state_unchanged),
        ("half_the_batch", visualizer, "calc_flow_chain_batched", half_chain),
        ("answer_altered", visualizer, "flow_bgr", altered_bgr),
    ],
    "tiny_ext.videos": [
        ("state_unchanged", fused_iterate, "update_flow", state_unchanged),
        ("half_the_batch", extractor, "_magnitude_sums", half_sums),
        ("answer_altered", extractor, "_flow_and_sums", altered_sums),
    ],
}
CASES = [(cell, *f) for cell, faults in FAULTS.items() for f in faults]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_program_is_correct(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["setup"]["checked_units"] > 0


@pytest.mark.parametrize("cell,fault,module,name,broken", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_fault_reads_not_correct(root, cell, fault, module, name, broken, monkeypatch):
    monkeypatch.setattr(module, name, broken)
    out = run(root, cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_control_reads_not_correct(root, cell):
    _, _, cfg, _ = harness.find(root, cell)
    out = run(root, cell, program=control.Control(cfg))
    assert not out["correct"], out["checks"]
