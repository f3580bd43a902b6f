"""The Gaussian window at 1080p through `calc_flow_batched` (the
benchmark's configuration `calc_flow_1080p_gaussian` and its cell
`calc_flow_1080p.gaussian`): the cell loads from its files; the
benchmark's reference with either window equals the port's plain path,
and at flags 0 the box reference; a small run of the cell reads correct
with the port and not correct with the box window or the bfloat16
reference in its place; a clip's frames are views of the card's tape in
the pool's walk; K1's least work is a hand sum; and the two readers the
cell adds read nothing where the trace, its spans or the pairs are
absent."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
from optical_flow_tpu_torch.utils.config import FarnebackConfig
from portbench import control, generator, harness, k1_work, trace, yardstick
from portbench.entries import calc_flow
from portbench.reference import farneback as ref_farneback
from portbench.reference import farneback_gaussian as ref_gaussian
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parent.parent
CELL = "calc_flow_1080p.gaussian"
CONFIG = "calc_flow_1080p_gaussian"
SEED = 2**31 + 23
TINY = "tiny_calc.clips"


def _config(name=CONFIG):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_the_cell_resolves_to_its_files():
    spec, wl, cfg, traffic = harness.find(ROOT, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == (CONFIG, "corpus", 1)
    assert cfg["name"] == CONFIG and cfg["entry"] == "calc_flow"
    assert (ROOT / "portbench" / "entries" / "calc_flow.py").exists()
    assert traffic == json.loads((ROOT / "portbench" / "traffic" / "corpus.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}[CONFIG]
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert entry["reduced"] == cfg["reduced"] == ["decode", "host_threads"]
    assert set(cfg["limits"]) == {"call_errors", "flow_off_share"}


def test_the_configuration_is_the_references_parameters_with_the_gaussian_window():
    cfg = _config()
    box = _config("extractor_w1920")["farneback"]
    assert cfg["farneback"] == dict(box, flags=256)
    assert (cfg["frame_height"], cfg["frame_width"], cfg["batch_pairs"]) == (1080, 1920, 16)
    assert FarnebackConfig(**cfg["farneback"]).gaussian_window


def _pairs(b=2, h=64, w=96, seed=5):
    """b seeded pairs, the second frame a shifted crop of a smooth texture."""
    r = np.random.default_rng(seed)
    base = torch.as_tensor(r.integers(0, 256, (b, h + 4, w + 4), dtype=np.uint8))
    base = (base.float() + base.roll(1, -1).float() + base.roll(1, -2).float()) / 3
    base = base.to(torch.uint8)
    return base[:, :h, :w].contiguous(), base[:, 2:h + 2, 3:w + 3].contiguous()


@pytest.mark.parametrize("flags", [0, 256])
def test_the_reference_equals_the_plain_path(flags):
    fb = dict(_config()["farneback"], flags=flags)
    prev, nxt = _pairs()
    prog = calc_flow_batched(prev, nxt, FarnebackConfig(**fb), plain=True)
    ref = ref_gaussian.flow_pyramid(torch.cat([prev, nxt]), fb, False).movedim(1, -1)
    assert prog.abs().max() > 0.5
    assert torch.equal(prog, ref)


@pytest.mark.parametrize("chain", [False, True])
def test_at_flags_0_it_is_the_box_reference(chain):
    fb = dict(_config()["farneback"], flags=0)
    prev, nxt = _pairs(3)
    frames = torch.cat([prev, nxt[-1:]]) if chain else torch.cat([prev, nxt])
    assert torch.equal(ref_gaussian.flow_pyramid(frames, fb, chain),
                       ref_farneback.flow_pyramid(frames, fb, chain))


def test_the_window_differs_from_the_box_and_other_flags_raise():
    fb = _config()["farneback"]
    prev, nxt = _pairs()
    both = torch.cat([prev, nxt])
    assert not torch.equal(ref_gaussian.flow_pyramid(both, fb, False),
                           ref_gaussian.flow_pyramid(both, dict(fb, flags=0), False))
    with pytest.raises(ValueError):
        ref_gaussian.flow_pyramid(both, dict(fb, flags=4), False)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root with the configuration cut to 64x96 frames at 5 fps
    (2-8 s clips: 9-39 pairs, calls of 16 and a remainder)."""
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    cfg = _config()
    cfg.update(name="tiny_calc", frame_height=64, frame_width=96, pool_frames=24, fps=5.0)
    tiny.write(root, "configs", "tiny_calc", cfg)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": TINY, "config": "tiny_calc", "traffic": "tiny_videos",
                              "chips": 1, "why": "a test"})
    real = {m["name"]: m for m in harness.load_json(ROOT / "BENCHMARK.json")["per_layer"]}
    for m in spec["per_layer"]:
        if real[m["name"]].get("workloads") == [CELL]:
            m["workloads"] = [TINY]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _box_window():
    program = calc_flow.Program()
    make = program.FarnebackConfig
    program.FarnebackConfig = lambda **kw: make(**dict(kw, flags=0))
    return program


SYSTEMS = {
    "program": (lambda cfg: None, True),
    "box_window": (lambda cfg: _box_window(), False),
    "bfloat16_reference": (lambda cfg: control.Control(cfg), False),
}


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_the_cell_runs_small_on_the_cpu(root, system):
    make, correct = SYSTEMS[system]
    _, _, cfg, traffic = harness.find(root, TINY)
    out = harness.run_cell(root, TINY, SEED, float("inf"), system == "program", device="cpu",
                           program=make(cfg), max_units=traffic["check_among"])
    assert out["correct"] is correct, out["checks"]
    assert out["checks"]["call_errors"]["value"] == 0
    assert out["setup"]["checked_units"] == traffic["check_units"]
    if correct:
        assert out["checks"]["flow_off_share"]["value"] == 0
        # the CPU has no device trace: neither new reader finds anything
        assert {"kernels.k1_roofline_pct", "calc.call_host_us_per_pair"}.isdisjoint(
            out["metrics"])
    else:
        assert out["checks"]["flow_off_share"]["value"] > 0.5


@pytest.mark.parametrize("wrong", ["shape", "dtype"])
def test_a_wrong_flow_is_a_call_error(root, wrong):
    """A call whose flow lacks its last row, or comes back in float64:
    every call of the window is an error (the test counts them in the
    program's counters, which the harness clears after set-up)."""
    program = calc_flow.Program()
    calc = program.calc_flow_batched

    def broken(*args, **kw):
        program.metrics.add("calls")
        flow = calc(*args, **kw)
        return flow[:, :-1] if wrong == "shape" else flow.double()

    program.calc_flow_batched = broken
    out = harness.run_cell(root, TINY, SEED, float("inf"), False, device="cpu",
                           program=program, max_units=2)
    assert not out["correct"]
    assert out["checks"]["call_errors"]["value"] == program.metrics.counters["calls"] > 0


def test_calls_walk_the_clip_in_batches():
    runner = SimpleNamespace(batch=16)
    calls = calc_flow.Runner.calls(runner, 250)
    assert [b - a for a, b in calls] == [16] * 15 + [9]
    assert calls[0] == (0, 16) and calls[-1] == (240, 249)


@pytest.mark.parametrize("phase,stride,seconds", [(0, 1, 8.0), (41, 1, 2.0), (7, 3, 5.0),
                                                  (2**20 - 1, 2, 8.0)])
def test_a_clip_is_a_view_of_the_tape_in_the_pools_walk(root, phase, stride, seconds):
    """Frame f of a clip is pool frame `pool_index(phase + f * stride)`,
    and the clip shares the tape's memory: the window gathers nothing."""
    _, _, cfg, traffic = harness.find(root, TINY)
    runner = calc_flow.Runner(cfg, dict(traffic, stride=[1, 3]), SEED, calc_flow.Program(),
                              "cpu")
    runner.setup()
    pool = torch.as_tensor(np.stack(generator.frame_pool(
        cfg["frame_height"], cfg["frame_width"], cfg["pool_frames"], SEED, "cpu")))
    unit = {"seconds": seconds, "phase": phase, "stride": stride}
    clip = runner.clip(unit)
    walk = [generator.pool_index(phase + f * stride, len(pool))
            for f in range(runner.frame_count(unit))]
    assert torch.equal(clip, pool[walk])
    assert clip.untyped_storage().data_ptr() == runner.tape.untyped_storage().data_ptr()


@pytest.mark.parametrize("side", [0, 1])
def test_the_program_is_handed_views_of_the_clip(root, side):
    """prev (0) and nxt (1) of every call are views of the tape, one frame
    apart."""
    _, _, cfg, traffic = harness.find(root, TINY)
    program = calc_flow.Program()
    calc, seen = program.calc_flow_batched, []

    def spy(prev, nxt, *args, **kw):
        seen.append((prev, nxt))
        return calc(prev, nxt, *args, **kw)

    program.calc_flow_batched = spy
    runner = calc_flow.Runner(cfg, traffic, SEED, program, "cpu")
    runner.setup()
    seen.clear()
    runner.run_unit(next(generator.units(traffic, SEED)), keep=False)
    tape = runner.tape.untyped_storage().data_ptr()
    assert seen and all(pair[side].untyped_storage().data_ptr() == tape for pair in seen)
    assert all(torch.equal(prev[1:], nxt[:-1]) for prev, nxt in seen)


# one K1 step at 1080p level 0: 2,073,600 px, 56 B each (R0 20, flow 8, R1
# 20, flow out 8); 36 (M) + window + 19 (solve) operations a pixel; the box
# window's running sums 20, the Gaussian's 15 taps folded 10 * (3 * 7 + 1)
@pytest.mark.parametrize("flags,ops", [(0, 75), (256, 275)])
def test_k1_work_of_one_1080p_level_by_hand(flags, ops):
    px = 1080 * 1920
    assert k1_work.work_step(1, 1080, 1920, 15, flags) == (56 * px, ops * px)
    t = k1_work.step_seconds(1, 1080, 1920, 15, flags)
    assert t == pytest.approx(max(56 * px / 3.35e12, ops * px / 67e12))
    assert t == pytest.approx(56 * px / 3.35e12)      # bytes bound both windows
    level = [(0, 1080, 1920, 3)]
    chunks = [yardstick.Chunk(16, 1080, 1920, False, "sums"),
              yardstick.Chunk(9, 1080, 1920, False, "sums")]
    fb = dict(_config()["farneback"], flags=flags)
    assert k1_work.least_seconds(chunks, level, fb) == pytest.approx(25 * 3 * t)


def test_k1_window_is_counted_as_the_flags_ask():
    assert k1_work.window_ops(15, 0) == yardstick.WINDOW_OPS == 20
    assert k1_work.window_ops(15, 256) == 220
    assert k1_work.window_ops(63, 256) == 10 * (3 * 31 + 1)


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


def _trace(ops=(), spans=()):
    return trace.Trace((0, 10**9), [trace.Op(n, 0, s, e) for n, s, e in ops], [],
                       [trace.Op(n, -1, s, e) for n, s, e in spans], [])


def _reading(tr=None, pairs=0, chunks=()):
    runner = SimpleNamespace(h=1080, w=1920, chunks=lambda: list(chunks))
    return SimpleNamespace(trace=tr, runner=runner, cfg=_config(), pairs=pairs)


K1 = "void (anonymous namespace)::update_blur_kernel<true>(float const*, float const*)"


def test_k1_roofline_is_its_least_time_over_its_own_kernels():
    """Two pairs: 4 levels x 3 steps of 56 B a pixel at 3.35 TB/s (the
    Gaussian window's 275 operations a pixel take less at 67 TFLOP/s),
    over 2 ms of K1; other kernels and the copies do not count."""
    chunks = [yardstick.Chunk(1, 1080, 1920, False, "sums")] * 2
    px = sum(h * w for h, w in [(135, 240), (270, 480), (540, 960), (1080, 1920)])
    need = 2 * 3 * 56 * px / 3.35e12
    ops = [(K1, 0, 1_500_000), (K1, 2_000_000, 2_500_000),
           ("(anonymous namespace)::polyexp_kernel", 0, 10**8),
           ("Memcpy HtoD (Pinned -> Device)", 0, 10**8)]
    got = _reader("kernels.k1_roofline_pct")(_reading(_trace(ops), chunks=chunks))
    assert got == pytest.approx(100.0 * need / 2e-3)
    assert 0 < got < 100


def test_call_host_time_is_the_calls_spans_over_the_pairs():
    spans = [(calc_flow.SPAN, 0, 600_000), (calc_flow.SPAN, 10**6, 10**6 + 400_000),
             ("portbench/extract_frames", 0, 10**8)]
    got = _reader("calc.call_host_us_per_pair")(
        _reading(_trace(spans=spans), pairs=25))
    assert got == pytest.approx(1000.0 / 25)


@pytest.mark.parametrize("name,reading", [
    ("kernels.k1_roofline_pct", lambda: _reading()),
    ("kernels.k1_roofline_pct", lambda: _reading(_trace([("polyexp_kernel", 0, 10**6)]))),
    ("calc.call_host_us_per_pair", lambda: _reading(pairs=16)),
    ("calc.call_host_us_per_pair",
     lambda: _reading(_trace(spans=[("portbench/extract_frames", 0, 10**6)]), pairs=16)),
    ("calc.call_host_us_per_pair", lambda: _reading(_trace(spans=[(calc_flow.SPAN, 0, 10**6)]))),
], ids=["k1-no-trace", "k1-no-k1", "calc-no-trace", "calc-no-span", "calc-no-pairs"])
def test_the_readers_read_nothing_without_their_source(name, reading):
    assert _reader(name)(reading()) is None
