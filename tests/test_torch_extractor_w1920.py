"""The extractor at `--frame_width 1920` (the benchmark's configuration
`extractor_w1920` and its cell `extractor_w1920.corpus`): the cell loads
from its files, its frames are what the program's resize gives 1080p
sources at that width, and at one frame a pinned group, as every 1080p
frame is, `extract_frames` gives the reference's windows and sums with
one copy and the frame's bytes staged a frame.  The two readers the cell
adds read their value from hand-built readings, and nothing where the
program or the trace has nothing to read."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch.ops.resize import aspect_preserving_size
from optical_flow_tpu_torch.pipeline import extractor, prefetch
from optical_flow_tpu_torch.utils import metrics as metrics_mod
from optical_flow_tpu_torch.utils.config import ExtractorConfig, FarnebackConfig
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics
from portbench import generator, harness, trace, yardstick
from portbench.reference import colorize as ref_colorize
from portbench.reference import extractor as ref_extractor
from portbench.reference import farneback as ref_farneback
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parent.parent
CELL = "extractor_w1920.corpus"
SEED = 2**31 + 19


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_the_cell_resolves_to_its_files():
    spec, wl, cfg, traffic = harness.find(ROOT, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("extractor_w1920", "corpus", 1)
    assert cfg["name"] == "extractor_w1920" and cfg["entry"] == "extractor"
    assert traffic == json.loads((ROOT / "portbench" / "traffic" / "corpus.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}["extractor_w1920"]
    assert entry["file"] == "portbench/configs/extractor_w1920.json"
    assert entry["reduced"] == cfg["reduced"] == _config("extractor_w129")["reduced"]


def test_the_configuration_is_w129s_at_native_width():
    """Every key of `extractor_w129.json`, the deployment's settings
    unchanged; only the frame size and what names it differ."""
    w129, w1920 = _config("extractor_w129"), _config("extractor_w1920")
    assert set(w129) <= set(w1920)
    named = {"name", "source", "deployment", "frame_height", "frame_width", "decode",
             "reference_block", "assumed"}
    assert {k: w129[k] for k in set(w129) - named} == {k: w1920[k] for k in set(w129) - named}
    assert set(w1920["assumed"]) == set(w129["assumed"])
    assert "--frame_width 1920" in w1920["source"] and ":51-59" in w1920["source"]


def test_the_frame_size_is_the_programs_resize_of_1080p():
    cfg = _config("extractor_w1920")
    fw, fh = aspect_preserving_size(cfg["source_height"], cfg["source_width"],
                                    cfg["frame_width"])
    assert (fh, fw) == (cfg["frame_height"], cfg["frame_width"]) == (1080, 1920)


@pytest.mark.parametrize("name,unit,source,layer", [
    ("extractor.upload_gb_per_s", "GB/s", "program_counter", "extractor"),
    ("kernels.x2_roofline_pct", "%", "device_trace", "kernels"),
])
def test_the_new_metrics_read_the_new_cell(name, unit, source, layer):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    m = {x["name"]: x for x in spec["per_layer"]}[name]
    assert (m["unit"], m["source"], m["layer"], m["better"]) == (unit, source, layer, "higher")
    assert m["moves"] == "pairs_per_s" and m["workloads"] == [CELL]
    assert (ROOT / "portbench" / "metrics" / f"{name}.py").exists()


def _clip(h, w, seconds=10.0, fps=25.0):
    """The cell's unit at (h, w): a clip's windows and its distinct frames
    from the harness's pool, as the entry hands them to the program."""
    pool = generator.frame_pool(h, w, 96, SEED, torch.device("cpu"))
    windows, _ = ref_extractor.window_schedule(int(seconds * fps), fps, 300, 300)
    needed = sorted({f for win in windows for f in win})
    return windows, [(f, pool[generator.pool_index(7 + f, len(pool))]) for f in needed]


def _reference_sums(windows, frames):
    live = dict(frames)
    both = torch.as_tensor(np.stack([live[s] for s, _ in windows]
                                    + [live[e] for _, e in windows]))
    cfg = _config("extractor_w1920")["farneback"]
    flow = ref_farneback.flow_pyramid(both, cfg, False, torch.float32)
    return ref_colorize.magnitude_sums(flow).double().numpy()


@pytest.mark.parametrize("chunk", [80, 5])
def test_one_frame_a_group_gives_the_references_sums(chunk, monkeypatch):
    """A 10 s clip at 72x128 with GROUP_BYTES below one frame's bytes, as
    every 1080p frame is past it: the reference's 36 windows and their
    sums within the cell's 1e-4, one copy and one frame's bytes staged a
    frame; in one chunk (the chunk 1080p gets on an 80 GB card) or in
    several."""
    windows, frames = _clip(72, 128)
    nbytes = frames[0][1].nbytes
    monkeypatch.setattr(prefetch, "GROUP_BYTES", nbytes - 1)
    m = PipelineMetrics("extract")
    cfg = ExtractorConfig(frame_width=128, farneback=FarnebackConfig(
        **_config("extractor_w1920")["farneback"]))
    got = extractor.extract_frames(iter(frames), list(enumerate(windows)), cfg,
                                   chunk_size=chunk, device="cpu", metrics=m)
    assert len(windows) == 36 and len(frames) == 72
    assert [got[i][:2] for i in sorted(got)] == windows
    ref = _reference_sums(windows, frames)
    prog = np.asarray([got[i][2] for i in range(len(windows))])
    assert np.all(np.abs(prog - ref) <= 1e-4 * np.abs(ref))
    assert m.counters["h2d_copies"] == m.counters["frames_decoded"] == 72
    assert m.counters["staged_bytes"] == 72 * nbytes


def test_staged_bytes_at_the_default_group():
    """At 72x128 a clip's 72 frames fit one group: one copy, the same
    bytes staged."""
    windows, frames = _clip(72, 128)
    m = PipelineMetrics("extract")
    extractor.extract_frames(iter(frames), list(enumerate(windows)), ExtractorConfig(),
                             chunk_size=128, device="cpu", metrics=m)
    assert m.counters["h2d_copies"] == 1
    assert m.counters["staged_bytes"] == 72 * 72 * 128


def test_the_summary_gives_the_staged_bytes_and_their_rate(monkeypatch):
    lines = []
    monkeypatch.setattr(metrics_mod.logger, "info", lines.append)
    m = PipelineMetrics("extract")
    m.stages["upload"] = metrics_mod.StageStats(seconds=0.5, count=72)
    m.add("h2d_copies", 72)
    m.add("staged_bytes", 72 * 2_073_600)
    m.log_summary()
    parts = lines[0].split("; ")
    i = parts.index("h2d_copies=72")
    assert parts[i + 1] == "staged_bytes=149299200" and parts[-1] == "upload_gb_per_s=0.299"
    m.counters.pop("staged_bytes")
    m.log_summary()
    assert "staged_bytes" not in lines[1] and "upload_gb_per_s" not in lines[1]


def test_the_cell_runs_small_on_the_cpu(tmp_path, monkeypatch):
    """The configuration, cut to 72x128 frames, through the harness with
    one frame a group: `correct`, and the traced line reads
    `extractor.upload_gb_per_s` (the CPU has no device trace, so no
    `kernels.x2_roofline_pct`)."""
    root = tiny.make_root(tmp_path)
    cfg = _config("extractor_w1920")
    cfg.update(name="tiny_ext", frame_height=72, frame_width=128, reference_block=64,
               pool_frames=24)
    tiny.write(root, "configs", "tiny_ext", cfg)
    monkeypatch.setattr(prefetch, "GROUP_BYTES", 72 * 128 - 1)
    out = harness.run_cell(root, "tiny_ext.videos", SEED, float("inf"), True, device="cpu",
                           max_units=tiny.VIDEOS["check_among"])
    assert out["correct"], out["checks"]
    assert out["metrics"]["extractor.upload_gb_per_s"]["value"] > 0
    assert "kernels.x2_roofline_pct" not in out["metrics"]


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


def _reading(stages=(), counters=(), tr=None, chunks=()):
    program = SimpleNamespace(metrics=SimpleNamespace(counters=dict(counters)))
    runner = SimpleNamespace(program=program, chunks=lambda: list(chunks))
    return SimpleNamespace(stages=dict(stages), trace=tr, runner=runner)


def test_upload_rate_is_the_staged_bytes_over_the_stage():
    read = _reader("extractor.upload_gb_per_s")
    assert read(_reading({"upload": (0.25, 72)}, {"staged_bytes": 149_299_200})) == \
        pytest.approx(0.5971968)
    assert read(_reading({"upload": (0.25, 72)}, {"h2d_copies": 72})) is None
    assert read(_reading({"flow": (0.25, 1)}, {"staged_bytes": 10})) is None
    assert read(_reading({"upload": (0.0, 0)}, {"staged_bytes": 0})) is None


def test_x2_bytes_of_one_1080p_pair_by_hand():
    # the planar flow: 2 planes of 1080 x 1920 f32 read once; one f32 sum
    assert yardstick.work_magnitude_sum(1, 1080, 1920)[0] == 2 * 1080 * 1920 * 4 + 4 \
        == 16_588_804


def _trace(ops):
    return trace.Trace((0, 10**9), [trace.Op(n, 0, s, e) for n, s, e in ops], [], [], [])


def test_x2_roofline_is_its_bytes_over_its_own_kernels():
    """Two 1080p pairs need 2 x 16,588,804 B, 9.90376 us at 3.35 TB/s;
    X2's two launches take 15 + 5 us of device time: 49.5188 %.  Other
    kernels and the copies do not count."""
    read = _reader("kernels.x2_roofline_pct")
    chunks = [yardstick.Chunk(1, 1080, 1920, False, "sums")] * 2
    ops = [("(anonymous namespace)::span_sum_kernel(float const*, long long, int, "
            "double*, float*)", 0, 15_000),
           ("(anonymous namespace)::combine_kernel(double const*, int, int, float*)",
            10**6, 10**6 + 5_000),
           ("(anonymous namespace)::update_blur_kernel", 0, 10**8),
           ("Memcpy HtoD (Pinned -> Device)", 0, 10**8)]
    assert read(_reading(tr=_trace(ops), chunks=chunks)) == pytest.approx(49.5188, abs=1e-4)


def test_x2_roofline_is_none_without_x2_or_a_trace():
    read = _reader("kernels.x2_roofline_pct")
    chunks = [yardstick.Chunk(36, 1080, 1920, False, "sums")]
    assert read(_reading(chunks=chunks)) is None
    other = _trace([("(anonymous namespace)::update_blur_kernel", 0, 10**6)])
    assert read(_reading(tr=other, chunks=chunks)) is None
