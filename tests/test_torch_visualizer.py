"""The port's visualizer slice against the JAX package's, on the CPU: the
chained pyramid and its BGR entries, the device loop, `visualize_shot` on
a synthetic clip, its CLI, and the host pieces it runs (decode, JPEG,
prefetch, chunk sizing, metrics).

Tolerances:
  * chained flow: the share gate of tests/test_torch_flow.py (rint flips
    where JAX's XLA:CPU contracts multiply-adds); the port's chain equals
    its own batched pairs exactly (each frame's pyramid is computed by the
    same ops either way);
  * BGR from the flow: at most 1e-3 of the bytes differ (a flow that
    differs in its last bits can flip a truncated hue or value byte);
  * `visualize_shot`: the same file names, `source_*.jpeg` byte-equal,
    each decoded `flow_*.jpeg` with at most 1 % of its bytes off, by at
    most 8 levels (JPEG spreads a one-level difference of its input over
    the 8x8 block; one hue level moves a BGR channel by up to about 8.5).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from optical_flow_tpu.models.farneback import flow as jflow
from optical_flow_tpu.oracle.synthetic import (motion_boundary_pair,
                                               smooth_texture_pair,
                                               write_synthetic_video)
from optical_flow_tpu_torch.models.farneback import flow as tflow
from optical_flow_tpu_torch.pipeline import prefetch, visualizer
from optical_flow_tpu.utils.config import FarnebackConfig as JaxConfig
from optical_flow_tpu_torch.utils.config import FarnebackConfig, VisualizerConfig
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

from test_torch_flow import assert_flow_close

SHOT = (200, 1400)   # ms: 5 sampled frames, 4 pairs of the 25 fps clip


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The clip the JAX visualizer tests use (tests/test_pipeline_units.py:144)."""
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    write_synthetic_video(path, n_frames=40, h=96, w=128, fps=25.0)
    return path


def _chain_frames():
    """N=4 frames at 72x129: smooth shift, back, then a motion boundary."""
    f1, f2 = smooth_texture_pair(72, 129, (2, 3))
    b1, _ = motion_boundary_pair(72, 129)
    return np.stack([f1, f2, f1, b1])


def test_calc_flow_chain_batched_matches_jax():
    frames = _chain_frames()
    got = tflow.calc_flow_chain_batched(frames, device="cpu")
    assert got.shape == (3, 72, 129, 2) and got.dtype == torch.float32
    assert_flow_close(got.numpy(), jflow.calc_flow_chain_batched(jnp.asarray(frames)))
    assert torch.equal(got, tflow.calc_flow_batched(frames[:-1], frames[1:], device="cpu"))


def test_calc_flow_bgr_chain_batched_matches_jax():
    frames = _chain_frames()
    got = tflow.calc_flow_bgr_chain_batched(frames, device="cpu").numpy()
    ref = np.asarray(jflow.calc_flow_bgr_chain_batched(jnp.asarray(frames)))
    assert got.shape == ref.shape == (3, 3, 72, 129) and got.dtype == np.uint8
    assert (got != ref).mean() <= 1e-3
    # the pair entry gives the same bytes for the same pairs
    pairs = tflow.calc_flow_bgr_batched(frames[:-1], frames[1:], device="cpu").numpy()
    np.testing.assert_array_equal(pairs, got)


def test_calc_flow_bgr_batched_matches_jax():
    f1, f2 = smooth_texture_pair(72, 129, (2, 3))
    prev, nxt = np.stack([f1, f2]), np.stack([f2, f1])
    got = tflow.calc_flow_bgr_batched(prev, nxt, device="cpu").numpy()
    ref = np.asarray(jflow.calc_flow_bgr_batched(jnp.asarray(prev), jnp.asarray(nxt)))
    assert got.shape == ref.shape == (2, 3, 72, 129)
    assert (got != ref).mean() <= 1e-3


def test_chain_entries_reject_like_jax():
    frames = _chain_frames()
    for fn in (tflow.calc_flow_chain_batched, tflow.calc_flow_bgr_chain_batched):
        with pytest.raises(ValueError):
            fn(frames[0], device="cpu")                # (H, W)
        with pytest.raises(ValueError):
            fn(frames[:1], device="cpu")               # one frame
    with pytest.raises(ValueError):
        tflow.calc_flow_bgr_batched(frames[:2], frames[1:], device="cpu")


@pytest.mark.parametrize("flags", [256, 4])
def test_chain_entries_take_the_flags_like_jax(flags):
    """The Gaussian window runs through the chain; the chained pairs carry
    no seed, so flags 4 starts from zero flow, as in the JAX package."""
    frames = _chain_frames()
    got = tflow.calc_flow_bgr_chain_batched(frames, FarnebackConfig(flags=flags),
                                            device="cpu").numpy()
    ref = np.asarray(jflow.calc_flow_bgr_chain_batched(
        jnp.asarray(frames), JaxConfig(flags=flags)))
    assert got.shape == ref.shape == (3, 3, 72, 129)
    assert (got != ref).mean() <= 1e-3
    chain = tflow.calc_flow_chain_batched(frames, FarnebackConfig(flags=flags), device="cpu")
    assert_flow_close(chain.numpy(), jflow.calc_flow_chain_batched(
        jnp.asarray(frames), JaxConfig(flags=flags)))
    if flags == 4:
        assert torch.equal(chain, tflow.calc_flow_chain_batched(frames, device="cpu"))


def _gray_sequence(n, h=40, w=56):
    f1, f2 = smooth_texture_pair(h, w, (1, 2))
    return [(0.5 + 3 * i, f1 if i % 2 == 0 else f2) for i in range(n)]


@pytest.mark.parametrize("chunk", [1, 2, 3, 10])
def test_visualize_frames_chunks_give_one_chain(chunk):
    """Every chunking restacks the previous chunk's last frame, so the
    written images equal one chain over all frames, in order."""
    seq = _gray_sequence(7)
    got = []
    n = visualizer.visualize_frames(seq, lambda pos, bgr: got.append((pos, bgr.copy())),
                                    chunk_size=chunk, device="cpu")
    assert n == 6
    assert [p for p, _ in got] == [p for p, _ in seq[1:]]
    ref = tflow.calc_flow_bgr_chain_batched(np.stack([g for _, g in seq]), device="cpu").numpy()
    np.testing.assert_array_equal(np.stack([b for _, b in got]), ref)


def test_visualize_frames_keeps_one_chunk_in_flight(monkeypatch):
    """A chunk is handed to the writer only after the next chunk has been
    dispatched (`pipeline/visualizer.py:143-145` of the JAX package)."""
    events = []
    real = visualizer.calc_flow_chain_batched

    def dispatch(frames, *args, **kw):
        events.append(("dispatch", frames.shape[0] - 1))
        return real(frames, *args, **kw)

    monkeypatch.setattr(visualizer, "calc_flow_chain_batched", dispatch)
    visualizer.visualize_frames(_gray_sequence(8), lambda pos, bgr: events.append(("write", pos)),
                                chunk_size=3, device="cpu")
    writes = [e[1] for e in events if e[0] == "write"]
    assert [e[0] for e in events] == (["dispatch", "dispatch"] + ["write"] * 3
                                      + ["dispatch"] + ["write"] * 3 + ["write"])
    assert [e[1] for e in events if e[0] == "dispatch"] == [3, 3, 1]
    assert writes == [p for p, _ in _gray_sequence(8)[1:]]


DISPATCH_CASES = [
    (2, 10, 3, [2], 0),                  # shorter than one sub-chunk
    (3, 10, 3, [3], 1),                  # exactly one
    (4, 10, 3, [3, 1], 1),               # one more than one
    (11, 10, 3, [3, 3, 3, 2], 3),        # several, and a remainder
    (8, 10, 2.5, [3, 3, 2], 2),          # the budget between two pair counts
    (7, 2, 3, [2, 2, 2, 1], 0),          # chunk_size below the budget
    (12, 12, 12, [12], 0),               # a whole shot's 13 frames in one group
]


@pytest.mark.parametrize("pairs, chunk, budget_pairs, sizes, early", DISPATCH_CASES)
def test_visualize_frames_dispatches_by_pixels(monkeypatch, pairs, chunk, budget_pairs,
                                               sizes, early):
    """Pending pairs are dispatched once they hold DISPATCH_PIXELS pixels,
    or at chunk_size where that comes first; the images still equal one
    chain over all frames, in order, and the counters count every dispatch
    and those the pixels made.  The frames (2,240 B) share their groups,
    so each dispatch sends one: fewer copies than frames."""
    seq = _gray_sequence(pairs + 1)
    h, w = seq[0][1].shape
    monkeypatch.setattr(prefetch, "DISPATCH_PIXELS", int(budget_pairs * h * w))
    dispatched = []
    real = visualizer.calc_flow_chain_batched

    def dispatch(frames, *args, **kw):
        dispatched.append(frames.shape[0] - 1)
        return real(frames, *args, **kw)

    monkeypatch.setattr(visualizer, "calc_flow_chain_batched", dispatch)
    m = PipelineMetrics("visualize")
    got = []
    n = visualizer.visualize_frames(seq, lambda pos, bgr: got.append((pos, bgr.copy())),
                                    chunk_size=chunk, device="cpu", metrics=m)
    assert n == pairs and dispatched == sizes
    assert m.counters["dispatches"] == len(sizes) == m.stages["flow"].count
    assert m.counters["early_dispatches"] == early
    assert m.counters["h2d_copies"] == len(sizes) < pairs + 1
    assert m.counters["staged_bytes"] == (pairs + 1) * h * w
    assert [p for p, _ in got] == [p for p, _ in seq[1:]]
    ref = tflow.calc_flow_bgr_chain_batched(np.stack([g for _, g in seq]), device="cpu").numpy()
    np.testing.assert_array_equal(np.stack([b for _, b in got]), ref)


@pytest.mark.parametrize("pairs, chunk, budget_pairs, sizes, early", DISPATCH_CASES)
def test_dispatch_pairs_gives_the_loops_dispatches(monkeypatch, pairs, chunk, budget_pairs,
                                                   sizes, early):
    """`dispatch_pairs` is the size of every dispatch of a shot but its
    last, and a dispatch is early exactly when it is smaller than
    chunk_size."""
    h, w = 40, 56
    monkeypatch.setattr(prefetch, "DISPATCH_PIXELS", int(budget_pairs * h * w))
    per = prefetch.dispatch_pairs(h, w, chunk)
    assert sizes == [per] * (pairs // per) + ([pairs % per] if pairs % per else [])
    assert early == (pairs // per if per < chunk else 0)


def test_dispatch_pairs_at_1080p():
    assert prefetch.dispatch_pairs(1080, 1920, 80) == 16
    assert prefetch.dispatch_pairs(1080, 1920, 80, cards=4) == 64
    assert prefetch.dispatch_pairs(1080, 1920, 8) == 8
    assert prefetch.dispatch_pairs(4320, 7680, 5) == 1
    assert prefetch.dispatch_pairs(72, 129, 128) == 128


@pytest.mark.parametrize("per_group, copies", [
    (0.5, 7),                            # GROUP_BYTES below one frame: a frame a group
    (1.5, 7),                            # between one frame and two
    (2.5, 4),                            # two frames a group, the last one sent half full
    (8, 1),                              # past the whole sequence: one group
])
def test_device_stager_copies_each_group_once(monkeypatch, per_group, copies):
    """Frames (numpy arrays and CPU tensors) staged by key: one
    `h2d_copies` a group sent, `staged_bytes` every frame's bytes (a
    group never sent counts too), and each frame read back equal to its
    host frame after the host frame changed; keys deleted stay deleted
    when their group is sent."""
    rng = np.random.default_rng(3)
    host = [rng.integers(0, 256, (24, 32), dtype=np.uint8) for _ in range(7)]
    frames = [f.copy() if k % 2 else torch.from_numpy(f.copy()) for k, f in enumerate(host)]
    monkeypatch.setattr(prefetch, "GROUP_BYTES", int(per_group * host[0].nbytes))
    m = PipelineMetrics("t")
    staged = prefetch.DeviceStager(torch.device("cpu"), m)
    for k, f in enumerate(frames):
        staged.put(k, f)
    del staged[0]
    for f in frames:
        f[:] = 0
    staged.send()
    staged.send()                        # no open group: no copy
    staged.finish()
    assert m.counters["h2d_copies"] == copies
    assert m.counters["staged_bytes"] == 7 * host[0].nbytes
    assert sorted(staged) == list(range(1, 7))
    for k in range(1, 7):
        np.testing.assert_array_equal(staged[k].numpy(), host[k])
    unread = prefetch.DeviceStager(torch.device("cpu"), PipelineMetrics("t"))
    unread.put(0, host[0])
    unread.finish()
    assert unread.metrics.counters.get("h2d_copies", 0) == int(per_group < 2)
    assert unread.metrics.counters["staged_bytes"] == host[0].nbytes


def test_visualize_shot_matches_jax(clip, tmp_path):
    from optical_flow_tpu.pipeline.visualizer import visualize_shot as jax_visualize_shot

    port, ref = tmp_path / "port", tmp_path / "jax"
    n = visualizer.visualize_shot(clip, str(port), *SHOT, device="cpu")
    assert n == jax_visualize_shot(clip, str(ref), *SHOT) == 4
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    assert sum(x.startswith("flow_") for x in names) == 4
    assert sum(x.startswith("source_") for x in names) == 4
    from PIL import Image
    for name in names:
        a, b = (port / name).read_bytes(), (ref / name).read_bytes()
        if name.startswith("source_"):
            assert a == b, name
        elif a != b:
            da = np.asarray(Image.open(port / name)).astype(np.int32)
            db = np.asarray(Image.open(ref / name)).astype(np.int32)
            d = np.abs(da - db)
            assert d.max() <= 8, f"{name}: {d.max()}"
            assert (d > 0).mean() <= 1e-2, f"{name}: {(d > 0).mean()}"


def test_visualize_shot_degenerate_inputs(clip, tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    out = tmp_path / "out"
    assert visualizer.visualize_shot(str(bad), str(out), 0, 1000, device="cpu") == 0
    assert out.is_dir() and os.listdir(out) == []
    with pytest.raises(ValueError):       # 10 ms is shorter than a frame at 25 fps
        visualizer.visualize_shot(clip, str(out), *SHOT,
                                  config=VisualizerConfig(step_size=10), device="cpu")
    assert visualizer.visualize_shot(clip, str(out), 200, 300,
                                     device="cpu") == 0   # one sample


def test_visualize_shot_validate_matches_jax(clip, tmp_path, monkeypatch):
    """validate=True: the first grey pair's mean EPE against cv2, as the
    `validate_mean_epe` counter, equal to the JAX visualizer's (both
    flows against the same cv2 flow; None in both where cv2 is absent)."""
    from optical_flow_tpu.pipeline import visualizer as jvis
    from optical_flow_tpu_torch.utils import validate

    counters = {}

    def recording(module, key):
        class Recording(module.PipelineMetrics):
            def log_summary(self):
                counters[key] = dict(self.counters)
                super().log_summary()
        monkeypatch.setattr(module, "PipelineMetrics", Recording)

    recording(visualizer, "port")
    recording(jvis, "jax")
    cfg = VisualizerConfig(validate=True)
    assert visualizer.visualize_shot(clip, str(tmp_path / "p"), *SHOT, config=cfg,
                                     device="cpu") == 4
    from optical_flow_tpu.utils.config import VisualizerConfig as JaxVisualizerConfig
    assert jvis.visualize_shot(clip, str(tmp_path / "j"), *SHOT,
                               config=JaxVisualizerConfig(validate=True)) == 4
    port, ref = (counters[k].get("validate_mean_epe") for k in ("port", "jax"))
    assert (port is None) == (ref is None)
    if port is not None:
        assert abs(port - ref) <= 1e-3
        assert port <= validate.EPE_GATE
    assert counters["port"]["frame_pairs"] == 4


def test_sampled_epe_without_cv2(monkeypatch):
    import builtins

    from optical_flow_tpu_torch.utils import validate

    real = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    f1, f2 = smooth_texture_pair(40, 56, (1, 2))
    assert validate.sampled_epe(f1, f2, device="cpu") is None
    validate.log_validation(None, "t")
    validate.log_validation(0.7, "t")


def test_cli_parser_matches_jax(clip, tmp_path):
    from optical_flow_tpu.cli import visualize_optical_flow as jcli
    from optical_flow_tpu_torch.cli import visualize_optical_flow as tcli

    argv = ["/v/clip.mp4", "/out", "100", "2000", "--validate"]
    assert_parser_matches_jax(tcli.build_parser(), jcli.build_parser(), argv)
    out = tmp_path / "cli"
    tcli.main([clip, str(out), str(SHOT[0]), str(SHOT[1]), "--device", "cpu"])
    assert len(os.listdir(out)) == 8


def assert_parser_matches_jax(port, jax, argv):
    """Every action of the JAX parser, and the same parse of `argv`; the
    port's one more action is `--device`, default "cuda"."""
    def spec(parser):
        return [(a.dest, a.type, a.default, a.required, a.nargs, a.const)
                for a in parser._actions if a.dest != "device"]

    assert spec(port) == spec(jax)
    assert [a.default for a in port._actions if a.dest == "device"] == ["cuda"]
    got = vars(port.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jax.parse_args(argv))
    assert port.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_video_reader_and_jpeg_match_jax(clip, tmp_path):
    from optical_flow_tpu.io.jpeg import write_jpeg_bgr as jax_write
    from optical_flow_tpu.io.video import VideoReader as JaxReader
    from optical_flow_tpu_torch.io.jpeg import write_jpeg_bgr
    from optical_flow_tpu_torch.io.video import VideoReader

    with VideoReader(clip) as t, JaxReader(clip) as j:
        assert ((t.fps, t.frame_count, t.width, t.height, t.is_vfr)
                == (j.fps, j.frame_count, j.width, j.height, j.is_vfr))
        for pos in (0, 7.9, 39, 40):
            (rt, ft), (rj, fj) = t.read_at(pos), j.read_at(pos)
            assert rt == rj
            if rt:
                np.testing.assert_array_equal(ft, fj)
        frame = t.read_at(12)[1]
    write_jpeg_bgr(str(tmp_path / "a.jpeg"), frame)
    jax_write(str(tmp_path / "b.jpeg"), frame)
    assert (tmp_path / "a.jpeg").read_bytes() == (tmp_path / "b.jpeg").read_bytes()
    assert not VideoReader(str(tmp_path / "a.jpeg.missing")).is_opened()


@pytest.mark.parametrize("positions,workers", [
    ([0, 3, 7, 7.9, 12, 39], 1),
    (list(range(0, 40, 3)), 4),
    ([0, 5, 77, 10, 12, 14, 16, 18, 20, 22, 24, 26], 4),   # early break
])
def test_decode_prefetcher_matches_jax(clip, positions, workers):
    from optical_flow_tpu.pipeline.prefetch import DecodePrefetcher as JaxPrefetcher
    from optical_flow_tpu_torch.pipeline.prefetch import DecodePrefetcher

    got = list(DecodePrefetcher(clip, positions, workers=workers,
                                transform=lambda f: (f, f[..., 1])))
    ref = list(JaxPrefetcher(clip, positions, workers=workers,
                             transform=lambda f: (f, f[..., 1])))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a[0], b[0])
    if 77 in positions:
        assert got[-1] == (77, None)


def test_pair_chunk_for(monkeypatch):
    from optical_flow_tpu.pipeline import prefetch as jprefetch
    from optical_flow_tpu_torch.pipeline import prefetch

    monkeypatch.setattr(jprefetch, "_device_hbm_bytes", lambda: 16 << 30)
    for h, w in ((1080, 1920), (2160, 3840), (96, 128), (72, 129)):
        assert prefetch.pair_chunk_for(h, w) == jprefetch.pair_chunk_for(h, w)
    assert prefetch.pair_chunk_for(1080, 1920) == 16
    assert prefetch.pair_chunk_for(8, 8) == jprefetch.pair_chunk_for(8, 8) == 128
    assert prefetch.pair_chunk_for(8192, 8192) == 1
    # a CUDA device scales the budget by its memory: 80 GiB -> 5x
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (0, 80 << 30))
    assert prefetch.pair_chunk_for(1080, 1920, device="cuda:0") == 80
    assert prefetch.pair_chunk_for(1080, 1920, device="cpu") == 16



@pytest.mark.parametrize("gib", [14, 15.5, 16, 18, 18.5, 80])
def test_pair_chunk_for_scale_snap_and_positional_args(monkeypatch, gib):
    """JAX's parameters at JAX's positions, and its snap of a memory
    scale within 0.85-1.15 to exactly 1.0 (a card reporting 15.5 GiB keeps
    the 16 pairs at 1080p)."""
    from optical_flow_tpu.pipeline import prefetch as jprefetch
    from optical_flow_tpu_torch.pipeline import prefetch

    monkeypatch.setattr(jprefetch, "_device_hbm_bytes", lambda: int(gib * (1 << 30)))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (0, int(gib * (1 << 30))))
    for h, w in ((1080, 1920), (2160, 3840), (72, 129)):
        assert (prefetch.pair_chunk_for(h, w, device="cuda:0")
                == jprefetch.pair_chunk_for(h, w))
    assert prefetch.pair_chunk_for(1080, 1920, 10 << 20, 3) == jprefetch.pair_chunk_for(
        1080, 1920, 10 << 20, 3) == 3
    assert prefetch.pair_chunk_for(96, 128, 1 << 20) == jprefetch.pair_chunk_for(
        96, 128, 1 << 20) == 85


def test_decode_prefetcher_takes_a_positional_depth(clip):
    """JAX's third positional parameter is the decode-ahead depth, not the
    transform."""
    from optical_flow_tpu.pipeline.prefetch import DecodePrefetcher as JaxPrefetcher
    from optical_flow_tpu_torch.pipeline.prefetch import DecodePrefetcher

    positions = list(range(0, 40, 3))
    got = list(DecodePrefetcher(clip, positions, 4, lambda f: f[..., 1], 2))
    ref = list(JaxPrefetcher(clip, positions, 4, lambda f: f[..., 1], 2))
    assert [p for p, _ in got] == [p for p, _ in ref] == positions
    for (_, a), (_, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_default_decode_workers_matches_jax(monkeypatch):
    from optical_flow_tpu.pipeline import prefetch as jprefetch
    from optical_flow_tpu_torch.pipeline import prefetch

    monkeypatch.delenv("OFT_DECODE_WORKERS", raising=False)
    for n in (0, 5, 8, 64, 1000):
        assert prefetch.default_decode_workers(n) == jprefetch.default_decode_workers(n)
    monkeypatch.setenv("OFT_DECODE_WORKERS", "3")
    assert prefetch.default_decode_workers(100) == 3


def test_pipeline_metrics():
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    m = PipelineMetrics("t")
    for _ in range(2):
        with m.stage("a"):
            pass
    m.add("frame_pairs", 5)
    assert m.stages["a"].count == 2 and m.stages["a"].seconds >= 0
    assert m.counters == {"frame_pairs": 5}
    m.log_summary()
