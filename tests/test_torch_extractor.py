"""The port's extractor slice against the JAX package's, on the CPU: the
window schedule, `scale_magnitudes`, the sidecar files' bytes, the host
resize, corpus sharding, the device loop `extract_frames`, and the
port's `optical_flow` CLI against the JAX `run_corpus` on one synthetic
corpus, with the `.done` gate, `--force_run`, `--resume`, `--robust`,
fail-fast and the skip of a variable-frame-rate video.

Tolerances: `.done` bytes and CSV timestamps identical; CSV magnitudes
(percentile-scaled to 0-100, 2 decimals) within 0.01, one rounding step:
the two flows differ by rint flips in their last bits
(tests/test_torch_flow.py).  Host ops and sidecar bytes are equal.
"""

import os

import numpy as np
import pytest

from optical_flow_tpu.io import sidecar as jsidecar
from optical_flow_tpu.oracle.synthetic import write_synthetic_video
from optical_flow_tpu.ops import host as jhost
from optical_flow_tpu.ops import resize as jresize
from optical_flow_tpu.parallel import corpus as jcorpus
from optical_flow_tpu.pipeline import extractor as jextractor
from optical_flow_tpu.utils.config import ExtractorConfig as JaxExtractorConfig
from optical_flow_tpu_torch.cli import optical_flow as tcli
from optical_flow_tpu_torch.io import sidecar
from optical_flow_tpu_torch.oracle.synthetic import smooth_texture_pair
from optical_flow_tpu_torch.ops import host
from optical_flow_tpu_torch.ops import resize
from optical_flow_tpu_torch.parallel import corpus
from optical_flow_tpu_torch.pipeline import extractor
from optical_flow_tpu_torch.utils.config import ExtractorConfig

from test_torch_visualizer import assert_parser_matches_jax

VID = "vid"


def _video(root, videoid, n_frames=40, seed=3):
    media = os.path.join(str(root), videoid, "media")
    os.makedirs(media, exist_ok=True)
    path = os.path.join(media, videoid + ".mp4")
    write_synthetic_video(path, n_frames=n_frames, h=96, w=128, fps=25.0, seed=seed)
    return path


def _outputs(root, videoid=VID):
    d = os.path.join(str(root), videoid, "opticalflow")
    with open(os.path.join(d, f"{videoid}.csv"), "rb") as f:
        csv = f.read()
    with open(os.path.join(d, ".done"), "rb") as f:
        done = f.read()
    return csv, done


def _parse_csv(csv: bytes):
    start, end, mags = csv.decode().split("\t")
    return int(start), int(end), np.asarray([float(m) for m in mags.split(" ")])


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """One 40-frame synthetic video through the JAX run_corpus on one
    device (no data-parallel mesh over the suite's 8 CPU devices)."""
    root = tmp_path_factory.mktemp("jax_corpus")
    _video(root, VID)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OFT_DISABLE_MESH", "1")
        jextractor._dp_mesh.cache_clear()
        try:
            assert jextractor.run_corpus(str(root), [VID], JaxExtractorConfig()) == []
        finally:
            jextractor._dp_mesh.cache_clear()
    return _outputs(root)


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    """The same video through the port's CLI on the CPU."""
    root = tmp_path_factory.mktemp("port_corpus")
    _video(root, VID)
    tcli.main([str(root), VID, "--device", "cpu"])
    return root


@pytest.mark.parametrize("tot,fps,step_ms,window_ms", [
    (40, 25.0, 300, 300), (1000, 29.97, 300, 600), (7, 25.0, 300, 100),
    (250, 24.0, 1000, 300), (1, 25.0, 300, 300)])
def test_window_schedule_matches_jax(tot, fps, step_ms, window_ms):
    assert (extractor._window_schedule(tot, fps, step_ms, window_ms)
            == jextractor._window_schedule(tot, fps, step_ms, window_ms))


def test_window_schedule_rejects_a_sub_frame_step():
    with pytest.raises(ValueError):
        extractor._window_schedule(40, 25.0, 10, 300)


@pytest.mark.parametrize("pct", [5, 50, 95])
def test_scale_magnitudes_matches_jax(pct):
    mags = np.random.default_rng(pct).gamma(2.0, 300.0, 57).tolist()
    got = extractor.scale_magnitudes(mags, pct)
    assert got == jextractor.scale_magnitudes(mags, pct)
    assert all(0.0 <= m <= 100.0 for m in got)


def test_sidecar_bytes_match_jax(tmp_path):
    for mod, name in ((sidecar, "port"), (jsidecar, "jax")):
        d = tmp_path / name
        d.mkdir()
        mod.write_mag_to_csv(str(d / "v.csv"), [np.float64(12.5), 100.0, 0.0],
                             [0, 1480])
        mod.DoneSentinel(str(d), ExtractorConfig().done_version).mark_done()
        ckpt = mod.ShotProgress(str(d / "v.progress"), ExtractorConfig().done_version)
        ckpt.record(0, 0, 3, 1234.5)
        ckpt.record(1, 4, 10, 99.25)
        ckpt.close()
    for f in ("v.csv", ".done", "v.progress"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    done = sidecar.DoneSentinel(str(tmp_path / "port"), ExtractorConfig().done_version)
    assert done.is_done()
    assert not sidecar.DoneSentinel(str(tmp_path / "port"),
                                    ExtractorConfig(step_size=600).done_version).is_done()
    progress = sidecar.ShotProgress(str(tmp_path / "port" / "v.progress"),
                                    ExtractorConfig().done_version)
    assert progress.load() == {0: (0, 3, 1234.5), 1: (4, 10, 99.25)}


@pytest.mark.parametrize("h,w,width", [(96, 128, 129), (720, 1280, 129),
                                       (1080, 1920, 320), (37, 53, 20), (50, 60, 60)])
def test_resize_gray_host_matches_jax(h, w, width):
    frame = np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert (resize.aspect_preserving_size(h, w, width)
            == jresize.aspect_preserving_size(h, w, width))
    np.testing.assert_array_equal(host.resize_gray_host(frame, width),
                                  jhost.resize_gray_host(frame, width))
    dw, dh = resize.aspect_preserving_size(h, w, width)
    np.testing.assert_array_equal(host.resize_u8_host(frame[..., 1], dw, dh),
                                  jhost.resize_u8_host(frame[..., 1], dw, dh))


def test_shard_videoids_matches_jax():
    ids = [f"v{i}" for i in range(11)]
    for n in (1, 2, 3, 11, 12):
        shards = [corpus.shard_videoids(ids, k, n) for k in range(n)]
        assert shards == [jcorpus.shard_videoids(ids, k, n) for k in range(n)]
        assert sorted(sum(shards, [])) == sorted(ids)
    for bad in ((0, 0), (2, 2), (-1, 3)):
        with pytest.raises(ValueError):
            corpus.shard_videoids(ids, *bad)


def _sequence(n, h=40, w=56):
    f1, f2 = smooth_texture_pair(h, w, (1, 2))
    return [(i, f1 if i % 2 == 0 else f2) for i in range(n)]


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_extract_frames_equals_the_pairs(chunk):
    """Every window's sum equals magnitude_sums of its pair, in any
    chunking, and reaches on_result in window order."""
    seq = _sequence(12)
    windows = list(enumerate([(0, 3), (2, 5), (4, 8), (6, 9), (9, 11)]))
    got = []
    res = extractor.extract_frames(seq, windows, ExtractorConfig(), chunk_size=chunk,
                                   device="cpu", on_result=lambda *r: got.append(r))
    frames = dict(seq)
    prev = np.stack([frames[s] for _, (s, e) in windows])
    nxt = np.stack([frames[e] for _, (s, e) in windows])
    ref = extractor.magnitude_sums(prev, nxt, device="cpu").tolist()
    assert res == {i: (s, e, v) for (i, (s, e)), v in zip(windows, ref)}
    assert got == [(i, s, e, v) for (i, (s, e)), v in zip(windows, ref)]


def test_extract_frames_stops_at_a_failed_read():
    """The reference's early break: windows whose frames were not both
    decoded before the first failed read are dropped."""
    seq = _sequence(12)
    seq[7] = (7, None)
    windows = list(enumerate([(0, 3), (2, 5), (4, 8), (6, 9)]))
    res = extractor.extract_frames(seq, windows, ExtractorConfig(), chunk_size=2,
                                   device="cpu")
    assert sorted(res) == [0, 1]


def test_cli_parser_matches_jax():
    from optical_flow_tpu.cli import optical_flow as jcli
    argv = ["/data", "a", "b", "--frame_width", "0", "--step_size", "600",
            "--top_percentile", "10", "--force_run", "True", "--robust",
            "--resume", "--num_workers", "2", "--worker_index", "1"]
    assert_parser_matches_jax(tcli.build_parser(), jcli.build_parser(), argv)


IDS = [f"v{i}" for i in range(8)]


def _cli_shard(monkeypatch, env, argv):
    """The videoids the port's CLI hands run_corpus under `env`."""
    for key in ("OFT_COORDINATOR_ADDRESS", "OFT_NUM_PROCESSES", "OFT_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    seen = []
    monkeypatch.setattr(tcli, "run_corpus",
                        lambda root, ids, *a, **k: seen.append(list(ids)))
    tcli.main(["/nonexistent", *IDS, "--device", "cpu", *argv])
    return seen[0]


MULTI_HOST = {"OFT_COORDINATOR_ADDRESS": "localhost:9801", "OFT_NUM_PROCESSES": "3",
              "OFT_PROCESS_ID": "1"}


def test_maybe_init_distributed_reads_the_jax_environment(monkeypatch):
    for key in MULTI_HOST:
        monkeypatch.delenv(key, raising=False)
    assert corpus.maybe_init_distributed() == (0, 1)
    for key, value in MULTI_HOST.items():
        monkeypatch.setenv(key, value)
    assert corpus.maybe_init_distributed() == (1, 3)


@pytest.mark.parametrize("env,argv,expected", [
    ({}, [], IDS),
    (MULTI_HOST, [], IDS[1::3]),                                   # JAX's shard
    (MULTI_HOST, ["--num_workers", "2", "--worker_index", "0"], IDS[0::2]),
    ({"OFT_NUM_PROCESSES": "3", "OFT_PROCESS_ID": "1"}, [], IDS),  # no address
])
def test_cli_shards_by_process_as_jax(monkeypatch, env, argv, expected):
    """With the multi-host variables set, each process takes the shard
    JAX's CLI gives it (`shard_videoids(ids, pid, nproc)`); an explicit
    --num_workers wins."""
    got = _cli_shard(monkeypatch, env, argv)
    assert got == expected
    if env == MULTI_HOST and not argv:
        assert got == jcorpus.shard_videoids(IDS, 1, 3)


def test_cli_matches_jax_run_corpus(jax_corpus, port_corpus):
    """`.done` bytes identical; the CSV's timestamps identical and its
    magnitudes within 0.01."""
    csv, done = _outputs(port_corpus)
    jax_csv, jax_done = jax_corpus
    assert done == jax_done == ExtractorConfig().done_version.encode()
    start, end, mags = _parse_csv(csv)
    jstart, jend, jmags = _parse_csv(jax_csv)
    assert (start, end) == (jstart, jend)
    assert mags.shape == jmags.shape and len(mags) >= 5
    np.testing.assert_allclose(mags, jmags, atol=0.01, rtol=0)


def test_second_run_is_already_done_and_force_run_reruns(port_corpus, monkeypatch):
    csv, _ = _outputs(port_corpus)
    logged, runs = [], []
    monkeypatch.setattr(extractor.logger, "info", lambda msg, *a: logged.append(msg % a))
    real = extractor.extract_video
    monkeypatch.setattr(extractor, "extract_video",
                        lambda *a, **k: runs.append(1) or real(*a, **k))
    tcli.main([str(port_corpus), VID, "--device", "cpu"])
    assert "optical flow was already done" in logged and runs == []
    tcli.main([str(port_corpus), VID, "--device", "cpu", "--force_run", "true"])
    assert runs == []                    # a string compare, as in the reference
    tcli.main([str(port_corpus), VID, "--device", "cpu", "--force_run", "True"])
    assert runs == [1]
    assert _outputs(port_corpus)[0] == csv


def test_resume_gives_the_fresh_csv(port_corpus, tmp_path, monkeypatch):
    """A run killed after some chunks landed resumes from its checkpoint:
    only the tail is decoded again, and the CSV is byte-identical to the
    fresh run's."""
    fresh, _ = _outputs(port_corpus)
    _video(tmp_path, VID)
    monkeypatch.setattr(extractor, "pair_chunk_for", lambda *a, **k: 1)
    real = extractor._magnitude_sums
    calls = []

    def dying(*a, **k):
        calls.append(1)
        if len(calls) >= 5:
            raise RuntimeError("injected kill")
        return real(*a, **k)

    monkeypatch.setattr(extractor, "_magnitude_sums", dying)
    argv = [str(tmp_path), VID, "--device", "cpu", "--resume"]
    with pytest.raises(RuntimeError, match="injected kill"):
        tcli.main(argv)
    progress = tmp_path / VID / "opticalflow" / f"{VID}.progress"
    assert len(sidecar.ShotProgress(str(progress), ExtractorConfig().done_version).load()) == 2
    monkeypatch.setattr(extractor, "_magnitude_sums", real)
    tcli.main(argv)
    assert extractor.LAST_RUN_COUNTERS["frames_decoded"] == 8     # 4 windows of 6
    assert _outputs(tmp_path)[0] == fresh
    assert not progress.exists()


def test_robust_skips_a_bad_video_and_fail_fast_raises(tmp_path):
    _video(tmp_path, "good", n_frames=16)
    os.makedirs(tmp_path / "bad" / "media")
    (tmp_path / "bad" / "media" / "bad.mp4").write_bytes(b"not a video")
    cfg = ExtractorConfig()
    assert extractor.run_corpus(str(tmp_path), ["bad", "good"], cfg, robust=True,
                                device="cpu") == ["bad"]
    assert (tmp_path / "good" / "opticalflow" / "good.csv").is_file()
    with pytest.raises(IOError):
        extractor.run_corpus(str(tmp_path), ["bad"], cfg, device="cpu")


def test_vfr_video_is_always_skipped(tmp_path):
    from optical_flow_tpu_torch.oracle.mp4edit import patch_vfr
    from optical_flow_tpu_torch.oracle.synthetic import write_synthetic_video as port_writer

    _video(tmp_path, "good", n_frames=16)
    os.makedirs(tmp_path / "base")
    base = str(tmp_path / "base" / "b.mp4")
    port_writer(base, n_frames=16, h=96, w=128, fps=25.0, seed=3)
    os.makedirs(tmp_path / "vfr" / "media")
    patch_vfr(base, str(tmp_path / "vfr" / "media" / "vfr.mp4"))
    failures = extractor.run_corpus(str(tmp_path), ["vfr", "good"], ExtractorConfig(),
                                    device="cpu")          # robust=False
    assert failures == ["vfr"]
    assert (tmp_path / "good" / "opticalflow" / "good.csv").is_file()
    assert not (tmp_path / "vfr" / "opticalflow" / "vfr.csv").exists()


@pytest.mark.parametrize("dx", [0, 3, -5, 28])
def test_translating_clip_crops_the_pair_texture(dx):
    """chip_smoke.py's clip: a frame at offset dx is the JAX pair's second
    frame at shift (0, dx), and offset 0 its first."""
    from optical_flow_tpu.oracle.synthetic import smooth_texture_pair as jax_pair
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip

    f0, fdx = translating_clip(40, 56, [0, dx])
    f1, f2 = jax_pair(40, 56, (0, dx))
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(fdx, f2)
