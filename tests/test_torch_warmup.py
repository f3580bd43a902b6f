"""The port's kernel cache, cold-start packs, warmers and NaN check, on
the CPU (no nvcc: the packs carry stand-in lib<name>.so files):

  * `kernel_cache_dir()`: OFT_COMPILE_CACHE, then
    ~/.cache/optical_flow_tpu_torch/kernels, with 0 disabling it (builds
    then go to a private temporary directory); `build_dir()` lies under
    it, never inside the package;
  * `pack_cache` / `unpack_cache` round-trip this tree's libraries; a
    pack of another source hash is refused and writes nothing; members
    with `/`, `..`, links or names outside `SOURCES` are not extracted;
    both refuse to run with the cache disabled;
  * the warmers run on the CPU at 24x32 with device="cpu" at the chunk
    `pair_chunk_for` gives and launch no kernel; the warmup CLI prints
    its JSON line;
  * `maybe_enable_debug_nans`: with OFT_DEBUG_NANS=1 the extractor's and
    the visualizer's device loops raise FloatingPointError for a chunk
    whose flow is NaN, naming its first frame; unset, no check is queued.
"""

import io
import json
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels import _build
from optical_flow_tpu_torch.pipeline import extractor, visualizer
from optical_flow_tpu_torch.pipeline.prefetch import dispatch_pairs, pair_chunk_for
from optical_flow_tpu_torch.utils import validate, warmup
from optical_flow_tpu_torch.utils.compile_cache import kernel_cache_dir
from optical_flow_tpu_torch.utils.config import ExtractorConfig

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "optical_flow_tpu_torch"


def test_kernel_cache_dir_order(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("OFT_COMPILE_CACHE", raising=False)
    default = tmp_path / "home" / ".cache" / "optical_flow_tpu_torch" / "kernels"
    assert kernel_cache_dir() == default
    assert _build.build_dir().parent == default
    assert PACKAGE not in _build.build_dir().parents
    monkeypatch.setenv("OFT_COMPILE_CACHE", str(tmp_path / "elsewhere"))
    assert kernel_cache_dir() == tmp_path / "elsewhere"
    assert _build.build_dir() == tmp_path / "elsewhere" / _build.source_hash()
    monkeypatch.setenv("OFT_COMPILE_CACHE", "0")
    assert kernel_cache_dir() is None
    private = _build.build_dir().parent
    assert private.is_dir() and private.name.startswith("optical_flow_tpu_torch_kernels_")
    assert _build.build_dir().parent == private            # one per process


def test_source_hash_covers_sources_headers_and_flags(monkeypatch):
    h = _build.source_hash()
    assert len(h) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(
        f.replace("sm_90a", "sm_90") for f in _build.NVCC_FLAGS))
    assert _build.source_hash() != h


@pytest.fixture
def cache(monkeypatch, tmp_path):
    """A shared cache in tmp_path holding stand-ins for this tree's
    built libraries."""
    monkeypatch.setenv("OFT_COMPILE_CACHE", str(tmp_path / "cache"))
    d = _build.build_dir()
    d.mkdir(parents=True)
    for name in _build.SOURCES:
        (d / f"lib{name}.so").write_bytes(f"built {name}".encode())
    (d / "ptxas_update_blur.so").write_bytes(b"not a library of the pack")
    return d


def test_build_finds_built_libraries_without_nvcc(cache):
    report = _build.build()
    assert report.nvcc_runs == 0 and report.seconds >= 0


def test_pack_round_trip(cache, tmp_path, monkeypatch):
    pack = tmp_path / "warm.tgz"
    assert warmup.pack_cache(str(pack)) == len(_build.SOURCES)
    with tarfile.open(pack) as tf:
        names = tf.getnames()
        manifest = json.load(tf.extractfile("manifest.json"))
    assert sorted(names) == sorted(["manifest.json"] + [f"lib{n}.so" for n in _build.SOURCES])
    assert manifest["hash"] == _build.source_hash() and manifest["arch"] == "sm_90a"
    monkeypatch.setenv("OFT_COMPILE_CACHE", str(tmp_path / "fresh"))
    assert warmup.unpack_cache(str(pack)) == len(_build.SOURCES)
    d = _build.build_dir()
    assert sorted(p.name for p in d.iterdir()) == sorted(f"lib{n}.so" for n in _build.SOURCES)
    for name in _build.SOURCES:
        assert (d / f"lib{name}.so").read_bytes() == f"built {name}".encode()
    assert _build.build().nvcc_runs == 0


def _tar(path, members, manifest):
    """A .tgz holding the manifest and `members`: (TarInfo, bytes or None)."""
    with tarfile.open(path, "w:gz") as tf:
        data = json.dumps(manifest).encode()
        info = tarfile.TarInfo("manifest.json")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
        for info, data in members:
            if data is None:
                tf.addfile(info)
            else:
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_unpack_refuses_another_hash(cache, tmp_path, monkeypatch):
    pack = tmp_path / "old.tgz"
    _tar(pack, [(tarfile.TarInfo("libgauss.so"), b"stale")],
         {"hash": "0123456789abcdef", "arch": "sm_90a"})
    monkeypatch.setenv("OFT_COMPILE_CACHE", str(tmp_path / "fresh"))
    with pytest.raises(ValueError, match="0123456789abcdef"):
        warmup.unpack_cache(str(pack))
    assert not _build.build_dir().exists()


def test_unpack_extracts_only_flat_library_files(cache, tmp_path, monkeypatch):
    pack = tmp_path / "odd.tgz"
    link = tarfile.TarInfo("libgauss.so")
    link.type, link.linkname = tarfile.SYMTYPE, "/etc/passwd"
    hard = tarfile.TarInfo("libcolorize.so")
    hard.type, hard.linkname = tarfile.LNKTYPE, "manifest.json"
    _tar(pack, [(tarfile.TarInfo("libpolyexp.so"), b"ok"),
                (tarfile.TarInfo("../libblur_solve.so"), b"escape"),
                (tarfile.TarInfo("/tmp/libupdate_blur.so"), b"absolute"),
                (tarfile.TarInfo("sub/libupdate_matrices.so"), b"nested"),
                (tarfile.TarInfo("libevil.so"), b"not a source"),
                (link, None), (hard, None)],
         {"hash": _build.source_hash(), "arch": "sm_90a"})
    monkeypatch.setenv("OFT_COMPILE_CACHE", str(tmp_path / "fresh"))
    assert warmup.unpack_cache(str(pack)) == 1
    d = _build.build_dir()
    assert [p.name for p in d.iterdir()] == ["libpolyexp.so"]
    assert not (tmp_path / "fresh" / "libblur_solve.so").exists()


def test_packs_need_the_shared_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("OFT_COMPILE_CACHE", "0")
    for call in (warmup.pack_cache, warmup.unpack_cache):
        with pytest.raises(RuntimeError, match="OFT_COMPILE_CACHE=0"):
            call(str(tmp_path / "x.tgz"))


def test_warmers_on_the_cpu_launch_no_kernel():
    kernels.reset_launches()
    ext = warmup.warmup_extractor(24, 32, device="cpu")
    assert ext["shape"] == [pair_chunk_for(96, 129), 96, 129]     # frame_width 129
    vis = warmup.warmup_visualizer(24, 32, device="cpu")
    assert vis["chunk"] == dispatch_pairs(24, 32, pair_chunk_for(24, 32))
    assert vis["shape"] == [vis["chunk"] + 1, 24, 32]
    flow = warmup.warmup_flow(24, 32, batch=3, device="cpu")
    assert flow["shape"] == [3, 24, 32]
    for info in (ext, vis, flow):
        assert info["peak_bytes"] is None and info["seconds"] > 0
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_warmers_need_a_card_unless_asked_for_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "optical_flow_tpu_torch.utils.warmup",
                          "--res", "32x24"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**env, "PYTHONPATH": str(REPO),
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "no CUDA card" in out.stderr


def test_warmup_cli_on_the_cpu(cache, tmp_path, capsys):
    assert warmup.main(["--res", "32x24", "--device", "cpu",
                        "--pack", str(tmp_path / "w.tgz")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cache"] == str(cache) and out["packed"] == len(_build.SOURCES)
    assert out["warmed"][0]["visualizer"]["shape"] == [
        dispatch_pairs(24, 32, pair_chunk_for(24, 32)) + 1, 24, 32]
    assert "nvcc_runs" not in out          # nothing is built for the CPU


SEQ = [(i, f) for i, f in enumerate(
    np.random.default_rng(0).integers(0, 256, (4, 24, 32), dtype=np.uint8))]
WINDOWS = [(0, (0, 1)), (1, (2, 3))]


def _poisoned(entry, calls, from_call):
    """`entry` whose flow holds a NaN in its last pair from its
    `from_call`-th call on."""
    def run(*a, **k):
        calls.append(1)
        flow = entry(*a, **k)
        if len(calls) >= from_call:
            flow = flow.clone()
            flow[-1, 3, 5, 0] = float("nan")
        return flow
    return run


@pytest.fixture
def nan_flow(monkeypatch):
    """The extractor's flow entry returns a NaN from its second chunk on,
    the visualizer's from its first; the calls each loop made."""
    calls = {"extractor": [], "visualizer": []}
    monkeypatch.setattr(extractor, "calc_flow_batched",
                        _poisoned(extractor.calc_flow_batched, calls["extractor"], 2))
    monkeypatch.setattr(visualizer, "calc_flow_chain_batched",
                        _poisoned(visualizer.calc_flow_chain_batched,
                                  calls["visualizer"], 1))
    monkeypatch.setattr(validate, "DEBUG_NANS", False)
    return calls


def test_debug_nans_raises_in_both_device_loops(nan_flow, monkeypatch):
    monkeypatch.setenv("OFT_DEBUG_NANS", "1")
    assert validate.maybe_enable_debug_nans() is True
    with pytest.raises(FloatingPointError, match="from frame 2"):
        extractor.extract_frames(SEQ, WINDOWS, ExtractorConfig(), chunk_size=1,
                                 device="cpu")
    with pytest.raises(FloatingPointError, match="from frame 0"):
        visualizer.visualize_frames(SEQ, lambda pos, bgr: None, chunk_size=3,
                                    device="cpu")
    assert len(nan_flow["extractor"]) == 2 and len(nan_flow["visualizer"]) == 1


def test_debug_nans_off_checks_nothing(nan_flow, monkeypatch):
    monkeypatch.delenv("OFT_DEBUG_NANS", raising=False)
    assert validate.maybe_enable_debug_nans() is False
    got = extractor.extract_frames(SEQ, WINDOWS, ExtractorConfig(), chunk_size=1,
                                   device="cpu")
    assert np.isnan(got[1][2]) and not np.isnan(got[0][2])
    assert visualizer.visualize_frames(SEQ, lambda pos, bgr: None, chunk_size=3,
                                       device="cpu") == 3
    assert len(nan_flow["extractor"]) == 2 and len(nan_flow["visualizer"]) == 1


def test_debug_nans_names_the_frame_index_not_its_position(monkeypatch):
    """The visualizer's error names the chunk's first frame by its index
    in the stream; its position (a float frame number) comes beside it."""
    calls = []
    monkeypatch.setattr(visualizer, "calc_flow_chain_batched",
                        _poisoned(visualizer.calc_flow_chain_batched, calls, 2))
    monkeypatch.setattr(validate, "DEBUG_NANS", True)
    seq = [(10.5 + 2 * i, f) for i, (_, f) in enumerate(SEQ)]
    written = []
    # chunks of pairs (1, 2) and (3,): the second chunk starts at frame 2
    with pytest.raises(FloatingPointError, match=r"from frame 2 \(position 14\.5;"):
        visualizer.visualize_frames(seq, lambda pos, bgr: written.append(pos),
                                    chunk_size=2, device="cpu")
    assert written == [12.5, 14.5] and len(calls) == 2


def test_debug_nans_with_finite_flow_changes_nothing(monkeypatch):
    monkeypatch.setattr(validate, "DEBUG_NANS", True)
    on = extractor.extract_frames(SEQ, WINDOWS, ExtractorConfig(), chunk_size=2, device="cpu")
    got = []
    visualizer.visualize_frames(SEQ, lambda pos, bgr: got.append(bgr), chunk_size=2,
                                device="cpu")
    monkeypatch.setattr(validate, "DEBUG_NANS", False)
    assert on == extractor.extract_frames(SEQ, WINDOWS, ExtractorConfig(), chunk_size=2,
                                          device="cpu")
    ref = []
    visualizer.visualize_frames(SEQ, lambda pos, bgr: ref.append(bgr), chunk_size=2,
                                device="cpu")
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))


@pytest.mark.parametrize("cli", ["optical_flow", "visualize_optical_flow"])
def test_both_clis_enable_the_check(cli, monkeypatch):
    """Each CLI calls maybe_enable_debug_nans before it runs anything."""
    import importlib
    mod = importlib.import_module(f"optical_flow_tpu_torch.cli.{cli}")
    called = []
    monkeypatch.setattr(mod, "maybe_enable_debug_nans", lambda: called.append(1))
    monkeypatch.setattr(mod, "run_corpus" if cli == "optical_flow" else "visualize_shot",
                        lambda *a, **k: called.append(2))
    argv = (["/nonexistent", "--device", "cpu"] if cli == "optical_flow"
            else ["/nonexistent.mp4", "/nonexistent", "0", "1000", "--device", "cpu"])
    mod.main(argv)
    assert called == [1, 2]
