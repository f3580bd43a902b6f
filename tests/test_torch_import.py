"""The port's import hygiene and wrapper contract, on a machine without a
card: importing every port module (and chip_smoke.py as a module) pulls
in neither JAX nor the JAX package and initialises no CUDA context; the
wrappers, the flow and BGR entries, the visualizer's and the extractor's
device loops, the corpus loop, both CLIs, the self test and the warmers
launch nothing for CPU tensors or device="cpu"; every entry raises
without a card unless asked for the CPU; the kernel build command targets sm_90a without FMA
contraction."""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import torch
    import optical_flow_tpu_torch as pkg
    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in mods:
        importlib.import_module(name)
    import chip_smoke
    from optical_flow_tpu_torch import kernels
    from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
    from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
    from optical_flow_tpu_torch.kernels.polyexp import poly_exp
    from optical_flow_tpu_torch.kernels.update_gather import update_blur, update_matrices
    from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
    from optical_flow_tpu_torch.kernels.fused_iterate import (
        update_flow, update_flow_fused, update_flow_fused_poly)
    from optical_flow_tpu_torch.kernels.update_gather import update_blur_poly
    from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
    from optical_flow_tpu_torch.models.farneback.flow import (
        calc_flow, calc_flow_batched, calc_flow_bgr_batched,
        calc_flow_bgr_chain_batched, calc_flow_chain_batched)
    from optical_flow_tpu_torch.utils.config import FarnebackConfig
    from optical_flow_tpu_torch.pipeline.extractor import (
        extract_frames, magnitude_sums, run_corpus)
    from optical_flow_tpu_torch.pipeline.visualizer import visualize_frames
    from optical_flow_tpu_torch.cli import optical_flow as extractor_cli
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    img = torch.zeros((2, 40, 64), dtype=torch.uint8)
    lv = gauss_resize(img, [0.25, 0.5, 0.25], 32, 20)
    R = poly_exp(lv, 5, 1.2)
    R0 = poly_exp(img, 5, 1.2, pre_taps=[0.25, 0.5, 0.25])
    flow = torch.zeros((1, 2, 20, 32))
    update_blur(R[:1], R[1:], flow, 15)
    update_flow_fused(R[:1], R[1:], flow, 15, 3)
    blur_solve(update_matrices(R[:1], R[1:], flow), 15, True)
    update_flow(R[:1], R[1:], flow, 63, 2, True)
    update_flow(R[:1], R[1:], flow, 15, 2, True)
    gaussian_blur(img, [0.25, 0.5, 0.25])
    calc_flow_batched(img[:1], img[1:], FarnebackConfig(levels=5, poly_n=11))
    calc_flow_batched(img[:1], img[1:])
    calc_flow(img[0], img[1], FarnebackConfig(flags=260), torch.zeros((40, 64, 2)))
    magnitude_sums(img[:1].numpy(), img[1:].numpy(), device="cpu")
    update_blur_poly(img[:1], img[1:], torch.zeros((1, 2, 40, 64)), 15, True, 5, 1.2,
                     [0.25, 0.5, 0.25])
    update_flow_fused_poly(lv[:1], lv[1:], flow, 15, 2, poly_n=5, poly_sigma=1.2)
    extract_frames([(0, img[0].numpy()), (3, img[1].numpy())], [(0, (0, 3))],
                   ExtractorConfig(), chunk_size=2, device="cpu")
    run_corpus("/nonexistent", [], ExtractorConfig(), device="cpu")
    extractor_cli.main(["/nonexistent", "--device", "cpu"])
    flow_to_bgr_planar(torch.ones((2, 2, 20, 32)))
    calc_flow_chain_batched(img)
    calc_flow_bgr_batched(img[:1], img[1:])
    calc_flow_bgr_chain_batched(img)
    visualize_frames([(0.0, img[0]), (1.0, img[1])], lambda pos, bgr: None,
                     chunk_size=1, device="cpu")
    from optical_flow_tpu_torch.utils.selftest import run_selftest
    from optical_flow_tpu_torch.utils.warmup import warmup_extractor, warmup_visualizer
    assert run_selftest(device="cpu", quick=True)["ok"]
    warmup_extractor(24, 32, ExtractorConfig(frame_width=32), device="cpu")
    warmup_visualizer(24, 32, device="cpu")
    print(json.dumps({
        "modules": mods,
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
        "jax_package": sorted(m for m in sys.modules
                              if m.split(".")[0] == "optical_flow_tpu"),
        "cuda_initialized": torch.cuda.is_initialized(),
        "launches": kernels.LAUNCHES,
    }))
""")


def _env(**extra):
    """This process's environment with no card visible and no inherited
    PYTHONPATH."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return {**env, "CUDA_VISIBLE_DEVICES": "", **extra}


def _probe():
    import json
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env(PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_cuda():
    r = _probe()
    assert len(r["modules"]) >= 30
    assert r["jax"] == []
    assert r["jax_package"] == []
    assert r["cuda_initialized"] is False
    assert r["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5a": 0, "K5b": 0,
                             "K6": 0, "K7": 0}


_SUBPACKAGE = textwrap.dedent("""
    import importlib, json, sys
    import torch
    mod = importlib.import_module(sys.argv[1])
    names = {n: type(getattr(mod, n)).__name__ for n in getattr(mod, "__all__", [])}
    print(json.dumps({
        "names": names,
        "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
        "jax_package": sorted(m for m in sys.modules
                              if m.split(".")[0] == "optical_flow_tpu"),
        "cuda_initialized": torch.cuda.is_initialized(),
    }))
""")


@pytest.mark.parametrize("sub", ["", ".models", ".models.farneback", ".ops", ".pipeline",
                                 ".parallel", ".utils", ".oracle", ".io", ".cli",
                                 ".kernels"])
def test_subpackage_import_alone_is_clean(sub):
    """Each subpackage, imported first in a fresh interpreter and its
    exported names resolved, loads neither JAX nor the JAX package and
    starts no CUDA context."""
    import json
    out = subprocess.run([sys.executable, "-c", _SUBPACKAGE, "optical_flow_tpu_torch" + sub],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=_env(PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["jax"] == [] and r["jax_package"] == []
    assert r["cuda_initialized"] is False
    if sub not in (".cli", ".kernels"):
        assert r["names"], "the subpackage exports nothing"


def test_no_jax_import_in_port_sources():
    for path in list((REPO / "optical_flow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "optical_flow_tpu"), (
                    f"{path}: {line}")


def test_build_command_targets_sm90a_without_fma():
    from optical_flow_tpu_torch.kernels import _build
    from optical_flow_tpu_torch.utils.compile_cache import kernel_cache_dir
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name, Path("/nonexistent/lib.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--fmad=false" in cmd
        assert "-shared" in cmd and cmd[-1].endswith(f"csrc/{name}.cu")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.build_dir().parent == kernel_cache_dir()


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# Each entry on host input with no device named, where no card is visible
_ENTRIES = textwrap.dedent("""
    import json
    import numpy as np
    img = np.zeros((2, 40, 64), np.uint8)
    from optical_flow_tpu_torch.models.farneback import flow
    from optical_flow_tpu_torch.pipeline import extractor, visualizer
    from optical_flow_tpu_torch.cli import optical_flow, visualize_optical_flow
    from optical_flow_tpu_torch.utils import selftest, validate, warmup
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    calls = {
        "run_selftest": lambda: selftest.run_selftest(quick=True),
        "warmup_flow": lambda: warmup.warmup_flow(40, 64),
        "warmup_extractor": lambda: warmup.warmup_extractor(40, 64),
        "warmup_visualizer": lambda: warmup.warmup_visualizer(40, 64),
        "calc_flow": lambda: flow.calc_flow(img[0], img[1]),
        "calc_flow_batched": lambda: flow.calc_flow_batched(img[:1], img[1:]),
        "calc_flow_chain_batched": lambda: flow.calc_flow_chain_batched(img),
        "calc_flow_bgr_batched": lambda: flow.calc_flow_bgr_batched(img[:1], img[1:]),
        "calc_flow_bgr_chain_batched": lambda: flow.calc_flow_bgr_chain_batched(img),
        "magnitude_sums": lambda: extractor.magnitude_sums(img[:1], img[1:]),
        "sampled_epe": lambda: validate.sampled_epe(img[0], img[1]),
        "extract_frames": lambda: extractor.extract_frames(
            [(0, img[0])], [(0, (0, 0))], ExtractorConfig(), chunk_size=1),
        "extract_video": lambda: extractor.extract_video("/nonexistent.mp4",
                                                         ExtractorConfig()),
        "run_corpus": lambda: extractor.run_corpus("/nonexistent", ["v"],
                                                   ExtractorConfig(), robust=True),
        "visualize_frames": lambda: visualizer.visualize_frames(
            [(0.0, img[0]), (1.0, img[1])], lambda pos, bgr: None, chunk_size=1),
        "visualize_shot": lambda: visualizer.visualize_shot("/nonexistent.mp4",
                                                            "/nonexistent", 0, 1000),
        "optical_flow_cli": lambda: optical_flow.main(["/nonexistent", "v", "--robust"]),
        "visualize_optical_flow_cli": lambda: visualize_optical_flow.main(
            ["/nonexistent.mp4", "/nonexistent", "0", "1000"]),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = None
        except Exception as e:
            raised[name] = [type(e).__name__, str(e)]
    print(json.dumps(raised))
""")


@functools.lru_cache(maxsize=None)
def _entries_without_a_card():
    import json
    out = subprocess.run([sys.executable, "-c", _ENTRIES], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env(PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("entry", [
    "calc_flow", "calc_flow_batched", "calc_flow_chain_batched",
    "calc_flow_bgr_batched", "calc_flow_bgr_chain_batched", "magnitude_sums",
    "sampled_epe", "extract_frames", "extract_video", "run_corpus",
    "visualize_frames", "visualize_shot", "optical_flow_cli",
    "visualize_optical_flow_cli", "run_selftest", "warmup_flow", "warmup_extractor",
    "warmup_visualizer"])
def test_entry_raises_without_a_card(entry):
    """Host input with no device named goes to the current card; with no
    card visible the entry raises RuntimeError (before any video is
    opened: run_corpus does not log-skip it as a robust failure) instead
    of running on the CPU unasked."""
    raised = _entries_without_a_card()[entry]
    assert raised is not None and raised[0] == "RuntimeError", raised
    assert "no CUDA card" in raised[1]
