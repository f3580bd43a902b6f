"""The port's import hygiene and wrapper contract, on a machine without a
card: importing every port module (and chip_smoke.py as a module) pulls
in neither JAX nor the JAX package and initialises no CUDA context; the
wrappers, the flow and BGR entries and the visualizer's device loop
launch nothing for CPU tensors; the kernel build command targets sm_90a
without FMA contraction."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

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
    from optical_flow_tpu_torch.kernels.fused_iterate import update_flow, update_flow_fused
    from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
    from optical_flow_tpu_torch.models.farneback.flow import (
        calc_flow, calc_flow_batched, calc_flow_bgr_batched,
        calc_flow_bgr_chain_batched, calc_flow_chain_batched)
    from optical_flow_tpu_torch.utils.config import FarnebackConfig
    from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums
    from optical_flow_tpu_torch.pipeline.visualizer import visualize_frames
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
    magnitude_sums(img[:1].numpy(), img[1:].numpy())
    flow_to_bgr_planar(torch.ones((2, 2, 20, 32)))
    calc_flow_chain_batched(img)
    calc_flow_bgr_batched(img[:1], img[1:])
    calc_flow_bgr_chain_batched(img)
    visualize_frames([(0.0, img[0]), (1.0, img[1])], lambda pos, bgr: None,
                     chunk_size=1)
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
                             "K6": 0}


def test_no_jax_import_in_port_sources():
    for path in list((REPO / "optical_flow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "optical_flow_tpu"), (
                    f"{path}: {line}")


def test_build_command_targets_sm90a_without_fma():
    from optical_flow_tpu_torch.kernels import _build
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name, Path("/nonexistent/lib.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--fmad=false" in cmd
        assert "-shared" in cmd and cmd[-1].endswith(f"csrc/{name}.cu")
        assert (_build.CSRC / f"{name}.cu").exists()
    assert _build.build_dir().parent == _build.BUILD_ROOT


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
