"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files and new entries of BENCHMARK.json are
found by name; and nothing a run or the reference loads is JAX or the JAX
package, by whole top-level module names."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 3


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    os.unlink(root / "portbench" / "metrics")
    shutil.copytree(tiny.BENCH / "metrics", root / "portbench" / "metrics")
    (root / "portbench" / "metrics" / "visualizer.units_per_run.py").write_text(
        "def read(r):\n    return float(r.units)\n")
    cfg = json.loads((root / "portbench" / "configs" / "tiny_vis.json").read_text())
    cfg.update(name="tiny_vis_wide", frame_width=112)
    tiny.write(root, "configs", "tiny_vis_wide", cfg)
    tiny.write(root, "traffic", "tiny_pans", dict(tiny.SHOTS, stride=[2, 2]))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny_vis_wide.pans", "config": "tiny_vis_wide",
                              "traffic": "tiny_pans", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "visualizer.units_per_run", "unit": "units",
                              "better": "higher", "source": "host_clock",
                              "layer": "visualizer", "moves": "pairs_per_s",
                              "workloads": ["tiny_vis_wide.pans"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(root, "tiny_vis_wide.pans", SEED, 0.5, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["visualizer.units_per_run"]["value"] == out["attempted"] > 0
    assert list(out)[-1] == "checks"


def test_end_to_end_metrics_by_cell(tmp_path):
    root = tiny.make_root(tmp_path)
    vis = harness.run_cell(root, "tiny_vis.shots", SEED, 0.5, False, device="cpu")
    ext = harness.run_cell(root, "tiny_ext.videos", SEED, 0.5, False, device="cpu")
    assert set(vis["metrics"]) == {"pairs_per_s", "shot_p95_ms", "setup_s"}
    assert set(ext["metrics"]) == {"pairs_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in list(vis["metrics"].values()) + list(ext["metrics"].values()))


LOADS = """
import sys
sys.path.insert(0, {root!r})
{body}
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optical_flow_tpu'))
print(bad, 'optical_flow_tpu_torch' in sys.modules)
"""


def loads(body: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = LOADS.format(root=str(tiny.ROOT), body=body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(tiny.ROOT), timeout=300, check=True).stdout.split("\n")[-2]


def test_the_reference_loads_nothing_of_the_program():
    assert loads("import portbench.reference.farneback, portbench.reference.colorize, "
                 "portbench.reference.extractor") == "[] False"


@pytest.mark.parametrize("cell", ["tiny_vis.shots", "tiny_ext.videos"])
def test_a_run_loads_no_jax(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    body = ("import runpy\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            "runpy.run_path('portbench/run.py')\n"
            f"harness.run_cell(Path({str(root)!r}), {cell!r}, 5, 0.3, True, device='cpu')")
    assert loads(body) == "[] True"


def test_forbidden_names_are_whole(monkeypatch):
    for name in ("optical_flow_tpu_torch.x", "jaxtyping", "optical_flow_tpu.y", "jax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"optical_flow_tpu.y", "jax"} <= set(harness.forbidden_modules())
    assert not {"optical_flow_tpu_torch.x", "jaxtyping"} & set(harness.forbidden_modules())
