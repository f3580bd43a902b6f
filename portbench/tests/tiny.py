"""A checkout root in a temporary directory whose cells are the
benchmark's configurations at sizes a CPU test run can hold: the real
BENCHMARK.json's metrics, the real entries and metric readers (linked),
and small configuration and traffic files of their own."""

from __future__ import annotations

import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CELLS = {
    "tiny_vis.shots": ("tiny_vis", "tiny_shots", 1),
    "tiny_ext.videos": ("tiny_ext", "tiny_videos", 1),
}
SHOTS = {"unit": "shot", "seconds": {"dist": "uniform", "low": 0.6, "high": 2.0},
         "strata": 8, "stride": [1, 3], "warm": 2, "check_among": 3, "check_units": 2}
VIDEOS = {"unit": "video", "seconds": {"dist": "uniform", "low": 2.0, "high": 8.0},
          "strata": 8, "stride": [1, 1], "warm": 2, "check_among": 3, "check_units": 2}


def make_root(tmp: Path) -> Path:
    """The temporary root, ready for `harness.run_cell(root, <cell>, ...)`."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": k, "why": "a test"}
                         for n, (c, t, k) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            ext = all(w.startswith("extractor") for w in m["workloads"])
            m["workloads"] = ["tiny_ext.videos"] if ext else ["tiny_vis.shots"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    for d in ("configs", "traffic"):
        (tmp / "portbench" / d).mkdir(parents=True, exist_ok=True)
    for d in ("entries", "metrics"):
        os.symlink(BENCH / d, tmp / "portbench" / d)
    vis = json.loads((BENCH / "configs" / "visualizer_1080p.json").read_text())
    vis.update(name="tiny_vis", frame_height=64, frame_width=96, reference_block=4,
               pool_frames=24)
    ext = json.loads((BENCH / "configs" / "extractor_w129.json").read_text())
    ext.update(name="tiny_ext", reference_block=64, pool_frames=24)
    write(tmp, "configs", "tiny_vis", vis)
    write(tmp, "configs", "tiny_ext", ext)
    write(tmp, "traffic", "tiny_shots", SHOTS)
    write(tmp, "traffic", "tiny_videos", VIDEOS)
    return tmp


def write(root: Path, kind: str, name: str, data: dict) -> None:
    (root / "portbench" / kind / f"{name}.json").write_text(json.dumps(data))
