#!/usr/bin/env python3
"""The control of each cell's check, and the readings its limits are set
from.  Not part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--program]

Runs the cell's set-up, a window of the first `check_among` units of its
traffic (the units the check draws from), and the check, once a seed, in
one process, and prints each run's compared numbers as a JSON line.  By
default the system under test is the control: the plain reference
(`portbench/reference/`) computed in bfloat16, the nearest precision below
the float32 the configurations state, put in the program's place; the
check has to fail it.  With --program it is the port, as a run drives it:
the readings of sound runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.reference import colorize as ref_colorize  # noqa: E402
from portbench.reference import extractor as ref_extractor  # noqa: E402
from portbench.reference import farneback as ref_farneback  # noqa: E402


def _chunk(h: int, w: int, device=None) -> int:
    return max(1, min(128, (32 << 20) // (h * w)))


class Control:
    """The reference at `dtype` with the entries' signatures."""

    def __init__(self, cfg: dict, dtype=torch.bfloat16):
        self.cfg, self.dtype = cfg, dtype
        self.metrics = SimpleNamespace(stages={}, counters={})
        self.pair_chunk_for = _chunk
        self.window_schedule = ref_extractor.window_schedule
        self.scale_magnitudes = ref_extractor.scale_magnitudes
        self.mag_csv_line = ref_extractor.csv_line

    def FarnebackConfig(self, **kw):
        return kw

    def ExtractorConfig(self, **kw):
        return SimpleNamespace(**kw)

    def _device(self, device):
        return torch.device("cuda", 0) if device is None else torch.device(device)

    def visualize_frames(self, frames, write, config, *, chunk_size, device, metrics):
        dev = self._device(device)
        frames = list(frames)
        n = 0
        for j in range(1, len(frames), chunk_size):
            part = frames[j - 1:j + chunk_size]
            chain = torch.as_tensor(np.stack([f for _, f in part])).to(dev)
            flow = ref_farneback.flow_pyramid(chain, self.cfg["farneback"], True, self.dtype)
            bgr = ref_colorize.flow_to_bgr(flow).cpu().numpy()
            for (pos, _), img in zip(part[1:], bgr):
                write(pos, img)
                n += 1
        return n

    def extract_frames(self, frames, windows, config, *, chunk_size, device, metrics,
                       on_result=None):
        dev = self._device(device)
        live = dict(frames)
        out = {}
        for j in range(0, len(windows), chunk_size):
            part = windows[j:j + chunk_size]
            both = torch.as_tensor(np.stack([live[s] for _, (s, _) in part]
                                            + [live[e] for _, (_, e) in part])).to(dev)
            flow = ref_farneback.flow_pyramid(both, self.cfg["farneback"], False, self.dtype)
            for (i, (s, e)), v in zip(part, ref_colorize.magnitude_sums(flow).cpu().tolist()):
                out[i] = (s, e, v)
                if on_result is not None:
                    on_result(i, s, e, v)
        return out

    def aggregate(self, results, tot, fps, step):
        idx = sorted(results)
        return ref_extractor.aggregate([results[i][2] for i in idx],
                                       [results[i][:2] for i in idx], tot, fps, step)


def readings(workload: str, seeds, program: bool, device="cuda:0", root: Path = ROOT) -> list:
    """One short run a seed: {seed, numbers, checked_units, seconds}."""
    _, wl, cfg, traffic = harness.find(root, workload)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(root, workload, seed, float("inf"), False, device=device,
                               program=None if program else Control(cfg),
                               max_units=traffic["check_among"])
        out.append({"workload": workload, "seed": seed,
                    "system": "program" if program else "control_bfloat16",
                    "correct": res["correct"],
                    "numbers": {k: v["value"] for k, v in res["checks"].items()},
                    "checked_units": res["setup"]["checked_units"],
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    os.environ["OFT_COMPILE_CACHE"] = str(ROOT / "portbench" / ".kernels")
    _, wl, _, _ = harness.find(ROOT, args.workload)
    device = "cuda:0" if wl["chips"] == 1 else None
    for row in readings(args.workload, args.seeds, args.program, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
