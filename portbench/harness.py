"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced window, the check against the reference, and the
result line.

Everything a cell is made of is found by name under the checkout's root:
the cell in `BENCHMARK.json`, its configuration in
`portbench/configs/<config>.json`, its traffic in
`portbench/traffic/<traffic>.json`, the loop that drives the
configuration's entry in `portbench/entries/<entry>.py`, and each
per-layer metric's reader in `portbench/metrics/<metric>.py`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from portbench import generator, trace, yardstick
from portbench.reference import farneback as ref_farneback

# top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optical_flow_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(root: Path, workload: str):
    """(the BENCHMARK.json spec, its workload entry, configuration, traffic)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    cfg = load_json(root / "portbench" / "configs" / f"{wl['config']}.json")
    traffic = load_json(root / "portbench" / "traffic" / f"{wl['traffic']}.json")
    return spec, wl, cfg, traffic


def load_module(path: Path):
    """A module from its file, whatever its name (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: Path, cfg: dict):
    return load_module(root / "portbench" / "entries" / f"{cfg['entry']}.py")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Reading:
    """What a metric's reader reads from one window: the units it ran
    (`runner.records`), set-up and window times, and in a traced window the
    trace, the port's launch count and stage times."""

    def __init__(self, runner, cfg: dict, setup_s: float, seconds: float, deadline: float,
                 tr=None, launches: int = 0, stages=None, devices=()):
        self.runner, self.cfg = runner, cfg
        self.setup_s, self.seconds, self.deadline = setup_s, seconds, deadline
        self.trace, self.launches, self.stages = tr, launches, stages or {}
        self.devices = list(devices)
        self.pairs = sum(r["pairs"] for r in runner.records)
        self.units = len(runner.records)

    def least_seconds(self) -> float:
        """The least time of every unit the window ran (`yardstick`)."""
        levels = yardstick.level_taps(ref_farneback.level_plan(
            self.runner.h, self.runner.w, self.cfg["farneback"]["levels"],
            self.cfg["farneback"]["pyr_scale"]))
        return sum(yardstick.least_seconds(c, levels, self.cfg["farneback"])[0]
                   for c in self.runner.chunks())

    def kernel_seconds(self) -> float:
        return sum(o.end - o.start for o in self.trace.kernels()) * 1e-9


def read_metrics(root: Path, specs: list, workload: str, reading: Reading) -> dict:
    """{name: {value, unit}} of each listed metric that applies to the cell
    and whose reader found something to read."""
    out = {}
    for m in specs:
        if workload not in m.get("workloads", [workload]):
            continue
        value = load_module(root / "portbench" / "metrics" / f"{m['name']}.py").read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool,
             device=None, program=None, t_start: float | None = None,
             max_units: float = float("inf")) -> dict:
    """One run of a cell; returns the result line as a dict.  device: the
    card the program runs on (None: every visible card, the program's own
    routing); program: the system under test, by default the entry's
    `Program()` (the control and the fault tests put another in its
    place); max_units: the window also ends after that many units."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec, wl, cfg, traffic = find(root, workload)
    # the worker's host threads: few, so that the host's other tenants
    # stall a parallel copy less
    torch.set_num_threads(cfg["host_threads"])
    mod = entry(root, cfg)
    build = None
    if program is None:
        program = mod.Program()
        if torch.device(device or "cuda").type == "cuda":
            from optical_flow_tpu_torch.kernels import _build
            build = _build.build()
    runner = mod.Runner(cfg, traffic, seed, program, device)
    runner.setup()
    cards = list(range(wl["chips"])) if runner.card.type == "cuda" else []
    for d in cards:
        torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start

    from optical_flow_tpu_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    program.metrics.stages.clear()
    program.metrics.counters.clear()
    units = generator.units(traffic, seed)
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        prof = profile(activities=acts)
        prof.__enter__()
    gc_s = [0.0, 0.0]               # seconds in the collector, and its last start

    def gc_clock(phase, info):
        now = time.perf_counter()
        if phase == "start":
            gc_s[1] = now
        else:
            gc_s[0] += now - gc_s[1]

    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.profiler.record_function(trace.WINDOW):
        u = 0
        while time.perf_counter() < deadline and u < max_units:
            runner.run_unit(next(units), keep=u in runner.keep, deadline=deadline)
            u += 1
        for d in cards:
            torch.cuda.synchronize(d)
    t_end = time.perf_counter()
    gc.callbacks.remove(gc_clock)
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = sum(LAUNCHES.values())
    stages = {k: (v.seconds, v.count) for k, v in program.metrics.stages.items()}
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)

    out = {"correct": False, "attempted": u, "failed": 0, "metrics": {}}
    device_info = {"platform": "gpu" if cards else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cards else "cpu",
                   "count": len(cards), "memory_peak_bytes": peak}
    if traced:
        tr = trace.read(prof) if cards else None
        del prof
        reading = Reading(runner, cfg, setup_s, seconds, deadline, tr, launches, stages, cards)
        out["metrics"] = read_metrics(root, spec["per_layer"], workload, reading)
        if tr is not None:
            busy = trace.busy_by_device(tr, cards)
            device_info["busy_s"] = sum(busy.values()) / len(busy)
            device_info["window_s"] = tr.window_s
            out["breakdown"] = trace.breakdown(tr, cards[0])
    else:
        reading = Reading(runner, cfg, setup_s, seconds, deadline)
        out["metrics"] = read_metrics(root, spec["end_to_end"], workload, reading)
    if cards:
        torch.cuda.empty_cache()
    result = runner.check()
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in result["numbers"].items()}
    out["correct"] = (result["checked_units"] > 0
                      and all(c["value"] <= c["limit"] for c in checks.values()))
    out["failed"] = result["failed_units"]
    out["device"] = device_info
    lat = sorted(r["t1"] - r["t0"] for r in runner.records)
    out["setup"] = {"seconds": setup_s,
                    "nvcc_runs": build.nvcc_runs if build else None,
                    "build_s": build.seconds if build else None,
                    "window_s": t_end - t0, "units": u,
                    "checked_units": result["checked_units"],
                    "unit_s": [lat[0], lat[len(lat) // 2], lat[-1]] if lat else None,
                    "gc_s": gc_s[0],
                    "stages": stages}
    out["checks"] = checks
    return out
