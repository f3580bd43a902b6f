"""The extractor's corpus loop: per video, the port's
`pipeline.extractor.extract_frames`, then `aggregate`, `scale_magnitudes` and
`io.sidecar.mag_csv_line`, one video after another, on frames made in memory.

A video of `seconds` at the configuration's fps gets the window schedule of
`extract_video` (the program's own); each frame a window needs is a gray
frame of the pool at the configuration's size, as the decode threads would
hand it over after the resize.  The CSV line is built, not written.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, yardstick
from portbench.reference import colorize as ref_colorize
from portbench.reference import extractor as ref_extractor
from portbench.reference import farneback as ref_farneback


class Program:
    """The system under test: the port's entries this loop drives."""

    def __init__(self):
        from optical_flow_tpu_torch.io.sidecar import mag_csv_line
        from optical_flow_tpu_torch.pipeline import extractor, prefetch
        from optical_flow_tpu_torch.utils.config import ExtractorConfig, FarnebackConfig
        from optical_flow_tpu_torch.utils.metrics import PipelineMetrics
        self.extract_frames = extractor.extract_frames
        self.window_schedule = extractor._window_schedule
        self.aggregate = extractor.aggregate
        self.scale_magnitudes = extractor.scale_magnitudes
        self.mag_csv_line = mag_csv_line
        self.pair_chunk_for = prefetch.pair_chunk_for
        self.ExtractorConfig, self.FarnebackConfig = ExtractorConfig, FarnebackConfig
        self.metrics = PipelineMetrics("extract")


class Runner:
    """Set-up, the window's units and the check of one extractor cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.seed, self.program = cfg, traffic, seed, program
        self.device = device
        self.card = torch.device("cuda", 0) if device is None else torch.device(device)
        self.ecfg = program.ExtractorConfig(
            frame_width=cfg["frame_width"], step_size=cfg["step_ms"],
            window_size=cfg["window_ms"], top_percentile=cfg["top_percentile"],
            farneback=program.FarnebackConfig(**cfg["farneback"]))
        self.h, self.w = cfg["frame_height"], cfg["frame_width"]
        self.records = []
        self.keep = set()

    def setup(self) -> None:
        self.pool = generator.frame_pool(self.h, self.w, self.cfg["pool_frames"],
                                         self.seed, self.card)
        # the chunk `extract_video` would take, asked once for the run (the
        # program asks CUDA for the card's memory on every call)
        self.chunk = self.program.pair_chunk_for(self.h, self.w, device=self.card)
        self.keep = generator.check_picks(self.traffic, self.seed)
        for unit in generator.warm_units(self.traffic):
            self.run_unit(unit, keep=False)
        self.records = []

    def run_unit(self, unit: dict, keep: bool, deadline: float = float("inf")) -> dict:
        """One video: extract_frames over its windows, the aggregate, the
        scaling and the CSV line; the windows whose sums reached the host
        by `deadline`."""
        p, fps = self.program, self.cfg["fps"]
        tot = int(unit["seconds"] * fps)
        n = len(self.pool)
        in_time = [0]

        def arrived(idx, s, e, v):
            if time.perf_counter() <= deadline:
                in_time[0] += 1

        t0 = time.perf_counter()
        windows, step = p.window_schedule(tot, fps, self.ecfg.step_size, self.ecfg.window_size)
        todo = list(enumerate(windows))
        needed = sorted({f for w in windows for f in w})
        frames = ((f, self.pool[generator.pool_index(unit["phase"] + f, n)]) for f in needed)
        with torch.profiler.record_function("portbench/extract_frames"):
            results = p.extract_frames(frames, todo, self.ecfg, chunk_size=self.chunk,
                                       device=self.device, metrics=p.metrics,
                                       on_result=arrived)
        with torch.profiler.record_function("portbench/aggregate"):
            mags, stamps = p.aggregate(results, tot, fps, step)
            line = p.mag_csv_line(p.scale_magnitudes(mags, self.ecfg.top_percentile), stamps)
        t1 = time.perf_counter()
        rec = {"unit": unit, "tot": tot, "results": results, "line": line,
               "t0": t0, "t1": t1, "pairs": len(windows), "pairs_in_time": in_time[0]}
        self.records.append(rec)
        return rec

    def chunks(self) -> list:
        """The algorithm's work: each video's windows, two frames a pair."""
        return [yardstick.Chunk(r["pairs"], self.h, self.w, False, "sums") for r in self.records]

    def check(self, reference_dtype=torch.float32) -> dict:
        """window_errors over every video: windows missing, extra or at
        other frames than the reference's schedule; over the videos drawn
        for the check, sum_rel_err: the largest gap between a window's sum
        and the reference's, against the larger of the reference's sum and
        a thousandth of the video's median sum; csv_max_diff: the largest
        gap between the CSV line's values and the reference's line built
        from the reference's sums (infinite where the timestamps or the
        count of values differ)."""
        fps, cfg = self.cfg["fps"], self.cfg
        window_errors, failed = 0, set()
        sum_err, csv_err = 0.0, 0.0
        for u, r in enumerate(self.records):
            windows, step = ref_extractor.window_schedule(r["tot"], fps, cfg["step_ms"],
                                                          cfg["window_ms"])
            got = r["results"]
            bad = sum(got.get(i, (None, None))[:2] != w for i, w in enumerate(windows))
            bad += len(set(got) - set(range(len(windows))))
            window_errors += bad
            if bad:
                failed.add(u)
            if u not in self.keep:
                continue
            ref = self._reference_sums(r["unit"], windows, reference_dtype)
            prog = np.asarray([got[i][2] if i in got else np.nan for i in range(len(windows))])
            floor = 1e-3 * float(np.median(np.abs(ref)))
            err = np.abs(prog - ref) / np.maximum(np.abs(ref), floor)
            e = float(np.where(np.isnan(err), np.inf, err).max())
            mags, stamps = ref_extractor.aggregate(list(ref), windows, r["tot"], fps, step)
            ref_line = ref_extractor.csv_line(
                ref_extractor.scale_magnitudes(mags, cfg["top_percentile"]), stamps)
            c = _line_gap(r["line"], ref_line)
            sum_err, csv_err = max(sum_err, e), max(csv_err, c)
            if e > cfg["limits"]["sum_rel_err"] or c > cfg["limits"]["csv_max_diff"]:
                failed.add(u)
        return {"numbers": {"window_errors": float(window_errors),
                            "sum_rel_err": sum_err, "csv_max_diff": csv_err},
                "checked_units": len([u for u in self.keep if u < len(self.records)]),
                "failed_units": len(failed)}

    def _reference_sums(self, unit: dict, windows, dtype) -> np.ndarray:
        n, block = len(self.pool), self.cfg["reference_block"]
        out = []
        for j in range(0, len(windows), block):
            part = windows[j:j + block]
            idx = [generator.pool_index(unit["phase"] + f, n)
                   for f in [s for s, _ in part] + [e for _, e in part]]
            frames = torch.as_tensor(np.stack([self.pool[i] for i in idx])).to(self.card)
            flow = ref_farneback.flow_pyramid(frames, self.cfg["farneback"], False, dtype)
            out.append(ref_colorize.magnitude_sums(flow).cpu().double().numpy())
        return np.concatenate(out)


def _line_gap(got: str, ref: str) -> float:
    """The largest gap between two CSV lines' values; infinite where their
    timestamps or counts of values differ."""
    g, r = got.split("\t"), ref.split("\t")
    if len(g) != 3 or g[:2] != r[:2]:
        return float("inf")
    gv, rv = g[2].split(" "), r[2].split(" ")
    if len(gv) != len(rv):
        return float("inf")
    a, b = np.asarray(gv, dtype=np.float64), np.asarray(rv, dtype=np.float64)
    d = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
    return float(np.where(np.isnan(d), np.inf, d).max()) if d.size else 0.0
