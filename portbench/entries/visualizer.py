"""The visualizer's shot loop: `pipeline.visualizer.visualize_frames` of
the port, one shot after another, on frames made in memory.

A shot of `seconds` at the configuration's fps samples the source every
`step_ms` as `visualize_shot` does (the start frame a float, the end and the
step truncated); each sampled frame is a gray frame of the pool, as the
decode threads would hand it over.  The write callback takes the planar BGR
image where the JPEG pool would: of the shots drawn for the check it keeps
every `row_stride`-th row of each image (from a row drawn from the seed),
and drops the rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, yardstick
from portbench.reference import colorize as ref_colorize
from portbench.reference import farneback as ref_farneback


class Program:
    """The system under test: the port's entries this loop drives."""

    def __init__(self):
        from optical_flow_tpu_torch.pipeline import prefetch, visualizer
        from optical_flow_tpu_torch.utils.config import FarnebackConfig
        from optical_flow_tpu_torch.utils.metrics import PipelineMetrics
        self.visualize_frames = visualizer.visualize_frames
        self.pair_chunk_for = prefetch.pair_chunk_for
        self.FarnebackConfig = FarnebackConfig
        self.metrics = PipelineMetrics("visualize")


def positions(cfg: dict, unit: dict) -> list:
    """The sampled frame positions of a shot, `visualize_shot`'s arithmetic."""
    fps = cfg["fps"]
    start_ms = unit["start_ms"]
    end_ms = start_ms + int(unit["seconds"] * 1000)
    ts, end = fps * start_ms / 1000, int(fps * end_ms / 1000)
    step = int(fps * cfg["step_ms"] / 1000)
    out = []
    while ts < end:
        out.append(ts)
        ts += step
    return out


class Runner:
    """Set-up, the window's units and the check of one visualizer cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.seed, self.program = cfg, traffic, seed, program
        self.device = device                  # None: every visible card
        self.card = torch.device("cuda", 0) if device is None else torch.device(device)
        self.fb = program.FarnebackConfig(**cfg["farneback"])
        self.h, self.w = cfg["frame_height"], cfg["frame_width"]
        self.records = []
        self.keep = set()

    def setup(self) -> None:
        self.pool = generator.frame_pool(self.h, self.w, self.cfg["pool_frames"],
                                         self.seed, self.card)
        # the chunk `visualize_shot` would take, asked once for the run (the
        # program asks CUDA for the card's memory on every call)
        self.chunk = self.program.pair_chunk_for(self.h, self.w, device=self.card)
        self.keep = generator.check_picks(self.traffic, self.seed)
        self.row0 = int(generator.rng(self.seed, "rows").integers(self.cfg["row_stride"]))
        # one shot of each length in frames the strata hold: every chunk
        # shape, and every host buffer size, the window will ask for
        sizes = set()
        for unit in generator.warm_units(self.traffic):
            n = len(positions(self.cfg, unit))
            if n not in sizes:
                sizes.add(n)
                self.run_unit(unit, keep=False)
        self.records = []

    def frames(self, unit: dict) -> list:
        pos = positions(self.cfg, unit)
        n = len(self.pool)
        idx = [generator.pool_index(unit["phase"] + i * unit["stride"], n) for i in range(len(pos))]
        return list(zip(pos, idx))

    def run_unit(self, unit: dict, keep: bool, deadline: float = float("inf")) -> dict:
        """One shot through `visualize_frames`: its latency, the positions
        written in order, the pairs that reached the host by `deadline`."""
        seq = self.frames(unit)
        written, images = [], []
        in_time = [0]

        rows = slice(self.row0, None, self.cfg["row_stride"])

        def write(pos, planar):
            written.append(pos)
            if keep:
                images.append(planar[:, rows].copy())
            if time.perf_counter() <= deadline:
                in_time[0] += 1

        p = self.program
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench/visualize_frames"):
            n = p.visualize_frames([(pos, self.pool[i]) for pos, i in seq], write, self.fb,
                                   chunk_size=self.chunk, device=self.device, metrics=p.metrics)
        t1 = time.perf_counter()
        rec = {"unit": unit, "seq": seq, "written": written, "images": images,
               "returned": n, "t0": t0, "t1": t1, "pairs": len(seq) - 1,
               "pairs_in_time": in_time[0]}
        self.records.append(rec)
        return rec

    def chunks(self) -> list:
        """The algorithm's work: each shot one chain of its frames."""
        return [yardstick.Chunk(r["pairs"], self.h, self.w, True, "bgr") for r in self.records]

    def check(self, reference_dtype=torch.float32) -> dict:
        """order_errors over every shot: images not written once each, in
        order, at the shot's positions; bgr_off_share over the shots drawn
        for the check: the share of the bytes kept of their images that lie
        more than one level off the reference's (a missing image counts as
        all bytes off)."""
        order_errors = sum(r["written"] != [pos for pos, _ in r["seq"][1:]]
                           or r["returned"] != r["pairs"] for r in self.records)
        off = total = 0
        failed = set()
        block = self.cfg["reference_block"]
        for u, r in enumerate(self.records):
            if u not in self.keep:
                continue
            frames = torch.as_tensor(np.stack([self.pool[i] for _, i in r["seq"]]))
            for j in range(0, r["pairs"], block):
                chain = frames[j:j + block + 1].to(self.card)
                flow = ref_farneback.flow_pyramid(chain, self.cfg["farneback"], True,
                                                  reference_dtype)
                ref = ref_colorize.flow_to_bgr(flow)[:, :, self.row0::self.cfg["row_stride"]]
                ref = ref.cpu().numpy().astype(np.int16)
                for k in range(ref.shape[0]):
                    total += ref[k].size
                    got = r["images"][j + k] if j + k < len(r["images"]) else None
                    if got is None or got.shape != ref[k].shape:
                        off += ref[k].size
                        failed.add(u)
                        continue
                    bad = int((np.abs(got.astype(np.int16) - ref[k]) > 1).sum())
                    off += bad
                    if bad:
                        failed.add(u)
                del chain, flow
        failed |= {u for u, r in enumerate(self.records)
                   if r["written"] != [pos for pos, _ in r["seq"][1:]]}
        return {"numbers": {"order_errors": float(order_errors),
                            "bgr_off_share": off / total if total else float("inf")},
                "checked_units": len([u for u in self.keep if u < len(self.records)]),
                "failed_units": len(failed)}
