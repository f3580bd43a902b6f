"""The library entry's loop: clips of consecutive frame pairs through the
port's `models.farneback.flow.calc_flow_batched`, `batch_pairs` pairs a
call, on frames held on the card.

The frames go to the card once in set-up, as a decoder that writes to
device memory leaves them: the pool's triangle walk laid out in order
(`tape`), a period and the longest clip long, so that any clip's frames
are one slice of it.  A clip of `seconds` at the configuration's fps
walks the pool as the other entries do; its consecutive pairs (i, i + 1)
go to the program in calls of `batch_pairs`, the last call taking the
rest.  A call's `prev` and `nxt` are views of the clip's slice, so the
window runs no device work but the program's; the harness's span
`portbench/calc_flow_batched` covers the call alone.  The host then waits
for the call's flow on the stream, as a caller that uses each batch's
flow before it asks for the next.  Of the clips drawn for the check it
keeps, on the card, every `row_stride`-th row (from a row drawn from the
seed) of the flow of their first and their last call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import generator, yardstick
from portbench.reference import farneback_gaussian as ref_flow

SPAN = "portbench/calc_flow_batched"
# a kept flow component is off where it lies farther than this from the
# reference's, in px: room for float32 rounding, none for a wrong window
ATOL, RTOL = 1e-3, 1e-3


class Program:
    """The system under test: the port's library entry.  `metrics`, which
    the harness clears before the window, stays empty: the entry counts
    nothing."""

    def __init__(self):
        from optical_flow_tpu_torch.models.farneback.flow import calc_flow_batched
        from optical_flow_tpu_torch.utils.config import FarnebackConfig
        from optical_flow_tpu_torch.utils.metrics import PipelineMetrics
        self.calc_flow_batched = calc_flow_batched
        self.FarnebackConfig = FarnebackConfig
        self.metrics = PipelineMetrics("calc")


def reference_calc(dtype):
    """`calc_flow_batched` as the reference computes it at `dtype`, handing
    back float32 flow: for a program that has no such entry but a
    precision of its own (`portbench/control.py:Control`)."""

    def calc(prev, nxt, config, *, device):
        flow = ref_flow.flow_pyramid(torch.cat([prev, nxt]), config, False, dtype)
        return flow.float().movedim(1, -1)

    return calc


class Runner:
    """Set-up, the window's units and the check of one library-entry cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, program, device):
        self.cfg, self.traffic, self.seed, self.program = cfg, traffic, seed, program
        self.device = device
        self.card = torch.device("cuda", 0) if device is None else torch.device(device)
        self.calc = getattr(program, "calc_flow_batched", None) or reference_calc(program.dtype)
        self.fb = program.FarnebackConfig(**cfg["farneback"])
        self.h, self.w = cfg["frame_height"], cfg["frame_width"]
        self.batch = cfg["batch_pairs"]
        self.records = []
        self.keep = set()

    def setup(self) -> None:
        pool = generator.frame_pool(self.h, self.w, self.cfg["pool_frames"], self.seed,
                                    self.card)
        n = len(pool)
        self.period = 2 * (n - 1)
        longest = max(self.frame_count({"seconds": s}) for s in generator.strata(self.traffic))
        stride = self.traffic.get("stride", [1, 1])[1]
        walk = [generator.pool_index(k, n) for k in range(self.period + (longest - 1) * stride + 1)]
        self.tape = torch.as_tensor(np.stack(pool)).to(self.card)[walk]
        del pool
        self.keep = generator.check_picks(self.traffic, self.seed)
        self.row0 = int(generator.rng(self.seed, "rows").integers(self.cfg["row_stride"]))
        # one call of each size the window's clips hold
        sizes = {b - a for unit in generator.warm_units(self.traffic)
                 for a, b in self.calls(self.frame_count(unit))}
        for b in sorted(sizes, reverse=True):
            self.call(self.tape, 0, b)
            self.wait()
        self.records = []

    def frame_count(self, unit: dict) -> int:
        return int(unit["seconds"] * self.cfg["fps"])

    def calls(self, frames: int) -> list:
        """[(a, b)]: the pairs a .. b - 1 of a call, `batch_pairs` a call."""
        return [(a, min(a + self.batch, frames - 1)) for a in range(0, frames - 1, self.batch)]

    def clip(self, unit: dict) -> torch.Tensor:
        """The unit's frames: a view of the tape, pool frame
        `pool_index(phase + f * stride)` at f."""
        a, step = unit["phase"] % self.period, unit["stride"]
        return self.tape[a:a + (self.frame_count(unit) - 1) * step + 1:step]

    def call(self, clip: torch.Tensor, a: int, b: int) -> torch.Tensor:
        with torch.profiler.record_function(SPAN):
            return self.calc(clip[a:b], clip[a + 1:b + 1], self.fb, device=self.device)

    def wait(self) -> None:
        if self.card.type == "cuda":
            torch.cuda.current_stream(self.card).synchronize()

    def sound(self, flow, pairs: int) -> bool:
        return (isinstance(flow, torch.Tensor) and flow.dtype == torch.float32
                and flow.device == self.card
                and tuple(flow.shape) == (pairs, self.h, self.w, 2))

    def run_unit(self, unit: dict, keep: bool, deadline: float = float("inf")) -> dict:
        """One clip, call after call; the pairs whose flow the host had by
        `deadline`."""
        frames = self.frame_count(unit)
        clip = self.clip(unit)
        calls = self.calls(frames)
        rows = slice(self.row0, None, self.cfg["row_stride"])
        kept, errors, in_time = {}, 0, 0
        t0 = time.perf_counter()
        for c, (a, b) in enumerate(calls):
            flow = self.call(clip, a, b)
            self.wait()
            if time.perf_counter() <= deadline:
                in_time += b - a
            ok = self.sound(flow, b - a)
            errors += not ok
            if keep and c in (0, len(calls) - 1):
                kept[(a, b)] = flow[:, rows].clone() if ok else None
        t1 = time.perf_counter()
        rec = {"unit": unit, "clip": clip, "calls": calls, "kept": kept, "errors": errors,
               "t0": t0, "t1": t1, "pairs": frames - 1, "pairs_in_time": in_time}
        self.records.append(rec)
        return rec

    def chunks(self) -> list:
        """The algorithm's work: each call's pairs, two frames a pair.
        `yardstick` has no flow output, so each call counts as ending in
        magnitude sums: `kernels.roofline_pct` counts the box window's
        least work and a 4 B output a pair in this cell, and reads low
        here."""
        return [yardstick.Chunk(b - a, self.h, self.w, False, "sums")
                for r in self.records for a, b in r["calls"]]

    def check(self, reference_dtype=torch.float32) -> dict:
        """call_errors over every call: flows of the wrong shape, dtype or
        device; flow_off_share over the kept rows of the clips drawn for
        the check: the share of flow components farther than ATOL +
        RTOL |ref| px from the reference's (a call not kept counts as all
        of its components off)."""
        block = self.cfg["reference_block"]
        rows = slice(self.row0, None, self.cfg["row_stride"])
        n_rows = len(range(self.h)[rows])
        off = total = 0
        failed = {u for u, r in enumerate(self.records) if r["errors"]}
        for u, r in enumerate(self.records):
            if u not in self.keep:
                continue
            for (a, b), got in r["kept"].items():
                size = (b - a) * n_rows * self.w * 2
                total += size
                if got is None:
                    off += size
                    failed.add(u)
                    continue
                for j in range(a, b, block):
                    k = min(j + block, b)
                    both = torch.cat([r["clip"][j:k], r["clip"][j + 1:k + 1]])
                    ref = ref_flow.flow_pyramid(both, self.cfg["farneback"], False,
                                                reference_dtype)
                    ref = ref[:, :, rows].movedim(1, -1).float()
                    near = (got[j - a:k - a] - ref).abs() <= ATOL + RTOL * ref.abs()
                    bad = int(near.numel() - near.sum())
                    off += bad
                    if bad:
                        failed.add(u)
                    del both, ref, near
        return {"numbers": {"call_errors": float(sum(r["errors"] for r in self.records)),
                            "flow_off_share": off / total if total else float("inf")},
                "checked_units": len([u for u in self.keep if u < len(self.records)]),
                "failed_units": len(failed)}
