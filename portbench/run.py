#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with CUDA cards.  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones), `device`,
with --trace 1 `breakdown`, then `setup` and, last, `checks`: each number
compared with the reference beside its limit, also the last lines of
standard error.  Exits non-zero, printing no result, without enough cards,
without the port in the checkout, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - process_age()
    # the kernels nvcc builds stay in the checkout, at a fixed place, so that
    # only a checkout's first run of a cell builds them
    os.environ["OFT_COMPILE_CACHE"] = str(ROOT / "portbench" / ".kernels")

    sys.path.insert(0, str(ROOT))
    from portbench import harness
    spec, wl, _, _ = harness.find(ROOT, args.workload)
    if "CUDA_VISIBLE_DEVICES" not in os.environ:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(wl["chips"]))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import optical_flow_tpu_torch
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 2
    if ROOT not in Path(optical_flow_tpu_torch.__file__).resolve().parents:
        print(f"the port was loaded from {optical_flow_tpu_torch.__file__}, "
              f"not from the checkout {ROOT}", file=sys.stderr)
        return 2
    device = "cuda:0" if wl["chips"] == 1 else None
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device=device, t_start=t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this run, and not allowed: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
