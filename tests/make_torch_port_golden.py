"""Writes tests/data/torch_port_golden.json: the JAX package's flow and
flow images on the CPU for the inputs that chip_smoke.py runs through the
PyTorch port.

The card's machine has no JAX, so this file is how the port's output is
held to the JAX package at full size there.  For each frame size, on
`smooth_texture_pair(h, w, (2, 3))` (true flow (-3, -2)), the `<h>x<w>`
entry records the pair's magnitude sum (the extractor's number), the
interior mean flow and the flow at 512 pixels drawn with
`np.random.default_rng(0)`; the `chain_bgr_<h>x<w>` entry records the
planar BGR of `calc_flow_bgr_chain_batched` on the chain [f1, f2, f1]
(the visualizer's pairs, flow (-3, -2) then (3, 2)) at those pixels.
tests/test_torch_flow.py regenerates the 72x129 entries and compares.

Run: JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_port_golden.json"
SIZES = ((1080, 1920), (72, 129))
SHIFT = (2, 3)
N_SAMPLES = 512
CROP = 32


def golden_entry(h: int, w: int) -> dict:
    import jax.numpy as jnp

    from optical_flow_tpu.models.farneback.flow import calc_flow_batched
    from optical_flow_tpu.oracle.synthetic import smooth_texture_pair
    from optical_flow_tpu.ops.polar import cart_to_polar

    f1, f2 = smooth_texture_pair(h, w, SHIFT)
    flow = calc_flow_batched(jnp.asarray(f1[None]), jnp.asarray(f2[None]))
    mag, _ = cart_to_polar(flow[..., 0], flow[..., 1])
    mag_sum = float(jnp.sum(mag, axis=(-2, -1))[0])
    flow = np.asarray(flow)[0]
    rng = np.random.default_rng(0)
    ys = rng.integers(0, h, N_SAMPLES)
    xs = rng.integers(0, w, N_SAMPLES)
    interior = flow[CROP:h - CROP, CROP:w - CROP].reshape(-1, 2).mean(0)
    return {
        "h": h, "w": w, "shift": list(SHIFT), "crop": CROP,
        "mag_sum": mag_sum,
        "interior_mean_flow": [float(v) for v in interior],
        "sample_y": ys.tolist(), "sample_x": xs.tolist(),
        "sample_flow": np.round(flow[ys, xs].astype(np.float64), 6).tolist(),
    }


def chain_bgr_entry(h: int, w: int) -> dict:
    import jax.numpy as jnp

    from optical_flow_tpu.models.farneback.flow import \
        calc_flow_bgr_chain_batched
    from optical_flow_tpu.oracle.synthetic import smooth_texture_pair

    f1, f2 = smooth_texture_pair(h, w, SHIFT)
    bgr = np.asarray(calc_flow_bgr_chain_batched(jnp.asarray(np.stack([f1, f2, f1]))))
    rng = np.random.default_rng(0)
    ys = rng.integers(0, h, N_SAMPLES)
    xs = rng.integers(0, w, N_SAMPLES)
    return {
        "h": h, "w": w, "shift": list(SHIFT), "chain": ["f1", "f2", "f1"],
        "sample_y": ys.tolist(), "sample_x": xs.tolist(),
        "sample_bgr": bgr[:, :, ys, xs].tolist(),     # (pairs, 3, samples)
    }


def main() -> int:
    sys.path.insert(0, str(REPO))
    out = {}
    for h, w in SIZES:
        out[f"{h}x{w}"] = golden_entry(h, w)
        out[f"chain_bgr_{h}x{w}"] = chain_bgr_entry(h, w)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
