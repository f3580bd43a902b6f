"""Writes tests/data/torch_port_golden.json: the JAX package's flow and
flow images on the CPU for the inputs that chip_smoke.py runs through the
PyTorch port.

The card's machine has no JAX, so this file is how the port's output is
held to the JAX package at full size there.  For each frame size, on
`smooth_texture_pair(h, w, (2, 3))` (true flow (-3, -2)), the `<h>x<w>`
entry records the pair's magnitude sum (the extractor's number), the
interior mean flow and EPE and the flow at 512 pixels drawn with
`np.random.default_rng(0)`; `gaussian_<h>x<w>` is the same under
OPTFLOW_FARNEBACK_GAUSSIAN (flags 256), and `seeded_<h>x<w>` under
OPTFLOW_USE_INITIAL_FLOW (flags 4) from the seed `seed_flow(1, h, w)`,
the true flow plus 0.5 px of normal noise; `deep5_1080x1920` is the
1080x1920 entry of a five-level pyramid (levels=5, whose two coarsest
levels the JAX package blurs with its full-resolution Gaussian and the
port with K6); the `chain_bgr_<h>x<w>` entry
records the planar BGR of `calc_flow_bgr_chain_batched` on the chain
[f1, f2, f1] (the visualizer's pairs, flow (-3, -2) then (3, 2)) at
those pixels.  tests/test_torch_flow.py regenerates the 72x129 entries
and compares.

The file is written under the XLA flag the test suite runs with
(`--xla_backend_optimization_level=0`, tests/conftest.py).  At XLA's
default level its CPU code contracts the window sums' multiplies and adds,
which moves the last bits, flips the rint of some displaced fetches and,
at 1080x1920 with the Gaussian window, moves the JAX flow by up to 0.86 px
(mean 9.4e-4 px) against the same program at level 0; at level 0 the JAX
and port flows are equal to the bit there.

Run: JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "data" / "torch_port_golden.json"
SIZES = ((1080, 1920), (72, 129))
SHIFT = (2, 3)
TRUE_FLOW = (-3.0, -2.0)     # (x, y) flow of smooth_texture_pair(h, w, SHIFT)
N_SAMPLES = 512
CROP = 32
# entry prefix -> FarnebackConfig flags
FLAGS = {"": 0, "gaussian_": 256, "seeded_": 4}


def seed_flow(n: int, h: int, w: int) -> np.ndarray:
    """The seeded entries' initial flow, (n, h, w, 2) f32: the true flow
    plus 0.5 px of normal noise from np.random.default_rng(1).  The first
    pair's seed is the same for every n."""
    noise = np.random.default_rng(1).standard_normal((n, h, w, 2))
    return (np.asarray(TRUE_FLOW) + 0.5 * noise).astype(np.float32)


def golden_entry(h: int, w: int, flags: int = 0, config: dict | None = None) -> dict:
    """The entry of the pair at (h, w) under FarnebackConfig(flags=flags,
    **config); `config` (other fields, e.g. {"levels": 5}) is recorded."""
    import jax.numpy as jnp

    from optical_flow_tpu.models.farneback.flow import calc_flow_batched
    from optical_flow_tpu.oracle.synthetic import smooth_texture_pair
    from optical_flow_tpu.ops.polar import cart_to_polar
    from optical_flow_tpu.utils.config import FarnebackConfig

    f1, f2 = smooth_texture_pair(h, w, SHIFT)
    flow = calc_flow_batched(jnp.asarray(f1[None]), jnp.asarray(f2[None]),
                             FarnebackConfig(flags=flags, **(config or {})),
                             initial_flow=jnp.asarray(seed_flow(1, h, w)))
    mag, _ = cart_to_polar(flow[..., 0], flow[..., 1])
    mag_sum = float(jnp.sum(mag, axis=(-2, -1))[0])
    flow = np.asarray(flow)[0]
    rng = np.random.default_rng(0)
    ys = rng.integers(0, h, N_SAMPLES)
    xs = rng.integers(0, w, N_SAMPLES)
    inner = flow[CROP:h - CROP, CROP:w - CROP].reshape(-1, 2)
    epe = np.sqrt(((inner - np.asarray(TRUE_FLOW, np.float32)) ** 2).sum(-1)).mean()
    return {
        "h": h, "w": w, "shift": list(SHIFT), "crop": CROP, "flags": flags,
        "config": config or {},
        "mag_sum": mag_sum,
        "interior_mean_flow": [float(v) for v in inner.mean(0)],
        "interior_epe_px": float(epe),
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
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_backend_optimization_level" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_backend_optimization_level=0").strip()
    sys.path.insert(0, str(REPO))
    out = {}
    for h, w in SIZES:
        out[f"{h}x{w}"] = golden_entry(h, w)
        out[f"chain_bgr_{h}x{w}"] = chain_bgr_entry(h, w)
    out["gaussian_1080x1920"] = golden_entry(1080, 1920, FLAGS["gaussian_"])
    out["gaussian_72x129"] = golden_entry(72, 129, FLAGS["gaussian_"])
    out["seeded_1080x1920"] = golden_entry(1080, 1920, FLAGS["seeded_"])
    out["deep5_1080x1920"] = golden_entry(1080, 1920, config={"levels": 5})
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
