"""The port's main path (calc_flow_batched, magnitude_sums) against the JAX
package's, on the CPU, and the golden file that chip_smoke.py holds the
card's output to.

Criterion for flow (the share gate of chip_smoke.py): at least 99.9 % of
the flow components within atol=2e-3, rtol=1e-3, and a mean |difference|
of at most 1e-3 px.  It is a share and not an allclose because of rint
flips: JAX's jitted XLA:CPU program may contract its fused stencils into
multiply-adds, so its values can differ from the port's op-by-op float32
in the last bits, and a displaced-fetch coordinate within those bits of a
.5 boundary then rounds the other way, moving the flow by a few 1e-3 px
over a winsize^2 patch.  Under this suite's XLA flags (backend opt level
0, tests/conftest.py) the shares here are 100 %; at XLA's default level
one flip was seen on the 96x128 boundary pair (99.6 %), which at these
small frames is a large share of the pixels.  Magnitude sums: 1e-4
relative (the two sums run in different orders).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optical_flow_tpu.models.farneback.flow import calc_flow as jax_calc_flow
from optical_flow_tpu.models.farneback.flow import calc_flow_batched as jax_flow
from optical_flow_tpu.oracle.synthetic import (motion_boundary_pair,
                                               smooth_texture_pair)
from optical_flow_tpu.ops.polar import cart_to_polar as jax_cart_to_polar
from optical_flow_tpu.utils.config import FarnebackConfig as JaxConfig
from optical_flow_tpu_torch.models.farneback.flow import (
    calc_flow, calc_flow_batched, calc_flow_bgr_chain_batched)
from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums
from optical_flow_tpu_torch.utils.config import FarnebackConfig

from make_torch_port_golden import (FLAGS, GOLDEN, TRUE_FLOW, chain_bgr_entry,
                                    golden_entry, seed_flow)

SHARE = 0.999
PAIRS = {
    "smooth": lambda h, w: smooth_texture_pair(h, w, (2, 3)),
    "boundary": motion_boundary_pair,
}


def _batch(kind, h, w):
    """B=2: the pair and the same pair reversed (flow of opposite sign)."""
    f1, f2 = PAIRS[kind](h, w)
    return np.stack([f1, f2]), np.stack([f2, f1])


def _jax_sums(flow):
    """The one-device branch of the JAX extractor's _magnitude_sums."""
    mag, _ = jax_cart_to_polar(flow[..., 0], flow[..., 1])
    return np.asarray(jnp.sum(mag, axis=(-2, -1)))


def assert_flow_close(got, ref, share=SHARE):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    within = (d <= 2e-3 + 1e-3 * np.abs(ref)).mean()
    assert within >= share, f"only {within:.5f} of components within tolerance"
    assert d.mean() <= 1e-3, f"mean |diff| {d.mean()}"


@pytest.mark.parametrize("kind", sorted(PAIRS))
@pytest.mark.parametrize("h,w", [(96, 128), (72, 129)])
def test_calc_flow_batched_matches_jax(h, w, kind):
    prev, nxt = _batch(kind, h, w)
    ref = jax_flow(jnp.asarray(prev), jnp.asarray(nxt))
    got = calc_flow_batched(prev, nxt, FarnebackConfig(), device="cpu")
    assert got.shape == (2, h, w, 2)
    assert_flow_close(got.numpy(), ref)
    sums = magnitude_sums(prev, nxt, FarnebackConfig(), device="cpu").numpy()
    np.testing.assert_allclose(sums, _jax_sums(ref), rtol=1e-4)


def test_calc_flow_batched_float_input_matches_jax():
    prev, nxt = _batch("smooth", 72, 129)
    prev, nxt = prev.astype(np.float32), nxt.astype(np.float32)
    ref = jax_flow(jnp.asarray(prev), jnp.asarray(nxt))
    got = calc_flow_batched(torch.as_tensor(prev), torch.as_tensor(nxt))
    assert_flow_close(got.numpy(), ref)


@pytest.mark.parametrize("flags", [256, 4, 260])
@pytest.mark.parametrize("kind", sorted(PAIRS))
@pytest.mark.parametrize("h,w", [(96, 128), (72, 129)])
def test_calc_flow_batched_flags_match_jax(h, w, kind, flags):
    """The Gaussian window (256), the seeded start (4) and both (260).

    The seed is chip_smoke.py's, the true flow of the smooth pair plus
    0.5 px of noise (`seed_flow`).  The Gaussian window sums by the same
    ops in both packages, and its flow is equal to the bit here.  The box
    window is the designed difference (JAX subtracts prefix sums, the port
    adds the window): after one step on a seeded level they differ by up
    to 1.5e-5 px, and a rint of the next step's fetch can flip on it.
    With this seed none does; test_rough_seed_flip_stays_local holds a
    seed where one does."""
    prev, nxt = _batch(kind, h, w)
    seed = seed_flow(2, h, w)
    ref = jax_flow(jnp.asarray(prev), jnp.asarray(nxt), JaxConfig(flags=flags),
                   initial_flow=jnp.asarray(seed))
    got = calc_flow_batched(prev, nxt, FarnebackConfig(flags=flags), seed, device="cpu")
    assert got.shape == (2, h, w, 2)
    assert_flow_close(got.numpy(), ref)


def test_rough_seed_flip_stays_local():
    """A rougher seed, 1 px of noise from np.random.default_rng(0) on the
    72x129 smooth pair, where the box sums' designed difference does flip
    a rint: 4.1 % of the components of pair 0, in a 24x27 px patch, leave
    the share gate's tolerance (max 0.0125 px, mean over both pairs
    2.2e-4 px), so assert_flow_close would fail.  What must
    hold is that a flip stays local: the components off by more than the
    tolerance lie within the spread of one window over a level's steps,
    1 + iterations * (winsize - 1) px on a side, and the mean difference
    within the gate's 1e-3 px."""
    h, w = 72, 129
    prev, nxt = _batch("smooth", h, w)
    noise = np.random.default_rng(0).standard_normal((2, h, w, 2))
    seed = (np.asarray(TRUE_FLOW) + noise).astype(np.float32)
    cfg = FarnebackConfig(flags=4)
    ref = np.asarray(jax_flow(jnp.asarray(prev), jnp.asarray(nxt),
                              JaxConfig(flags=4), initial_flow=jnp.asarray(seed)))
    got = calc_flow_batched(prev, nxt, cfg, seed, device="cpu").numpy()
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    assert d.mean() <= 1e-3, f"mean |diff| {d.mean()}"
    spread = 1 + cfg.iterations * (cfg.winsize - 1)
    for pair in range(2):
        off = (d[pair] > 2e-3 + 1e-3 * np.abs(ref[pair])).any(-1)
        ys, xs = np.nonzero(off)
        if len(ys):
            assert np.ptp(ys) < spread and np.ptp(xs) < spread, (
                f"pair {pair}: differences span {np.ptp(ys) + 1}x{np.ptp(xs) + 1} px")


@pytest.mark.parametrize("winsize", [2, 63])
def test_calc_flow_batched_window_sizes_match_jax(winsize):
    """winsize 63 is beyond K1's tile, so the card runs K5a -> K5b there;
    winsize 2 is the smallest Gaussian window (3 taps)."""
    prev, nxt = _batch("smooth", 72, 129)
    for flags in (0, 256):
        ref = jax_flow(jnp.asarray(prev), jnp.asarray(nxt),
                       JaxConfig(winsize=winsize, flags=flags))
        got = calc_flow_batched(prev, nxt, FarnebackConfig(winsize=winsize, flags=flags),
                                device="cpu")
        assert_flow_close(got.numpy(), ref)


@pytest.mark.parametrize("config", [
    dict(levels=4),                     # L4 32x32: 39 taps, past K3's 32
    dict(pyr_scale=0.25),               # L2 32x32: 39 taps
    # K2 beyond its old cap of 10, under the Gaussian window: with the box
    # window the designed difference of the box sums flips rints here
    # (99.89 % of components in the gate, mean 1.5e-5 px)
    dict(levels=1, poly_n=11, poly_sigma=2.4, flags=256),
])
def test_deep_and_wide_configs_match_jax(config):
    """A 512x512 pair (B=1) under configs whose levels the card sends to
    K6 and the bilinear resize, or to K2 with an 11-pixel reach, against
    the JAX package."""
    f1, f2 = smooth_texture_pair(512, 512, (2, 3))
    ref = jax_flow(jnp.asarray(f1[None]), jnp.asarray(f2[None]), JaxConfig(**config))
    got = calc_flow_batched(f1[None], f2[None], FarnebackConfig(**config), device="cpu")
    assert got.shape == (1, 512, 512, 2)
    assert_flow_close(got.numpy(), ref)


@pytest.mark.parametrize("flags", [0, 4, 260])
def test_calc_flow_matches_jax(flags):
    """The single-pair entry, cv2's contract: (H, W) in, (H, W, 2) out."""
    f1, f2 = PAIRS["boundary"](72, 129)
    seed = seed_flow(1, 72, 129)[0]
    ref = jax_calc_flow(jnp.asarray(f1), jnp.asarray(f2), JaxConfig(flags=flags),
                        initial_flow=jnp.asarray(seed))
    got = calc_flow(torch.as_tensor(f1), torch.as_tensor(f2), FarnebackConfig(flags=flags), seed)
    assert got.shape == (72, 129, 2)
    assert_flow_close(got.numpy(), ref)
    batch = calc_flow_batched(f1[None], f2[None], FarnebackConfig(flags=flags), seed[None],
                              device="cpu")
    assert torch.equal(got, batch[0])


def test_calc_flow_batched_rejects_what_is_not_ported():
    """What the port refuses: shapes JAX refuses too, a missing or
    misshapen seed (ValueError, as JAX), and the Gaussian window at
    winsize 1, where the reference's window is NaN (0 / 0) and its flow
    NaN everywhere."""
    prev, nxt = _batch("smooth", 72, 129)
    with pytest.raises(ValueError):
        calc_flow_batched(prev, nxt[:, :-1], device="cpu")
    with pytest.raises(ValueError):
        calc_flow_batched(prev[0], nxt[0], device="cpu")
    for flags in (4, 260):
        with pytest.raises(ValueError, match="initial_flow"):
            jax_flow(jnp.asarray(prev), jnp.asarray(nxt), JaxConfig(flags=flags))
        with pytest.raises(ValueError, match="initial_flow"):
            calc_flow_batched(prev, nxt, FarnebackConfig(flags=flags), device="cpu")
        with pytest.raises(ValueError, match="initial_flow"):
            calc_flow(torch.as_tensor(prev[0]), torch.as_tensor(nxt[0]),
                      FarnebackConfig(flags=flags))
    with pytest.raises(ValueError):
        calc_flow_batched(prev, nxt, FarnebackConfig(flags=4), seed_flow(2, 72, 128),
                          device="cpu")
    with pytest.raises(ValueError):
        calc_flow(torch.as_tensor(prev), torch.as_tensor(nxt))  # (B, H, W)
    ref = np.asarray(jax_flow(jnp.asarray(prev), jnp.asarray(nxt),
                              JaxConfig(winsize=1, flags=256)))
    assert np.isnan(ref).all()
    with pytest.raises(ValueError, match="sigma 0"):
        calc_flow_batched(prev, nxt, FarnebackConfig(winsize=1, flags=256), device="cpu")


def test_golden_file_is_current():
    """Regenerate the 72x129 golden entries with the JAX package and
    compare them with the file chip_smoke.py reads."""
    stored = json.loads(Path(GOLDEN).read_text())
    assert set(stored) == {"1080x1920", "72x129",
                           "chain_bgr_1080x1920", "chain_bgr_72x129",
                           "gaussian_1080x1920", "gaussian_72x129",
                           "seeded_1080x1920", "deep5_1080x1920"}
    assert Path(GOLDEN).stat().st_size < 150_000
    for key in ("72x129", "gaussian_72x129"):
        fresh = golden_entry(72, 129, FLAGS[key[:-len("72x129")]])
        old = stored[key]
        assert old["flags"] == fresh["flags"]
        assert old["sample_y"] == fresh["sample_y"]
        assert old["sample_x"] == fresh["sample_x"]
        np.testing.assert_allclose(old["mag_sum"], fresh["mag_sum"], rtol=1e-5)
        np.testing.assert_allclose(old["interior_mean_flow"],
                                   fresh["interior_mean_flow"], atol=1e-5)
        np.testing.assert_allclose(old["interior_epe_px"],
                                   fresh["interior_epe_px"], atol=1e-5)
        np.testing.assert_allclose(old["sample_flow"], fresh["sample_flow"],
                                   atol=1e-5)
    for key in ("1080x1920", "gaussian_1080x1920", "seeded_1080x1920",
                "deep5_1080x1920"):
        assert len(stored[key]["sample_flow"]) == 512
        assert stored[key]["interior_epe_px"] <= 0.5
    assert (stored["gaussian_1080x1920"]["flags"], stored["seeded_1080x1920"]["flags"]) == (256, 4)
    assert stored["deep5_1080x1920"]["config"] == {"levels": 5}
    fresh = chain_bgr_entry(72, 129)
    old = stored["chain_bgr_72x129"]
    assert (old["sample_y"], old["sample_x"]) == (fresh["sample_y"], fresh["sample_x"])
    # the stored file and this run use the suite's XLA flags; at most 1e-3
    # of the sampled bytes may differ
    assert (np.asarray(old["sample_bgr"]) != np.asarray(fresh["sample_bgr"])).mean() <= 1e-3
    assert np.asarray(stored["chain_bgr_1080x1920"]["sample_bgr"]).shape == (2, 3, 512)


def test_port_matches_golden_at_72x129():
    """What chip_smoke.py checks on the card, here through the plain path."""
    g = json.loads(Path(GOLDEN).read_text())["72x129"]
    f1, f2 = smooth_texture_pair(72, 129, tuple(g["shift"]))
    prev, nxt = f1[None], f2[None]
    sums = magnitude_sums(prev, nxt, device="cpu").numpy()
    np.testing.assert_allclose(sums, [g["mag_sum"]], rtol=1e-4)
    flow = calc_flow_batched(prev, nxt, device="cpu").numpy()[0]
    samples = flow[g["sample_y"], g["sample_x"]]
    assert (np.abs(samples - np.asarray(g["sample_flow"])) <= 2e-3).mean() >= 0.99


def test_port_gaussian_matches_golden_at_72x129():
    """The Gaussian-window golden entry, through the plain path; and the
    seed of the seeded entries: its first pair is the same at any batch."""
    g = json.loads(Path(GOLDEN).read_text())["gaussian_72x129"]
    f1, f2 = smooth_texture_pair(72, 129, tuple(g["shift"]))
    cfg = FarnebackConfig(flags=g["flags"])
    sums = magnitude_sums(f1[None], f2[None], cfg, device="cpu").numpy()
    np.testing.assert_allclose(sums, [g["mag_sum"]], rtol=1e-4)
    flow = calc_flow_batched(f1[None], f2[None], cfg, device="cpu").numpy()[0]
    samples = flow[g["sample_y"], g["sample_x"]]
    assert (np.abs(samples - np.asarray(g["sample_flow"])) <= 2e-3).mean() >= 0.99
    np.testing.assert_array_equal(seed_flow(3, 8, 9)[0], seed_flow(1, 8, 9)[0])


def test_port_chain_bgr_matches_golden_at_72x129():
    """What chip_smoke.py checks of the visualizer on the card, here
    through the plain path: the sampled bytes of [f1, f2, f1]."""
    g = json.loads(Path(GOLDEN).read_text())["chain_bgr_72x129"]
    f1, f2 = smooth_texture_pair(72, 129, tuple(g["shift"]))
    bgr = calc_flow_bgr_chain_batched(np.stack([f1, f2, f1]), device="cpu").numpy()
    samples = bgr[:, :, g["sample_y"], g["sample_x"]]
    assert (samples != np.asarray(g["sample_bgr"])).mean() <= 1e-2
