"""K7's plain version and its route, on the CPU: `core.update_step_poly`
(one step from the level images) and `update_flow_fused_poly` (a level's
iterations) against the JAX package's expansion + iterate loop
(`core.poly_exp` after the REFLECT_101 pre-smooth, `core.update_flow`;
its interpret-mode K7 tests are marked slow), and `_flow_pyramid` with
FUSE_POLYEXP on equal to the switch off, to the bit.

Tolerance: the flow share gate of tests/test_torch_flow.py (ROADMAP.md):
at least 99.9 % of components within 2e-3 + 1e-3 |ref| and a mean
difference of at most 1e-3 px.  The JAX box window subtracts prefix sums
where the port adds the window, so the two flows differ in their last
bits; the Gaussian window sums by the same ops in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optical_flow_tpu.models.farneback import core as jcore
from optical_flow_tpu.oracle.synthetic import smooth_texture_pair
from optical_flow_tpu_torch.kernels import fused_iterate
from optical_flow_tpu_torch.kernels.update_gather import k7_fits
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.flow import (calc_flow_batched,
                                                          calc_flow_chain_batched)
from optical_flow_tpu_torch.models.farneback.params import build_plan, gaussian_kernel
from optical_flow_tpu_torch.utils.config import FarnebackConfig

from test_torch_flow import assert_flow_close

PRE = gaussian_kernel(3, 0.0)       # level 0's pre-smooth (cv2's 3-tap)
POLY_N, POLY_SIGMA = 5, 1.2


def _operands(h, w, kind, flow_kind):
    """Level images of a texture pair (B=2: the pair and its reverse),
    uint8 with the pre-smooth or f32, and a flow: random up to 6 px, or
    the true flow (-3, -2) plus 0.3 px of noise."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    img0, img1 = np.stack([f1, f2]), np.stack([f2, f1])
    if kind == "f32":
        img0 = img0.astype(np.float32) * 0.7 + 3.0
        img1 = img1.astype(np.float32) * 0.7 + 3.0
    rng = np.random.default_rng(h + w)
    if flow_kind == "random":
        flow = (rng.random((2, 2, h, w)) - 0.5) * 12.0
    else:
        flow = np.asarray([-3.0, -2.0])[None, :, None, None] + 0.3 * rng.standard_normal((2, 2, h, w))
        flow[1] *= -1.0
    return img0, img1, flow.astype(np.float32), PRE if kind == "u8_pre" else None


def _jax_expand(img, pre):
    x = jnp.asarray(img, jnp.float32)
    if pre is not None:
        x = jcore.gaussian_blur_reflect101(x, np.asarray(pre, np.float32))
    return jcore.poly_exp(x, POLY_N, POLY_SIGMA)


def _jax_level(img0, img1, flow, winsize, iterations, gaussian, pre):
    return np.asarray(jcore.update_flow(_jax_expand(img0, pre), _jax_expand(img1, pre),
                                        jnp.asarray(flow), winsize, iterations,
                                        gaussian=gaussian))


SHAPES = [(33, 130), (57, 150)]
KINDS = ["u8_pre", "f32"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_update_step_poly_matches_jax(h, w, gaussian, kind):
    """One step from the level images on a random flow of up to 6 px."""
    img0, img1, flow, pre = _operands(h, w, kind, "random")
    got = core.update_step_poly(torch.as_tensor(img0), torch.as_tensor(img1),
                                torch.as_tensor(flow), 15, gaussian, POLY_N,
                                POLY_SIGMA, pre)
    assert got.shape == (2, 2, h, w)
    assert_flow_close(got.numpy(), _jax_level(img0, img1, flow, 15, 1, gaussian, pre))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_update_flow_fused_poly_matches_jax(h, w, gaussian, kind):
    """A level's three steps from the level images, on a flow near the
    true one (the pyramid's own kind of flow)."""
    img0, img1, flow, pre = _operands(h, w, kind, "near_true")
    kept = flow.copy()
    got = fused_iterate.update_flow_fused_poly(
        torch.as_tensor(img0), torch.as_tensor(img1), torch.as_tensor(flow), 15, 3,
        gaussian, poly_n=POLY_N, poly_sigma=POLY_SIGMA, pre_taps=pre)
    np.testing.assert_array_equal(flow, kept)
    assert_flow_close(got.numpy(), _jax_level(img0, img1, flow, 15, 3, gaussian, pre))
    # the plain loop expands once; the per-step plain version gives the same bits
    step = torch.as_tensor(flow)
    for _ in range(3):
        step = core.update_step_poly(torch.as_tensor(img0), torch.as_tensor(img1), step,
                                     15, gaussian, POLY_N, POLY_SIGMA, pre)
    assert torch.equal(step, got)


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("config", [dict(), dict(flags=256), dict(winsize=9, poly_n=7,
                                                                  poly_sigma=1.5)])
def test_switch_on_equals_switch_off(monkeypatch, config, chain):
    """_flow_pyramid with FUSE_POLYEXP on takes the level images to
    update_flow_fused_poly (the plain loop on the CPU) and gives the
    switch-off flow to the bit, pairs and chain."""
    f1, f2 = smooth_texture_pair(72, 129, (2, 3))
    frames = np.stack([f1, f2, f1])
    cfg = FarnebackConfig(**config)

    def run():
        if chain:
            return calc_flow_chain_batched(frames, cfg, device="cpu")
        return calc_flow_batched(frames[:2], frames[1:], cfg, device="cpu")

    off = run()
    calls = []
    real = fused_iterate.update_flow_fused_poly
    monkeypatch.setattr(fused_iterate, "update_flow_fused_poly",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(fused_iterate, "FUSE_POLYEXP", True)
    on = run()
    assert len(calls) == len(build_plan(72, 129, cfg).levels) and calls[-1] == (2, 72, 129)
    assert torch.equal(on, off)


def test_route_follows_the_switch_and_the_tile(monkeypatch):
    assert not fused_iterate.FUSE_POLYEXP          # off by default, as in JAX
    assert not fused_iterate.use_fused_poly(15, 5)
    monkeypatch.setattr(fused_iterate, "FUSE_POLYEXP", True)
    assert fused_iterate.use_fused_poly(15, 5) and fused_iterate.use_fused_poly(61, 7)
    assert not fused_iterate.use_fused_poly(63, 5)
    assert k7_fits(1, 1) and k7_fits(15, 85) and not k7_fits(15, 86)
    assert not k7_fits(15, 97) and not k7_fits(15, 0)
