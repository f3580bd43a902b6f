"""K6, the full-resolution Gaussian (`kernels/gauss.py`), and the level
router that sends a pyramid level to K3 or to K6 and the bilinear resize
(`kernels/gauss_resize.py:k3_fits`, `models/farneback/flow.py:_level_images`),
on the CPU.

K6's plain version (`core.gaussian_blur_reflect101`) is held to the JAX
package's XLA blur and to its Pallas kernel run in interpret mode, as
tests/test_pallas_kernels.py runs it, at the deep pyramid's 39 and 79
taps.  Tolerance atol=1e-4, rtol=1e-5: the repo's stencil tolerance;
both sides sum the same taps in the same order in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optical_flow_tpu.models.farneback import core as jcore
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels.gauss import gaussian_blur, smem_bytes, tile
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize, k3_fits
from optical_flow_tpu_torch.models.farneback import core as tcore
from optical_flow_tpu_torch.models.farneback.flow import _level_images
from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                            gaussian_kernel)
from optical_flow_tpu_torch.utils.config import FarnebackConfig

TOL = dict(atol=1e-4, rtol=1e-5)
# the level Gaussians of L4 and L5 of a halving pyramid (1080p, levels=5)
DEEP_TAPS = {39: gaussian_kernel(39, 7.5), 79: gaussian_kernel(79, 15.5)}


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (n, h, w)).astype(np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """JAX's Pallas calls in interpret mode, so that the TPU kernel runs
    on the CPU; its build cache is cleared on entry and exit."""
    from jax.experimental import pallas as pl

    import optical_flow_tpu.pallas.gauss as ga
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    ga._build.cache_clear()
    yield ga
    ga._build.cache_clear()


def test_plain_blur_matches_pallas_kernel_at_39_taps(interpret_pallas):
    img = _frames(2, 96, 160)
    taps = DEEP_TAPS[39]
    ref = np.asarray(interpret_pallas.gaussian_blur_pallas(jnp.asarray(img), taps))
    got = tcore.gaussian_blur_reflect101(torch.as_tensor(img), taps)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("ntaps", sorted(DEEP_TAPS))
@pytest.mark.parametrize("shape", [(2, 96, 160), (3, 97, 161)])
def test_plain_blur_matches_jax(shape, ntaps):
    img = _frames(*shape, seed=ntaps)
    taps = DEEP_TAPS[ntaps]
    ref = np.asarray(jcore.gaussian_blur_reflect101(jnp.asarray(img), taps))
    got = tcore.gaussian_blur_reflect101(torch.as_tensor(img), taps)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _routes(h, w, cfg):
    """level k -> "K3" or "K6" for every level k > 0 of the plan."""
    return {lv.k: "K3" if k3_fits(lv.smooth_ksize, h, w, lv.width) else "K6"
            for lv in build_plan(h, w, cfg).levels if lv.k > 0}


@pytest.mark.parametrize("cfg,routes", [
    (FarnebackConfig(levels=5), {1: "K3", 2: "K3", 3: "K3", 4: "K6", 5: "K6"}),
    (FarnebackConfig(), {1: "K3", 2: "K3", 3: "K3"}),
    (FarnebackConfig(pyr_scale=0.25), {1: "K3", 2: "K6"}),
])
def test_k3_fits_routes_the_1080p_levels(cfg, routes):
    assert _routes(1080, 1920, cfg) == routes


def test_k3_fits_limits():
    taps19 = len(gaussian_kernel(19, 3.5))
    assert k3_fits(taps19, 1080, 1920, 240)
    assert not k3_fits(33, 1080, 1920, 120)        # more than 32 taps
    assert not k3_fits(4, 1080, 1920, 120)         # even
    assert not k3_fits(taps19, 9, 1920, 240)       # frame within the radius
    assert not k3_fits(3, 64, 64, 0)               # no output column
    # a downscale so steep that one block's columns span 200000 pixels
    assert not k3_fits(31, 64, 200000, 10)


def test_block_rows_shrink_with_the_taps():
    """K6's tile chooser: 32 rows until the taps' halo crowds them out,
    then 16; spans narrow as the taps grow; every odd tap count up to 3113
    (the earlier 128 x 16 block's limit) fits one block's shared memory at
    any width, and two blocks share an SM at the pyramids' 39-159 taps."""
    assert tile(3, 1920)[0] == tile(79, 1920)[0] == tile(249, 1920)[0] == 32
    assert tile(1001, 1920)[0] == 32 and tile(1751, 1920)[0] == 16
    assert tile(3113, 1920) == (16, 256)
    assert tile(3403, 64) == (0, 0)
    for ntaps in (39, 79, 159):
        assert 2 * (smem_bytes(ntaps, *tile(ntaps, 1920)) + 1024) <= 228 * 1024
    for w in (1, 37, 1001, 1920, 7680):
        for ntaps in range(1, 3114, 2):
            ty, tx = tile(ntaps, w)
            assert ty in (32, 16) and tx % 64 == 0 and tx >= 64
            assert smem_bytes(ntaps, ty, tx) <= kernels.MAX_SMEM


def test_wrappers_on_cpu_are_the_plain_versions():
    """gaussian_blur and the level router on CPU tensors: the plain
    versions, equal to the bit, uint8 and f32, and no launch."""
    kernels.reset_launches()
    u8 = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 50, 70),
                                                           dtype=np.uint8))
    for img in (u8, u8.float() / 3.0):
        for taps in (gaussian_kernel(3, 0.0), DEEP_TAPS[39]):
            got = gaussian_blur(img, taps)
            assert got.dtype == torch.float32
            assert torch.equal(got, tcore.gaussian_blur_reflect101(img, taps))
    with pytest.raises(ValueError):
        gaussian_blur(u8, DEEP_TAPS[39], out=torch.empty((2, 50, 70)))
    frames = torch.as_tensor(_frames(2, 128, 128))
    for ntaps, (oh, ow) in ((19, (16, 16)), (39, (8, 8)), (79, (4, 4))):
        taps = gaussian_kernel(ntaps, (ntaps - 1) / 5)
        got = _level_images(frames, taps, ow, oh)
        assert torch.equal(got, tcore.gaussian_blur_resize(frames, taps, ow, oh))
    assert torch.equal(gauss_resize(frames, DEEP_TAPS[39], 8, 8),
                       tcore.gaussian_blur_resize(frames, DEEP_TAPS[39], 8, 8))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
