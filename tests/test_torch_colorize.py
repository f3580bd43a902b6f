"""The port's color ops and K4's plain version (`ops/colorize.py`) against
the JAX package's, on the CPU.

Gate for uint8 output, the one of tests/test_pallas_kernels.py:1289-1291:
at most 1 level apart, on at most 1e-3 of the bytes.  JAX's jitted XLA:CPU
may contract a product and the addition after it into one FMA, which can
move a truncated byte by one level; the port rounds every product, as its
CUDA kernel does under --fmad=false.  Under this suite's XLA flags
(tests/conftest.py) the bytes are seen equal.  Float output
(normalize_minmax_u8_value) is held to atol 1e-4 on values in [0, 255]:
an FMA moves the last bit, 1.5e-5 at 255.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from optical_flow_tpu.ops import color as jcolor
from optical_flow_tpu.ops import colorize as jcolorize
from optical_flow_tpu.ops import host as jhost
from optical_flow_tpu.ops import polar as jpolar
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar as k4
from optical_flow_tpu_torch.ops import color, colorize, host, polar


def _flows():
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, 24 * 128, endpoint=False,
                      dtype=np.float32).reshape(24, 128)
    mag = np.linspace(0.5, 8.0, 24 * 128, dtype=np.float32).reshape(24, 128)
    return {
        "random": (rng.standard_normal((2, 2, 40, 130)) * 10).astype(np.float32),
        "zero": np.zeros((2, 2, 40, 130), np.float32),
        # every direction, across the hue double-wrap at 256 degrees
        "angles": np.stack([mag * np.cos(ang), mag * np.sin(ang)])[None]
        .astype(np.float32),
        "odd": (rng.standard_normal((3, 2, 5, 7)) * 3).astype(np.float32),
    }


FLOWS = _flows()


def assert_u8_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3, f"{(d > 0).mean()} of the bytes differ"


def _jax_planar(flow):
    """The JAX package's XLA colorization (the Pallas kernel's reference),
    in the planar layout."""
    out = jcolorize.flow_to_bgr_u8(jnp.moveaxis(jnp.asarray(flow), 1, -1))
    return np.moveaxis(np.asarray(out), -1, 1)


def test_magnitude_is_correctly_rounded():
    """PyTorch's f32 sqrt on the CPU is 1 ulp off on some values, and
    which ones depends on the thread split; the port's magnitude must be
    the IEEE f32 sqrt that XLA and the K4 kernel compute."""
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((2, 1_000_000)) * 7).astype(np.float32)
    got = polar.magnitude(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(x * x + y * y))


def test_hsv2bgr_every_hue_and_value():
    """s = 255, every (h, v): the only saturation the visualizer uses."""
    h, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, np.full_like(h, 255), v], -1).astype(np.uint8)
    assert_u8_close(color.hsv2bgr_u8(torch.as_tensor(hsv)).numpy(),
                    jcolor.hsv2bgr_u8(jnp.asarray(hsv)))


def test_hsv2bgr_random_saturation():
    hsv = np.random.default_rng(1).integers(0, 256, (300, 300, 3)).astype(np.uint8)
    assert_u8_close(color.hsv2bgr_u8(torch.as_tensor(hsv)).numpy(),
                    jcolor.hsv2bgr_u8(jnp.asarray(hsv)))


@pytest.mark.parametrize("cv42", ["0", "1"])
def test_bgr2gray_matches_jax(monkeypatch, cv42):
    monkeypatch.setenv("OFT_CV42_GRAY", cv42)
    bgr = np.random.default_rng(2).integers(0, 256, (2, 33, 57, 3)).astype(np.uint8)
    ref = np.asarray(jcolor.bgr2gray_u8(jnp.asarray(bgr)))
    np.testing.assert_array_equal(color.bgr2gray_u8(torch.as_tensor(bgr)).numpy(), ref)
    np.testing.assert_array_equal(host.bgr2gray_host(bgr), ref)
    np.testing.assert_array_equal(host.bgr2gray_host(bgr), jhost.bgr2gray_host(bgr))


@pytest.mark.parametrize("kind", ["random", "zero"])
def test_normalize_minmax_value_matches_jax(kind):
    flow = FLOWS[kind]
    mag = np.sqrt(flow[:, 0] ** 2 + flow[:, 1] ** 2).astype(np.float32)
    got = polar.normalize_minmax_u8_value(torch.as_tensor(mag)).numpy()
    ref = np.asarray(jpolar.normalize_minmax_u8_value(jnp.asarray(mag)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert_u8_close(np.clip(np.floor(got), 0, 255).astype(np.uint8),
                    np.clip(np.floor(ref), 0, 255).astype(np.uint8))
    if kind == "zero":
        assert not got.any()                # constant magnitude -> all 0


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_flow_to_bgr_u8_matches_jax(kind):
    flow = np.moveaxis(FLOWS[kind], 1, -1)
    assert_u8_close(colorize.flow_to_bgr_u8(torch.as_tensor(flow)).numpy(),
                    jcolorize.flow_to_bgr_u8(jnp.asarray(flow)))


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_flow_to_bgr_planar_matches_jax_and_interleaved(kind):
    flow = FLOWS[kind]
    got = colorize.flow_to_bgr_planar(torch.as_tensor(flow)).numpy()
    assert_u8_close(got, _jax_planar(flow))
    inter = colorize.flow_to_bgr_u8(torch.as_tensor(np.moveaxis(flow, 1, -1)))
    np.testing.assert_array_equal(got, np.moveaxis(inter.numpy(), -1, 1))


def test_planar_matches_the_pallas_kernel(monkeypatch):
    """K4's plain version against the TPU kernel it replaces, run as the
    JAX package's tests run it on the CPU (Pallas interpret mode)."""
    from jax.experimental import pallas as pl
    from optical_flow_tpu.pallas import colorize as pallas_colorize

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    pallas_colorize._build.cache_clear()
    try:
        for flow in (FLOWS["random"][:1, :, :16], FLOWS["zero"][:1, :, :16]):
            ref = np.asarray(pallas_colorize.flow_to_bgr_planar_pallas(jnp.asarray(flow)))
            assert_u8_close(colorize.flow_to_bgr_planar(torch.as_tensor(flow)).numpy(), ref)
    finally:
        pallas_colorize._build.cache_clear()


def test_k4_wrapper_on_cpu_runs_the_plain_version():
    before = kernels.LAUNCHES["K4"]
    for flow in FLOWS.values():
        t = torch.as_tensor(flow)
        out = k4(t)
        assert out.dtype == torch.uint8 and out.shape == (t.shape[0], 3) + t.shape[2:]
        assert torch.equal(out, colorize.flow_to_bgr_planar(t))
    assert kernels.LAUNCHES["K4"] == before
    with pytest.raises(ValueError):
        k4(torch.zeros((1, 2, 4, 4), device="meta"))
