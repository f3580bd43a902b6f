"""The port's plain PyTorch building blocks (the kernels' plain versions)
against the JAX package's XLA functions, on odd shapes, run eagerly on
the CPU.

Tolerance atol=1e-4, rtol=1e-5 throughout: the tolerance the repo holds
its Pallas kernels to against these XLA functions
(tests/test_pallas_kernels.py).  Both sides are float32 with the same
tap order, so most stages agree to the bit; the box sum is the one
designed difference (a direct windowed sum in the port, a difference of
prefix sums in JAX, whose cancellation error grows with the row length).
The kernel wrappers are also run on CPU tensors here, where they must be
their plain versions and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optical_flow_tpu.models.farneback import core as jcore
from optical_flow_tpu.oracle.synthetic import smooth_texture_pair
from optical_flow_tpu.ops import polar as jpolar
from optical_flow_tpu.ops import resize as jresize
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels.fused_iterate import (update_flow,
                                                          update_flow_fused,
                                                          update_flow_unfused)
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.kernels.update_gather import (update_blur,
                                                          update_blur_poly,
                                                          update_matrices)
from optical_flow_tpu_torch.models.farneback import core as tcore
from optical_flow_tpu_torch.models.farneback.params import gaussian_kernel
from optical_flow_tpu_torch.ops import colorize
from optical_flow_tpu_torch.ops import polar as tpolar
from optical_flow_tpu_torch.ops import resize as tresize

TOL = dict(atol=1e-4, rtol=1e-5)
LEVEL_TAPS = {1: gaussian_kernel(3, 0.5), 2: gaussian_kernel(9, 1.5),
              3: gaussian_kernel(19, 3.5)}
PRE_TAPS = gaussian_kernel(3, 0.0)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **(tol or TOL))


def _texture_R(h, w):
    """R of a smooth-texture pair (realistic magnitudes) and a random flow
    of up to 4 px, so that fetches leave the image near the borders."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    imgs = torch.as_tensor(np.stack([f1, f2]).astype(np.float32))
    R = tcore.poly_exp(imgs, 5, 1.2)
    rng = np.random.default_rng(1)
    flow = ((rng.random((1, 2, h, w)) - 0.5) * 8).astype(np.float32)
    return R[:1], R[1:], torch.as_tensor(flow)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_gaussian_blur_reflect101(k):
    img = _frames(2, 41, 67).astype(np.float32)
    _close(tcore.gaussian_blur_reflect101(torch.as_tensor(img), LEVEL_TAPS[k]),
           jcore.gaussian_blur_reflect101(jnp.asarray(img), LEVEL_TAPS[k]))


@pytest.mark.parametrize("k,h,w", [(1, 72, 129), (2, 96, 128), (3, 136, 240),
                                   (1, 37, 53), (2, 67, 99)])
def test_gauss_resize_plain_matches_jax(k, h, w):
    """The K3 oracle: blur of the full-res frame, then the bilinear resize
    to the level size (OpenCV's rounding of the scaled dims)."""
    img = _frames(3, h, w)
    s = 2 ** k
    ow, oh = int(np.rint(w / s)), int(np.rint(h / s))
    ref = jresize.resize_bilinear_f32(
        jcore.gaussian_blur_reflect101(jnp.asarray(img.astype(np.float32)),
                                       LEVEL_TAPS[k]), ow, oh)
    got = tcore.gaussian_blur_resize(torch.as_tensor(img), LEVEL_TAPS[k], ow, oh)
    assert got.shape == (3, oh, ow) and got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("h,w", [(37, 53), (72, 129)])
def test_poly_exp_matches_jax(h, w, pre):
    """The K2 oracle, with the level-0 pre-smooth as
    poly_exp(gaussian_blur_reflect101(img, [1/4, 1/2, 1/4]))."""
    img = _frames(2, h, w).astype(np.float32)
    j = jnp.asarray(img)
    if pre:
        j = jcore.gaussian_blur_reflect101(j, PRE_TAPS)
    ref = jcore.poly_exp(j, 5, 1.2)
    got = tcore.poly_exp(torch.as_tensor(img), 5, 1.2,
                         pre_taps=PRE_TAPS if pre else None)
    assert got.shape == (2, 5, h, w)
    _close(got, ref)


@pytest.mark.parametrize("poly_n,poly_sigma", [(11, 2.4), (13, 0.0)])
def test_poly_exp_wide_window_matches_jax(poly_n, poly_sigma):
    """K2's plain version beyond cv2's usual 5 and 7 (the card's kernel
    took at most 10 before; FarnebackConfig accepts any poly_n >= 1)."""
    img = _frames(2, 41, 67).astype(np.float32)
    ref = jcore.poly_exp(jnp.asarray(img), poly_n, poly_sigma)
    got = tcore.poly_exp(torch.as_tensor(img), poly_n, poly_sigma)
    assert got.shape == (2, 5, 41, 67)
    _close(got, ref)


def test_poly_exp_uint8_input_equals_float():
    img = _frames(2, 33, 47)
    a = tcore.poly_exp(torch.as_tensor(img), 5, 1.2, pre_taps=PRE_TAPS)
    b = tcore.poly_exp(torch.as_tensor(img.astype(np.float32)), 5, 1.2,
                       pre_taps=PRE_TAPS)
    assert torch.equal(a, b)


@pytest.mark.parametrize("h,w", [(37, 53), (9, 7)])
def test_border_scale_field_matches_jax(h, w):
    np.testing.assert_array_equal(tcore.border_scale_field(h, w),
                                  jcore.border_scale_field(h, w))


@pytest.mark.parametrize("h,w", [(37, 53), (48, 64)])
def test_update_matrices_matches_jax(h, w):
    R0, R1, flow = _texture_R(h, w)
    ref = jcore.update_matrices(jnp.asarray(R0.numpy()), jnp.asarray(R1.numpy()),
                                jnp.asarray(flow.numpy()))
    _close(tcore.update_matrices(R0, R1, flow), ref)


@pytest.mark.parametrize("ksize", [1, 3, 15, 10])
def test_box_sum_replicate_matches_jax(ksize):
    R0, R1, flow = _texture_R(41, 67)
    M = tcore.update_matrices(R0, R1, flow)
    _close(tcore.box_sum_replicate(M, ksize),
           jcore.box_sum_replicate(jnp.asarray(M.numpy()), ksize))


def test_solve_flow_matches_jax():
    R0, R1, flow = _texture_R(41, 67)
    Mb = tcore.box_sum_replicate(tcore.update_matrices(R0, R1, flow), 15)
    _close(tcore.solve_flow(Mb, 1.0 / 225),
           jcore.solve_flow(jnp.asarray(Mb.numpy()), 1.0 / 225))


@pytest.mark.parametrize("h,w", [(41, 67), (72, 129)])
def test_update_step_matches_jax(h, w):
    """The K1 oracle: update_matrices -> box_sum_replicate -> solve_flow."""
    R0, R1, flow = _texture_R(h, w)
    j = [jnp.asarray(t.numpy()) for t in (R0, R1, flow)]
    ref = jcore.solve_flow(jcore.box_sum_replicate(jcore.update_matrices(*j), 15),
                           1.0 / 225)
    _close(tcore.update_step(R0, R1, flow, 15), ref)


@pytest.mark.parametrize("src,dst", [((17, 33), (34, 66)), ((36, 64), (72, 129)),
                                     ((72, 129), (36, 64)), ((20, 20), (20, 31))])
def test_resize_bilinear_f32_matches_jax(src, dst):
    x = np.random.default_rng(2).standard_normal((2, 2) + src).astype(np.float32)
    dh, dw = dst
    got = tresize.resize_bilinear_f32(torch.as_tensor(x), dw, dh)
    _close(got, jresize.resize_bilinear_f32(jnp.asarray(x), dw, dh))
    for a, b in zip(tresize._coeffs_f32(src[1], dw), jresize._coeffs_f32(src[1], dw)):
        np.testing.assert_array_equal(a, b)


def test_cart_to_polar_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 33, 47)) * 4).astype(np.float32)
    y = (rng.standard_normal((5, 33, 47)) * 4).astype(np.float32)
    x[0, 0, :4] = [0.0, 0.0, -1.0, 2.0]
    y[0, 0, :4] = [0.0, -3.0, 0.0, 0.0]
    mag, ang = tpolar.cart_to_polar(torch.as_tensor(x), torch.as_tensor(y))
    jmag, jang = jpolar.cart_to_polar(jnp.asarray(x), jnp.asarray(y))
    _close(mag, jmag)
    _close(ang, jang)
    _close(tpolar.fast_atan2_deg(torch.as_tensor(y), torch.as_tensor(x)),
           jpolar.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))


def test_wrappers_on_cpu_are_the_plain_versions():
    kernels.reset_launches()
    img = torch.as_tensor(_frames(2, 40, 60))
    assert torch.equal(gauss_resize(img, LEVEL_TAPS[1], 30, 20),
                       tcore.gaussian_blur_resize(img, LEVEL_TAPS[1], 30, 20))
    assert torch.equal(poly_exp(img, 5, 1.2, pre_taps=PRE_TAPS),
                       tcore.poly_exp(img, 5, 1.2, pre_taps=PRE_TAPS))
    R0, R1, flow = _texture_R(40, 60)
    for gaussian in (False, True):
        assert torch.equal(update_blur(R0, R1, flow, 15, gaussian),
                           tcore.update_step(R0, R1, flow, 15, gaussian))
        assert torch.equal(update_flow_fused(R0, R1, flow, 15, 3, gaussian),
                           tcore.update_flow(R0, R1, flow, 15, 3, gaussian))
    assert torch.equal(flow_to_bgr_planar(flow), colorize.flow_to_bgr_planar(flow))
    M = tcore.update_matrices(R0, R1, flow)
    assert torch.equal(update_matrices(R0, R1, flow), M)
    for gaussian in (False, True):
        assert torch.equal(blur_solve(M, 15, gaussian), tcore.blur_solve(M, 15, gaussian))
        ref = tcore.update_flow(R0, R1, flow, 63, 2, gaussian)
        assert torch.equal(update_flow(R0, R1, flow, 63, 2, gaussian), ref)
        assert torch.equal(update_flow_unfused(R0, R1, flow, 63, 2, gaussian), ref)
    with pytest.raises(ValueError):
        update_matrices(R0, R1, flow, out=M)          # out= is for CUDA tensors
    for gaussian in (False, True):
        assert torch.equal(update_blur_poly(img[:1], img[1:], flow[:1], 15, gaussian, 5, 1.2,
                                            PRE_TAPS),
                           tcore.update_step_poly(img[:1], img[1:], flow[:1], 15, gaussian,
                                                  5, 1.2, PRE_TAPS))
    assert kernels.LAUNCHES == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                "K5a": 0, "K5b": 0, "K6": 0, "K7": 0,
                                "X1": 0, "X2": 0}


def _jax_gauss_sum(M, winsize):
    k = jcore.gaussian_window_kernel(winsize)
    return jcore._corr1d(jcore._corr1d(jnp.asarray(M.numpy()), k, axis=-1), k, axis=-2)


@pytest.mark.parametrize("winsize", [3, 10, 15, 21])
def test_gaussian_window_sum_and_solve_match_jax(winsize):
    """The K5b oracle with the Gaussian window: the separable sum (the
    horizontal pass first, as JAX's `core.update_flow` does it), then the
    solve with scale 1."""
    R0, R1, flow = _texture_R(41, 67)
    M = tcore.update_matrices(R0, R1, flow)
    _close(tcore.gaussian_sum_replicate(M, winsize), _jax_gauss_sum(M, winsize))
    _close(tcore.blur_solve(M, winsize, True),
           jcore.solve_flow(_jax_gauss_sum(M, winsize), 1.0))


@pytest.mark.parametrize("winsize", [3, 10, 15, 21, 63])
def test_blur_solve_box_matches_jax(winsize):
    R0, R1, flow = _texture_R(41, 67)
    M = tcore.update_matrices(R0, R1, flow)
    ref = jcore.solve_flow(jcore.box_sum_replicate(jnp.asarray(M.numpy()), winsize),
                           1.0 / (winsize * winsize))
    _close(tcore.blur_solve(M, winsize, False), ref)


@pytest.mark.parametrize("winsize", [3, 10, 15, 21])
def test_update_flow_gaussian_matches_jax(winsize):
    """A 3-iteration level with the Gaussian window against JAX's
    `core.update_flow(..., gaussian=True)`."""
    R0, R1, flow = _texture_R(41, 67)
    j = [jnp.asarray(t.numpy()) for t in (R0, R1, flow)]
    ref = jcore.update_flow(*j, winsize, 3, gaussian=True)
    _close(tcore.update_flow(R0, R1, flow, winsize, 3, gaussian=True), ref)


@pytest.mark.parametrize("src,dst", [
    ((107, 193), (54, 97)), ((107, 193), (27, 48)), ((107, 193), (11, 20)),
    ((107, 193), (400, 30)),      # mixed: rows up (bilinear), columns down
    ((36, 64), (72, 129)),        # up on both axes: the bilinear resize
    ((72, 129), (72, 129))])
def test_resize_area_f32_matches_jax(src, dst):
    """The seed's INTER_AREA downsample: down, up and mixed, (h, w)."""
    x = (np.random.default_rng(5).standard_normal((2, 2) + src) * 4).astype(np.float32)
    dh, dw = dst
    got = tresize.resize_area_f32(torch.as_tensor(x), dw, dh)
    assert got.shape == (2, 2, dh, dw) and got.dtype == torch.float32
    _close(got, jresize.resize_area_f32(jnp.asarray(x), dw, dh), atol=1e-5, rtol=0)
    for s, d in ((src[0], dh), (src[1], dw)):
        ref = jresize._area_weights(s, d)
        if ref is not None:
            np.testing.assert_array_equal(tresize._area_weights(s, d), ref)


def test_k2_fits_up_to_poly_n_96():
    """K2's tile fits shared memory up to poly_n 96 (kMaxN in the
    kernel); the wrapper refuses beyond it on the card."""
    from optical_flow_tpu_torch.kernels.polyexp import k2_fits
    assert all(k2_fits(n) for n in (1, 5, 10, 11, 96))
    assert not k2_fits(97)
