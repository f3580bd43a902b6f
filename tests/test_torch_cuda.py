"""The CUDA kernels against their plain versions on the card, at shapes and
options that chip_smoke.py does not reach: frames smaller than a tile,
odd dims, float32 input, other window and expansion sizes, the wrappers'
input checks, the main path against the plain path on the CPU, the
visualizer's chained pyramid and K4 colorization, the unfused iterate
(K5a -> K5b) with the box and the Gaussian window, K1 with the Gaussian
window, the box window beyond K1's tile, the seeded entry, K6 (the
full-resolution Gaussian) at any tap count, the configs whose levels
K3 does not take (levels 4 and 5, pyr_scale 0.25) or whose expansion is
wider than cv2's (poly_n 11), K7 (the step with the expansion derived
in-kernel) against K2 -> K1 to the bit, alone, per level and on the
whole path with FUSE_POLYEXP on, and the strip-walking K1 and the
band-staging K3 at shapes that straddle their strip, ring and tile
edges, and the tile-staging K2 and strip-walking K5b equal to their plain
versions to the bit at tile edges, every 1080p level and row-block size.

These need an NVIDIA card and nvcc, and skip without them.  The card's
machine has no JAX, and tests/conftest.py imports it, so run them there
without the conftest, from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: K2, K3 and K5a atol=1e-4, rtol=1e-5, K1
and K5b one step atol=1e-3, rtol=1e-3 (the repo's Pallas-vs-XLA
tolerances); K6 equals its plain version to the bit, and K5a -> K5b
equals K1 to the bit with either window (same arithmetic, same sum
order); the
kernels are built with --fmad=false and follow their plain versions op
for op, so they agree to the bit in practice.  Whole-path flow uses the
share gate of chip_smoke.py (rare rint flips at .5 boundaries).  K4 is
held byte-equal to its plain version; the card's BGR to the CPU's by the
gate of tests/test_pallas_kernels.py:1289-1291 (at most 1 level, on at
most 1e-3 of the bytes), which a rint flip of the flow could need.
"""

import numpy as np
import pytest
import torch

from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.kernels.blur_solve import blur_solve
from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels import fused_iterate
from optical_flow_tpu_torch.kernels.fused_iterate import (update_flow,
                                                          update_flow_fused,
                                                          update_flow_fused_poly,
                                                          update_flow_unfused)
from optical_flow_tpu_torch.kernels.gauss import gaussian_blur
from optical_flow_tpu_torch.kernels.gauss_resize import gauss_resize, k3_fits
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.kernels.update_gather import (k1_fits, k7_fits,
                                                          update_blur,
                                                          update_blur_poly,
                                                          update_matrices)
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.models.farneback.flow import (
    calc_flow, calc_flow_batched, calc_flow_bgr_chain_batched,
    calc_flow_chain_batched)
from optical_flow_tpu_torch.models.farneback.params import (build_plan,
                                                            gaussian_kernel)
from optical_flow_tpu_torch.ops import colorize
from optical_flow_tpu_torch.oracle.synthetic import (motion_boundary_pair,
                                                     smooth_texture_pair)
from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums
from optical_flow_tpu_torch.utils.config import FarnebackConfig

pytestmark = pytest.mark.cuda

STENCIL_TOL = dict(atol=1e-4, rtol=1e-5)
STEP_TOL = dict(atol=1e-3, rtol=1e-3)
LEVEL_TAPS = {1: gaussian_kernel(3, 0.5), 2: gaussian_kernel(9, 1.5),
              3: gaussian_kernel(19, 3.5)}
PRE_TAPS = gaussian_kernel(3, 0.0)


@pytest.fixture
def dev():
    """The first CUDA card, with TF32 off; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    return torch.device("cuda", 0)


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)


def _close(got, ref, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **tol)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("k,h,w,oh,ow", [
    (1, 72, 129, 36, 64),     # the extractor's L1: 129 does not divide by 2
    (2, 37, 53, 9, 13),
    (3, 41, 67, 5, 8),
    (1, 5, 7, 3, 4),          # frame smaller than one output tile
    (2, 20, 24, 31, 40),      # upscale: each source column feeds many outputs
])
def test_gauss_resize_kernel(dev, k, h, w, oh, ow, dtype):
    img = _frames(3, h, w)
    if dtype == "f32":
        img = img.astype(np.float32) / 7.0
    img = torch.as_tensor(img).to(dev)
    got = gauss_resize(img, LEVEL_TAPS[k], ow, oh)
    assert got.shape == (3, oh, ow) and got.dtype == torch.float32
    _close(got, core.gaussian_blur_resize(img, LEVEL_TAPS[k], ow, oh), STENCIL_TOL)
    assert kernels.LAUNCHES["K3"] == 1


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("h,w,poly_n,poly_sigma", [
    (37, 53, 5, 1.2), (5, 7, 5, 1.2), (33, 257, 7, 1.5), (2, 40, 3, 0.0),
    (37, 53, 11, 2.4), (45, 61, 13, 0.0)])
def test_poly_exp_kernel(dev, h, w, poly_n, poly_sigma, pre, dtype):
    img = _frames(2, h, w, seed=1)
    if dtype == "f32":
        img = img.astype(np.float32) * 0.5 - 10.0
    img = torch.as_tensor(img).to(dev)
    taps = PRE_TAPS if pre else None
    got = poly_exp(img, poly_n, poly_sigma, pre_taps=taps)
    assert got.shape == (2, 5, h, w)
    _close(got, core.poly_exp(img, poly_n, poly_sigma, pre_taps=taps), STENCIL_TOL)
    assert kernels.LAUNCHES["K2"] == 1


@pytest.mark.parametrize("h,w,winsize", [
    (37, 53, 15), (5, 7, 15), (72, 129, 9), (40, 70, 21), (33, 47, 1),
    (45, 61, 10)])
def test_update_blur_kernel(dev, h, w, winsize):
    """One step and a 3-step level loop, on R of a texture pair and a
    random flow of up to 6 px, so that fetches leave the image."""
    f1, f2 = smooth_texture_pair(h, w, (1, 2))
    R = core.poly_exp(torch.as_tensor(np.stack([f1, f1, f2, f2])).to(dev), 5, 1.2)
    flow = (torch.as_tensor(np.random.default_rng(2).random((2, 2, h, w)),
                            dtype=torch.float32) - 0.5).to(dev) * 12.0
    R0, R1 = R[:2].contiguous(), R[2:].contiguous()
    _close(update_blur(R0, R1, flow, winsize),
           core.update_step(R0, R1, flow, winsize), STEP_TOL)
    kept = flow.clone()
    _close(update_flow_fused(R0, R1, flow, winsize, 3),
           core.update_flow(R0, R1, flow, winsize, 3), STEP_TOL)
    assert torch.equal(flow, kept)            # the caller's flow is not written
    assert kernels.LAUNCHES["K1"] == 4


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    img = torch.zeros((2, 40, 64), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        gauss_resize(img.to(torch.int32), LEVEL_TAPS[1], 32, 20)
    with pytest.raises(ValueError):
        gauss_resize(img[:, :, ::2], LEVEL_TAPS[1], 16, 20)       # not contiguous
    with pytest.raises(ValueError):
        gauss_resize(img, [0.5, 0.5], 32, 20)                     # even tap count
    with pytest.raises(ValueError):
        gauss_resize(img[:, :9], LEVEL_TAPS[3], 32, 5)            # frame <= radius
    with pytest.raises(ValueError):
        poly_exp(img[0], 5, 1.2)                                  # (H, W)
    with pytest.raises(ValueError):
        poly_exp(img, 97, 1.2)                                    # beyond the tile
    with pytest.raises(ValueError):
        gaussian_blur(img, [0.5, 0.5])                            # even tap count
    with pytest.raises(TypeError):
        gaussian_blur(img.to(torch.int32), LEVEL_TAPS[1])
    with pytest.raises(ValueError):
        gaussian_blur(img, LEVEL_TAPS[1], out=torch.empty((2, 40, 64), device=dev).cpu())
    R = torch.zeros((1, 5, 20, 32), device=dev)
    flow = torch.zeros((1, 2, 20, 32), device=dev)
    with pytest.raises(ValueError):
        update_blur(R, R, flow, 15, out=flow)                     # in place
    with pytest.raises(ValueError):
        update_blur(R, R[:, :, :10].contiguous(), flow, 15)
    with pytest.raises(ValueError):
        update_blur(R, R.cpu(), flow, 15)
    with pytest.raises(TypeError):
        flow_to_bgr_planar(flow.double())                         # dtype
    with pytest.raises(ValueError):
        flow_to_bgr_planar(flow[0])                               # rank
    with pytest.raises(ValueError):
        flow_to_bgr_planar(R)                                     # 5 channels
    with pytest.raises(ValueError):
        flow_to_bgr_planar(flow[:, :, :, ::2])                    # not contiguous
    with pytest.raises(ValueError):
        flow_to_bgr_planar(flow.to("meta"))                       # device
    with pytest.raises(ValueError):
        update_blur(R, R, flow, 63)                               # beyond K1's tile
    with pytest.raises(ValueError):
        update_matrices(R, R, flow, out=R)                        # in place
    with pytest.raises(ValueError):
        update_matrices(R, R, flow[:, :1].contiguous())           # 1 flow channel
    with pytest.raises(ValueError):
        blur_solve(R[:, :4].contiguous(), 15, False)              # 4 channels
    with pytest.raises(ValueError):
        blur_solve(R, 1, True)                                    # Gaussian winsize 1
    with pytest.raises(TypeError):
        blur_solve(R.double(), 15, True)
    assert kernels.LAUNCHES == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                "K5a": 0, "K5b": 0, "K6": 0, "K7": 0}


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("ntaps,h,w", [
    (3, 37, 53), (39, 97, 161), (79, 97, 161), (79, 120, 200), (39, 40, 41),
    (249, 260, 300),          # r = 124 >= 100
    (79, 30, 45),             # frame within the radius: more than one reflection
    (1, 5, 7)])
def test_gaussian_blur_kernel(dev, ntaps, h, w, dtype):
    """K6 against its plain version, to the bit."""
    img = _frames(3, h, w, seed=ntaps)
    if dtype == "f32":
        img = img.astype(np.float32) / 7.0 - 3.0
    img = torch.as_tensor(img).to(dev)
    taps = gaussian_kernel(ntaps, (ntaps - 1) / 5)
    got = gaussian_blur(img, taps)
    assert got.shape == (3, h, w) and got.dtype == torch.float32
    ref = core.gaussian_blur_reflect101(img, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.LAUNCHES["K6"] == 1


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("h,w", [(1080, 1920), (37, 1001), ("r", 300)])
@pytest.mark.parametrize("ntaps", [3, 39, 79, 159])
def test_gaussian_blur_kernel_at_the_pyramids_taps(dev, ntaps, h, w, dtype):
    """K6 at the pyramids' tap counts on a 1080p batch, an odd 37x1001
    frame and a frame whose height is at most the radius ("r": reflected
    more than once), uint8 and f32: equal to its plain version."""
    r = ntaps // 2
    h = max(1, r) if h == "r" else h
    img = _frames(2, h, w, seed=ntaps + h)
    if dtype == "f32":
        img = img.astype(np.float32) / 7.0 - 3.0
    img = torch.as_tensor(img).to(dev)
    taps = gaussian_kernel(ntaps, (ntaps - 1) / 5)
    got = gaussian_blur(img, taps)
    ref = core.gaussian_blur_reflect101(img, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kernels.LAUNCHES["K6"] == 1


@pytest.mark.parametrize("pair", ["smooth", "boundary"])
@pytest.mark.parametrize("h,w", [(96, 128), (72, 129), (37, 53)])
def test_main_path_on_the_card_matches_the_cpu(dev, h, w, pair):
    """calc_flow_batched through the kernels (numpy frames uploaded as
    uint8) against the plain path on the CPU, which the CPU tests hold
    to the JAX package."""
    f1, f2 = (smooth_texture_pair(h, w, (2, 3)) if pair == "smooth"
              else motion_boundary_pair(h, w))
    prev, nxt = np.stack([f1, f2]), np.stack([f2, f1])
    got = calc_flow_batched(prev, nxt, device=dev)
    assert got.is_cuda and got.shape == (2, h, w, 2)
    n_levels = kernels.LAUNCHES["K2"]
    assert kernels.LAUNCHES == {"K1": 3 * n_levels, "K2": n_levels,
                                "K3": n_levels - 1, "K4": 0, "K5a": 0, "K5b": 0,
                                "K6": 0, "K7": 0}
    ref = calc_flow_batched(prev, nxt, device="cpu")
    d = (got.cpu() - ref).abs()
    assert float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean()) >= 0.999
    assert float(d.mean()) <= 1e-3
    sums = magnitude_sums(torch.as_tensor(prev).to(dev),
                          torch.as_tensor(nxt).to(dev), FarnebackConfig())
    torch.testing.assert_close(sums.cpu(), magnitude_sums(prev, nxt, device="cpu"),
                               rtol=1e-4, atol=0.0)


def test_float_frames_on_the_card(dev):
    f1, f2 = smooth_texture_pair(72, 129, (2, 3))
    prev = torch.as_tensor(f1[None].astype(np.float32)).to(dev)
    nxt = torch.as_tensor(f2[None].astype(np.float32)).to(dev)
    got = calc_flow_batched(prev, nxt)
    ref = calc_flow_batched(prev, nxt, plain=True)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    assert float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean()) >= 0.999
    assert kernels.LAUNCHES["K1"] > 0


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (33, 257)])
def test_colorize_kernel(dev, h, w, B):
    """Random flow of up to 6 px plus one all-zero frame (constant
    magnitude: value 0 everywhere); byte-equal to the plain version."""
    flow = (np.random.default_rng(4).random((B, 2, h, w)) - 0.5) * 12.0
    flow[-1] = 0.0
    flow = torch.as_tensor(flow, dtype=torch.float32).to(dev)
    got = flow_to_bgr_planar(flow)
    assert got.shape == (B, 3, h, w) and got.dtype == torch.uint8
    ref = colorize.flow_to_bgr_planar(flow)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got.cpu(), colorize.flow_to_bgr_planar(flow.cpu()))
    assert kernels.LAUNCHES["K4"] == 1


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("h,w", [(1079, 1917), (1080, 1920)])
def test_colorize_kernel_at_the_visualizer_shapes(dev, h, w, B):
    """K4 at the visualizer's chunk and at one pair, on an odd frame (its
    planes unaligned: scalar quads) and a 1080p one (16-byte loads), with
    an all-zero frame last: byte-equal to the plain version."""
    flow = (np.random.default_rng(B + h).random((B, 2, h, w), dtype=np.float32)
            - 0.5) * 12.0
    if B > 1:
        flow[-1] = 0.0
    flow = torch.as_tensor(flow).to(dev)
    got = flow_to_bgr_planar(flow)
    ref = colorize.flow_to_bgr_planar(flow)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if B > 1:
        assert not bool(got[-1].any())
    zero = flow_to_bgr_planar(torch.zeros((1, 2, h, w), device=dev))
    torch.cuda.synchronize()
    assert not bool(zero.any())
    assert kernels.LAUNCHES["K4"] == 2


@pytest.mark.parametrize("h,w", [(72, 129), (37, 53)])
def test_chain_on_the_card(dev, h, w):
    """The chained flow equals the batched flow of the same pairs to the
    bit, and the card's BGR matches the CPU plain path's."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    b1, _ = motion_boundary_pair(h, w)
    frames = np.stack([f1, f2, f1, b1])
    got = torch.as_tensor(frames).to(dev)
    chain = calc_flow_chain_batched(got)
    pairs = calc_flow_batched(got[:-1], got[1:])
    torch.cuda.synchronize()
    assert torch.equal(chain, pairs)
    kernels.reset_launches()
    bgr = calc_flow_bgr_chain_batched(got)
    n_levels = kernels.LAUNCHES["K2"]
    assert kernels.LAUNCHES == {"K1": 3 * n_levels, "K2": n_levels,
                                "K3": n_levels - 1, "K4": 1, "K5a": 0, "K5b": 0,
                                "K6": 0, "K7": 0}
    ref = calc_flow_bgr_chain_batched(frames, device="cpu").numpy()
    d = np.abs(bgr.cpu().numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= 1e-3


WINSIZES = [1, 3, 10, 15, 21, 63]


def _step_operands(dev, h, w):
    """R of a texture pair (B=2) and a random flow of up to 6 px."""
    f1, f2 = smooth_texture_pair(h, w, (1, 2))
    R = core.poly_exp(torch.as_tensor(np.stack([f1, f1, f2, f2])).to(dev), 5, 1.2)
    flow = (torch.as_tensor(np.random.default_rng(2).random((2, 2, h, w)),
                            dtype=torch.float32) - 0.5).to(dev) * 12.0
    return R[:2].contiguous(), R[2:].contiguous(), flow


def _share_close(got, ref):
    """The share gate of chip_smoke.py's whole-path checks."""
    d = (got.cpu() - ref.cpu()).abs()
    assert float((d <= 2e-3 + 1e-3 * ref.cpu().abs()).float().mean()) >= 0.999
    assert float(d.mean()) <= 1e-3


@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (72, 129)])
def test_update_matrices_kernel(dev, h, w):
    R0, R1, flow = _step_operands(dev, h, w)
    got = update_matrices(R0, R1, flow)
    assert got.shape == (2, 5, h, w)
    _close(got, core.update_matrices(R0, R1, flow), STENCIL_TOL)
    assert kernels.LAUNCHES["K5a"] == 1


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("winsize", WINSIZES)
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (72, 129)])
def test_blur_solve_kernel(dev, h, w, winsize, gaussian):
    """One K5b launch, then a 3-step K5a -> K5b level loop, against the
    plain versions; winsize 63 is beyond K1's tile."""
    R0, R1, flow = _step_operands(dev, h, w)
    M = core.update_matrices(R0, R1, flow)
    if gaussian and winsize == 1:
        with pytest.raises(ValueError):      # the reference's sigma-0 window
            blur_solve(M, winsize, gaussian)
        assert kernels.LAUNCHES["K5b"] == 0
        return
    _close(blur_solve(M, winsize, gaussian), core.blur_solve(M, winsize, gaussian),
           STEP_TOL)
    kept = flow.clone()
    _close(update_flow_unfused(R0, R1, flow, winsize, 3, gaussian),
           core.update_flow(R0, R1, flow, winsize, 3, gaussian), STEP_TOL)
    assert torch.equal(flow, kept)            # the caller's flow is not written
    assert kernels.LAUNCHES == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                "K5a": 3, "K5b": 4, "K6": 0, "K7": 0}


@pytest.mark.parametrize("winsize", [1, 3, 10, 15, 21, 61])
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (72, 129)])
def test_unfused_box_step_equals_k1(dev, h, w, winsize):
    """K5a -> K5b with the box window is K1's arithmetic in K1's order:
    equal to the bit, one step and a 3-step level."""
    R0, R1, flow = _step_operands(dev, h, w)
    got = blur_solve(update_matrices(R0, R1, flow), winsize, False)
    ref = update_blur(R0, R1, flow, winsize)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(update_flow_unfused(R0, R1, flow, winsize, 3),
                       update_flow_fused(R0, R1, flow, winsize, 3))


@pytest.mark.parametrize("winsize", [3, 15, 21])
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (72, 129)])
def test_unfused_gaussian_step_equals_k1(dev, h, w, winsize):
    """K1 with the Gaussian window sums in K5b's order: equal to K5a ->
    K5b to the bit, one step and a 3-step level, and held to the plain
    version."""
    R0, R1, flow = _step_operands(dev, h, w)
    got = blur_solve(update_matrices(R0, R1, flow), winsize, True)
    ref = update_blur(R0, R1, flow, winsize, True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    _close(ref, core.update_step(R0, R1, flow, winsize, True), STEP_TOL)
    assert torch.equal(update_flow_unfused(R0, R1, flow, winsize, 3, True),
                       update_flow_fused(R0, R1, flow, winsize, 3, True))


@pytest.mark.parametrize("gaussian", [False, True])
def test_update_blur_kernel_past_8k_width(dev, gaussian):
    """K1 at a width past 7680 (the TPU's column-chunked K8 there) on a
    cheap height, against its plain version."""
    R0, R1, flow = _step_operands(dev, 40, 7700)
    _close(update_blur(R0, R1, flow, 15, gaussian),
           core.update_step(R0, R1, flow, 15, gaussian), STEP_TOL)


def test_update_flow_picks_by_window(dev):
    R0, R1, flow = _step_operands(dev, 37, 53)
    for winsize, gaussian, path in ((15, False, "K1"), (61, False, "K1"),
                                    (63, False, "K5b"), (15, True, "K1"),
                                    (3, True, "K1"), (61, True, "K1"),
                                    (63, True, "K5b")):
        kernels.reset_launches()
        update_flow(R0, R1, flow, winsize, 2, gaussian)
        assert kernels.LAUNCHES[path] == 2, (winsize, gaussian)
        assert kernels.LAUNCHES["K5a"] == (2 if path == "K5b" else 0)


@pytest.mark.parametrize("flags,winsize", [(0, 63), (256, 15), (256, 63),
                                           (260, 10)])
@pytest.mark.parametrize("h,w", [(96, 128), (72, 129)])
def test_unfused_path_on_the_card_matches_the_cpu(dev, h, w, flags, winsize):
    """calc_flow_batched with a Gaussian window (K1 up to winsize 61) or a
    box too large for K1's tile (winsize 63: K5a -> K5b) against the
    plain path on the CPU, with the launch counts of every level."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    prev, nxt = np.stack([f1, f2]), np.stack([f2, f1])
    seed = (np.random.default_rng(3).standard_normal((2, h, w, 2)) * 2).astype(np.float32)
    cfg = FarnebackConfig(winsize=winsize, flags=flags)
    got = calc_flow_batched(prev, nxt, cfg, seed, device=dev)
    n_levels = kernels.LAUNCHES["K2"]
    steps = 3 * n_levels
    k1 = k1_fits(winsize)
    assert kernels.LAUNCHES == {"K1": steps if k1 else 0, "K2": n_levels,
                                "K3": n_levels - 1, "K4": 0,
                                "K5a": 0 if k1 else steps,
                                "K5b": 0 if k1 else steps, "K6": 0, "K7": 0}
    _share_close(got, calc_flow_batched(prev, nxt, cfg, seed, device="cpu"))


@pytest.mark.parametrize("flags", [4, 260])
def test_calc_flow_on_the_card(dev, flags):
    """The single-pair entry equals the batch's first pair, and the seeded
    box path runs on K1 and matches the CPU."""
    f1, f2 = smooth_texture_pair(72, 129, (2, 3))
    seed = (np.random.default_rng(4).standard_normal((2, 72, 129, 2))
            + (-3.0, -2.0)).astype(np.float32)
    cfg = FarnebackConfig(flags=flags)
    prev = torch.as_tensor(np.stack([f1, f2])).to(dev)
    nxt = torch.as_tensor(np.stack([f2, f1])).to(dev)
    batch = calc_flow_batched(prev, nxt, cfg, torch.as_tensor(seed).to(dev))
    one = calc_flow(prev[0], nxt[0], cfg, seed[0])
    torch.cuda.synchronize()
    assert one.is_cuda and torch.equal(one, batch[0])
    assert kernels.LAUNCHES["K1"] > 0
    _share_close(batch, calc_flow_batched(prev.cpu(), nxt.cpu(), cfg, seed))


def _k6_levels(h, w, cfg):
    return sum(1 for lv in build_plan(h, w, cfg).levels
               if lv.k > 0 and not k3_fits(lv.smooth_ksize, h, w, lv.width))


@pytest.mark.parametrize("h,w,config", [
    (1080, 1920, dict(levels=4)),           # L4 68x120: 39 taps
    (1080, 1920, dict(levels=5)),           # and L5 34x60: 79 taps
    (1080, 1920, dict(pyr_scale=0.25)),     # L2 68x120: 39 taps
    (1080, 1920, dict(poly_n=11, poly_sigma=2.4)),
    (720, 1280, dict(levels=5)),            # L4 45x80: 39 taps
])
def test_deep_configs_on_the_card_match_the_plain_path(dev, h, w, config):
    """calc_flow_batched on the card at the configs the kernels refused
    before (K3 past 32 taps, K2 past poly_n 10), with K6 and the bilinear
    resize on the levels K3 does not take, against the plain path on the
    card (B=1)."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    prev = torch.as_tensor(f1[None]).to(dev)
    nxt = torch.as_tensor(f2[None]).to(dev)
    cfg = FarnebackConfig(**config)
    got = calc_flow_batched(prev, nxt, cfg)
    n_levels = len(build_plan(h, w, cfg).levels)
    n_k6 = _k6_levels(h, w, cfg)
    assert kernels.LAUNCHES == {"K1": 3 * n_levels, "K2": n_levels,
                                "K3": n_levels - 1 - n_k6, "K4": 0, "K5a": 0,
                                "K5b": 0, "K6": n_k6, "K7": 0}
    _share_close(got, calc_flow_batched(prev, nxt, cfg, plain=True))


@pytest.mark.parametrize("h,w,config", [(1024, 1024, dict(levels=5)),
                                        (512, 512, dict(pyr_scale=0.25))])
def test_deep_configs_on_the_card_match_the_cpu(dev, h, w, config):
    """The same against the plain path on the CPU, which the CPU tests
    hold to the JAX package; both K6 levels at 1024x1024, levels=5."""
    f1, f2 = smooth_texture_pair(h, w, (2, 3))
    prev, nxt = np.stack([f1, f2]), np.stack([f2, f1])
    cfg = FarnebackConfig(**config)
    got = calc_flow_batched(prev, nxt, cfg, device=dev)
    assert kernels.LAUNCHES["K6"] == _k6_levels(h, w, cfg) > 0
    _share_close(got, calc_flow_batched(prev, nxt, cfg, device="cpu"))


def _poly_operands(dev, h, w, kind, amplitude, B=2):
    """Level images of a texture pair (uint8 with the level-0 pre-smooth,
    or f32) and a random flow of up to `amplitude` px."""
    f1, f2 = smooth_texture_pair(h, w, (1, 2))
    img0 = np.stack([f1, f2] * B)[:B]
    img1 = np.stack([f2, f1] * B)[:B]
    pre = PRE_TAPS if kind.endswith("pre") else None
    if kind.startswith("f32"):
        img0 = img0.astype(np.float32) * 0.7 + 3.0
        img1 = img1.astype(np.float32) * 0.7 + 3.0
    rng = np.random.default_rng(h * w + int(amplitude))
    flow = ((rng.random((B, 2, h, w)) - 0.5) * 2 * amplitude).astype(np.float32)
    return (torch.as_tensor(img0).to(dev), torch.as_tensor(img1).to(dev),
            torch.as_tensor(flow).to(dev), pre)


def _k7_against_k2_k1(dev, h, w, winsize, gaussian, poly_n, kind):
    sigma = 0.3 * poly_n
    for amplitude in (6.0, 40.0):     # fetches beyond the image at ±40 px
        img0, img1, flow, pre = _poly_operands(dev, h, w, kind, amplitude)
        kernels.reset_launches()
        got = update_blur_poly(img0, img1, flow, winsize, gaussian, poly_n, sigma, pre)
        R0 = poly_exp(img0, poly_n, sigma, pre_taps=pre)
        R1 = poly_exp(img1, poly_n, sigma, pre_taps=pre)
        ref = update_blur(R0, R1, flow, winsize, gaussian)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), float((got - ref).abs().max())
        assert kernels.LAUNCHES["K7"] == 1
        _close(got, core.update_step_poly(img0, img1, flow, winsize, gaussian,
                                          poly_n, sigma, pre), STEP_TOL)


K7_WINDOWS = [(1, False), (3, False), (3, True), (15, False), (15, True),
              (61, False), (61, True)]


@pytest.mark.parametrize("kind", ["u8_pre", "f32", "f32_pre"])
@pytest.mark.parametrize("winsize,gaussian", K7_WINDOWS)
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (33, 130)])
def test_update_blur_poly_kernel(dev, h, w, winsize, gaussian, kind):
    """K7 at poly_n 5 against K2 -> K1 on the same inputs, to the bit, and
    against its plain version; frames smaller than a tile and odd sizes."""
    _k7_against_k2_k1(dev, h, w, winsize, gaussian, 5, kind)


@pytest.mark.parametrize("kind", ["u8_pre", "f32"])
@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("winsize", [15, 61])
@pytest.mark.parametrize("poly_n", [3, 7])
def test_update_blur_poly_kernel_poly_n(dev, poly_n, winsize, gaussian, kind):
    _k7_against_k2_k1(dev, 37, 53, winsize, gaussian, poly_n, kind)


def test_update_blur_poly_rejects_what_it_does_not_take(dev):
    img0, img1, flow, pre = _poly_operands(dev, 20, 32, "u8_pre", 6.0)
    assert not k7_fits(63, 5) and k7_fits(61, 5) and k7_fits(61, 7)
    with pytest.raises(ValueError):
        update_blur_poly(img0, img1, flow, 63, False, 5, 1.2, pre)   # beyond the tile
    with pytest.raises(ValueError):
        update_blur_poly(img0, img1, flow, 15, False, 97, 1.2, pre)  # poly_n
    with pytest.raises(TypeError):
        update_blur_poly(img0, img1.float(), flow, 15, False, 5, 1.2, pre)
    with pytest.raises(ValueError):
        update_blur_poly(img0, img1[:, :10].contiguous(), flow, 15, False, 5, 1.2, pre)
    with pytest.raises(ValueError):
        update_blur_poly(img0, img1, flow, 15, False, 5, 1.2, pre, out=flow)
    with pytest.raises(ValueError):
        update_blur_poly(img0, img1, flow, 1, True, 5, 1.2, pre)     # sigma-0 window
    with pytest.raises(ValueError):
        update_blur_poly(img0[:, :1].contiguous(), img1[:, :1].contiguous(),
                         flow[:, :, :1].contiguous(), 15, False, 5, 1.2, pre)  # 1 row
    assert kernels.LAUNCHES["K7"] == 0


@pytest.mark.parametrize("gaussian", [False, True])
def test_update_flow_fused_poly_equals_k2_k1(dev, gaussian):
    """A 3-step level on K7 equals K2 once, then 3 K1 steps, to the bit."""
    img0, img1, flow, pre = _poly_operands(dev, 72, 129, "u8_pre", 6.0)
    kept = flow.clone()
    got = update_flow_fused_poly(img0, img1, flow, 15, 3, gaussian, poly_n=5,
                                 poly_sigma=1.2, pre_taps=pre)
    ref = update_flow_fused(poly_exp(img0, 5, 1.2, pre_taps=pre),
                            poly_exp(img1, 5, 1.2, pre_taps=pre), flow, 15, 3, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(flow, kept)
    assert kernels.LAUNCHES["K7"] == 3


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("flags", [0, 256])
def test_fuse_polyexp_switch_on_the_card(dev, monkeypatch, flags, chain):
    """calc_flow_batched (and the chain) with FUSE_POLYEXP on: every level
    on K7, no K2 and no K1, and the flow of the switch-off run to the
    bit."""
    f1, f2 = smooth_texture_pair(96, 128, (2, 3))
    frames = torch.as_tensor(np.stack([f1, f2, f1])).to(dev)
    cfg = FarnebackConfig(flags=flags)

    def run():
        if chain:
            return calc_flow_chain_batched(frames, cfg)
        return calc_flow_batched(frames[:2], frames[1:], cfg)

    off = run()
    monkeypatch.setattr(fused_iterate, "FUSE_POLYEXP", True)
    kernels.reset_launches()
    on = run()
    torch.cuda.synchronize()
    n_levels = len(build_plan(96, 128, cfg).levels)
    assert kernels.LAUNCHES == {"K1": 0, "K2": 0, "K3": n_levels - 1, "K4": 0,
                                "K5a": 0, "K5b": 0, "K6": 0, "K7": 3 * n_levels}
    assert torch.equal(on, off)


def test_extract_frames_on_the_card(dev):
    """The extractor's device loop on the card (chunks of 3 pairs, frames
    uploaded one by one through pinned memory) against the plain path on
    the card and on the CPU: the same windows, sums within 1e-4 rel."""
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.utils.config import ExtractorConfig

    windows, _ = extractor._window_schedule(60, 25.0, 300, 300)
    todo = list(enumerate(windows))
    needed = sorted({f for _, win in todo for f in win})
    seq = list(zip(needed, translating_clip(72, 129, [min(f, 40) for f in needed])))

    def run(**kw):
        return extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=3, **kw)

    got = run(device=dev)
    assert kernels.LAUNCHES["K1"] > 0 and kernels.LAUNCHES["K7"] == 0
    for ref in (run(device=dev, plain=True), run(device="cpu")):
        assert sorted(got) == sorted(ref) == list(range(len(todo)))
        for i, (s, e, v) in got.items():
            assert (s, e) == ref[i][:2]
            assert abs(v - ref[i][2]) <= 1e-4 * abs(ref[i][2])


STRIP_SHAPES = [(1, 1), (2, 2), (31, 33), (33, 31), (65, 65), (1, 65), (65, 2)]
STRIP_WINDOWS = [(1, False), (3, False), (3, True), (15, False), (15, True),
                 (31, False), (31, True), (61, False), (61, True)]


def _wide_operands(dev, B, h, w, amplitude, seed=5):
    """Random R0, R1 (B, 5, h, w) and a flow of up to `amplitude` px."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((2 * B, 5, h, w)).astype(np.float32)
    flow = ((rng.random((B, 2, h, w)) - 0.5) * 2 * amplitude).astype(np.float32)
    return (torch.as_tensor(R[:B]).to(dev), torch.as_tensor(R[B:]).to(dev),
            torch.as_tensor(flow).to(dev))


@pytest.mark.parametrize("winsize,gaussian", STRIP_WINDOWS)
@pytest.mark.parametrize("h,w", STRIP_SHAPES)
def test_update_blur_strip_edges(dev, h, w, winsize, gaussian):
    """K1 at H and W of 1, 2, the strip width (32) +- 1 and twice it + 1,
    B = 3, a +-40 px flow: equal to K5a -> K5b to the bit and to its
    plain version within the step tolerance."""
    R0, R1, flow = _wide_operands(dev, 3, h, w, 40.0)
    got = update_blur(R0, R1, flow, winsize, gaussian)
    unfused = blur_solve(update_matrices(R0, R1, flow), winsize, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, unfused), float((got - unfused).abs().max())
    _close(got, core.update_step(R0, R1, flow, winsize, gaussian), STEP_TOL)
    assert kernels.LAUNCHES["K1"] == 1


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("h,w,B", [(300, 7680, 3), (97, 7680, 1)])
def test_update_blur_width_7680(dev, h, w, B, gaussian):
    """K1 at width 7680 (the 8K row's), 256-row blocks at B = 3 (the
    grid fills the card; the second block of a strip walks 44 rows) and
    32-row blocks at B = 1, equal to K5a -> K5b to the bit."""
    from optical_flow_tpu_torch.kernels import update_gather
    R0, R1, flow = _wide_operands(dev, B, h, w, 40.0)
    rows = update_gather._rows_per_block(B, h, w, dev)
    assert rows == (256 if B == 3 else 32)
    got = update_blur(R0, R1, flow, 15, gaussian)
    unfused = blur_solve(update_matrices(R0, R1, flow), 15, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, unfused)
    _close(got, core.update_step(R0, R1, flow, 15, gaussian), STEP_TOL)


def _level_cases():
    """(h, w, ntaps, out_h, out_w) at the small shapes with every tap
    count, then each K3 level of the 1080p and the 8K pyramid."""
    cases = [(h, w, ntaps, max(h // 2, 1), max(w // 2, 1))
             for h, w in ((37, 53), (72, 129), (33, 257)) for ntaps in (3, 9, 19, 31)]
    for h, w in ((1080, 1920), (4320, 7680)):
        for lv in build_plan(h, w, FarnebackConfig()).levels:
            if lv.k > 0:
                cases.append((h, w, lv.smooth_ksize, lv.height, lv.width))
    return cases


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("h,w,ntaps,oh,ow", _level_cases())
def test_gauss_resize_kernel_bit_equal(dev, h, w, ntaps, oh, ow, dtype):
    """K3 against its plain version, to the bit, uint8 and f32 frames."""
    n = 2 if h * w > 10 ** 6 else 3
    img = _frames(n, h, w, seed=ntaps)
    if dtype == "f32":
        img = img.astype(np.float32) / 7.0 - 3.0
    img = torch.as_tensor(img).to(dev)
    taps = gaussian_kernel(ntaps, 0.3 * ((ntaps - 1) * 0.5 - 1) + 0.8)
    got = gauss_resize(img, taps, ow, oh)
    ref = core.gaussian_blur_resize(img, taps, ow, oh)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    # an unaligned start: the scalar staging path at the same shapes
    if h * w < 10 ** 6:
        odd = torch.empty(img.numel() + 1, dtype=img.dtype, device=dev)[1:].view(img.shape)
        odd.copy_(img)
        assert torch.equal(gauss_resize(odd, taps, ow, oh), ref)
    assert kernels.LAUNCHES["K3"] >= 1


K2_BIT_SHAPES = [(37, 53), (17, 129), (2, 40), (40, 2), (3, 3), (3, 200), (5, 7)]


@pytest.mark.parametrize("kind", ["u8_pre", "f32"])
@pytest.mark.parametrize("poly_n", [1, 2, 5, 7, 11, 96])
@pytest.mark.parametrize("h,w", K2_BIT_SHAPES)
def test_poly_exp_kernel_bit_equal(dev, h, w, poly_n, kind):
    """K2 against its plain version to the bit: heights and widths that
    are not multiples of the tile, frames of 2 and 3 rows or columns and
    narrower than the halo, uint8 with the pre-smooth and f32 without;
    also from an unaligned start (the scalar band path)."""
    img = _frames(3, h, w, seed=poly_n)
    pre = PRE_TAPS if kind == "u8_pre" else None
    if kind == "f32":
        img = img.astype(np.float32) * 0.37 - 20.0
    img = torch.as_tensor(img).to(dev)
    sigma = 0.3 * poly_n if poly_n > 2 else 1.1
    ref = core.poly_exp(img, poly_n, sigma, pre_taps=pre)
    got = poly_exp(img, poly_n, sigma, pre_taps=pre)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    odd = torch.empty(img.numel() + 1, dtype=img.dtype, device=dev)[1:].view(img.shape)
    odd.copy_(img)
    assert torch.equal(poly_exp(odd, poly_n, sigma, pre_taps=pre), ref)
    assert kernels.LAUNCHES["K2"] == 2


def _levels_1080p():
    return [(lv.k, lv.height, lv.width)
            for lv in build_plan(1080, 1920, FarnebackConfig()).levels]


@pytest.mark.parametrize("k,h,w", _levels_1080p())
def test_poly_exp_kernel_1080p_levels(dev, k, h, w):
    """K2 at each 1080p level's shape (uint8 frames with the pre-smooth at
    level 0, f32 levels above), equal to its plain version, and K7 equal
    to K2 -> K1 there, box and Gaussian window."""
    kind = "u8_pre" if k == 0 else "f32"
    img0, img1, flow, pre = _poly_operands(dev, h, w, kind, 6.0)
    R = poly_exp(torch.cat([img0, img1]), 5, 1.2, pre_taps=pre)
    ref = core.poly_exp(torch.cat([img0, img1]), 5, 1.2, pre_taps=pre)
    torch.cuda.synchronize()
    assert torch.equal(R, ref), float((R - ref).abs().max())
    for gaussian in (False, True):
        got = update_blur_poly(img0, img1, flow, 15, gaussian, 5, 1.2, pre)
        split = update_blur(R[:2], R[2:], flow, 15, gaussian)
        torch.cuda.synchronize()
        assert torch.equal(got, split), float((got - split).abs().max())


K5B_WINDOWS = [(w, g) for w in (1, 2, 3, 15, 61, 62, 63, 64, 127, 201, 301)
               for g in (False, True) if not (g and w == 1)]


@pytest.mark.parametrize("winsize,gaussian", K5B_WINDOWS)
@pytest.mark.parametrize("h,w", [(5, 7), (37, 53), (72, 129), (33, 130)])
def test_blur_solve_kernel_bit_equal(dev, h, w, winsize, gaussian):
    """K5b against its plain version to the bit: odd shapes, frames
    smaller than the window, the strip kernel up to winsize 261 and the
    tile kernel beyond it (301); also from an unaligned M (scalar
    staging)."""
    from optical_flow_tpu_torch.kernels.blur_solve import k5b_strip_fits
    R0, R1, flow = _step_operands(dev, h, w)
    M = core.update_matrices(R0, R1, flow)
    ref = core.blur_solve(M, winsize, gaussian)
    got = blur_solve(M, winsize, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    odd = torch.empty(M.numel() + 1, device=dev)[1:].view(M.shape)
    odd.copy_(M)
    assert torch.equal(blur_solve(odd, winsize, gaussian), ref)
    assert k5b_strip_fits(winsize) == (winsize <= 261)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("B,h,w,rows", [(16, 600, 1920, 320), (4, 700, 960, 256),
                                        (2, 300, 256, 32)])
def test_blur_solve_row_blocks(dev, B, h, w, rows, gaussian):
    """K5b's strip blocks at 320, 256 and 32 rows (the last block of a
    strip walking fewer): K5a -> K5b equal to K1 to the bit at winsize 15
    and 61, and to its plain version at 63."""
    from optical_flow_tpu_torch.kernels import blur_solve as k5b
    assert k5b._rows_per_block(B, h, w, 63, dev) == rows
    R0, R1, flow = _wide_operands(dev, B, h, w, 6.0)
    M = update_matrices(R0, R1, flow)
    for winsize in (15, 61):
        got = blur_solve(M, winsize, gaussian)
        ref = update_blur(R0, R1, flow, winsize, gaussian)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), float((got - ref).abs().max())
    got = blur_solve(M, 63, gaussian)
    ref = core.blur_solve(M, 63, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_selftest_on_the_card(dev):
    """The package's self test: every case ok, every kernel's route run
    (not plain against plain), each kernel equal to its reference."""
    from optical_flow_tpu_torch.utils.selftest import run_selftest
    kernels.reset_launches()
    verdict = run_selftest()
    failed = [c for c in verdict["cases"] if not c["ok"]]
    assert verdict["ok"] and not failed, failed
    assert verdict["kernels"] is True and verdict["device"] == "cuda"
    assert verdict["n_cases"] == 48
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.LAUNCHES), kernels.LAUNCHES


@pytest.mark.parametrize("channels_last", [None, False])
@pytest.mark.parametrize("shape,dw,dh", [((1080, 1920), 129, 72), ((37, 53, 3), 20, 11),
                                         ((2, 97, 131), 64, 48), ((40, 64), 64, 40)])
def test_resize_u8_cv_on_the_card_equals_the_cpu(dev, shape, dw, dh, channels_last):
    from optical_flow_tpu_torch.ops.resize import resize_u8_cv
    src = torch.as_tensor(np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8))
    got = resize_u8_cv(src.to(dev), dw, dh, channels_last)
    assert got.device == dev
    assert torch.equal(got.cpu(), resize_u8_cv(src, dw, dh, channels_last))


def test_nan_check_fires_on_the_card(dev, monkeypatch):
    """With the NaN check on, a chunk whose flow holds a NaN raises in
    the extractor's and the visualizer's device loops on the card."""
    from optical_flow_tpu_torch.pipeline import extractor, visualizer
    from optical_flow_tpu_torch.utils import validate
    from optical_flow_tpu_torch.utils.config import ExtractorConfig

    monkeypatch.setattr(validate, "DEBUG_NANS", True)
    frames = _frames(4, 40, 64)
    seq = list(enumerate(frames))
    got = extractor.extract_frames(seq, [(0, (0, 1)), (1, (2, 3))], ExtractorConfig(),
                                   chunk_size=1, device=dev)
    assert sorted(got) == [0, 1]

    def poisoned(entry):
        def run(*a, **k):
            flow = entry(*a, **k).clone()
            flow[-1, 3, 5, 1] = float("nan")
            return flow
        return run

    monkeypatch.setattr(extractor, "calc_flow_batched", poisoned(extractor.calc_flow_batched))
    with pytest.raises(FloatingPointError, match="from frame 0"):
        extractor.extract_frames(seq, [(0, (0, 1)), (1, (2, 3))], ExtractorConfig(),
                                 chunk_size=2, device=dev)
    monkeypatch.setattr(visualizer, "calc_flow_chain_batched",
                        poisoned(visualizer.calc_flow_chain_batched))
    with pytest.raises(FloatingPointError, match="from frame 0"):
        visualizer.visualize_frames(seq, lambda pos, bgr: None, chunk_size=3, device=dev)


def test_build_runs_no_nvcc_a_second_time(dev):
    from optical_flow_tpu_torch.kernels import _build
    _build.build()
    again = _build.build()
    assert again.nvcc_runs == 0
    assert all((_build.build_dir() / f"lib{n}.so").is_file() for n in _build.SOURCES)
