"""The CUDA kernels against their plain versions on the card, at shapes and
options that chip_smoke.py does not reach: frames smaller than a tile,
odd dims, float32 input, other window and expansion sizes, the wrappers'
input checks, the main path against the plain path on the CPU, the
visualizer's chained pyramid and K4 colorization, the unfused iterate
(K5a -> K5b) with the box and the Gaussian window, K1 with the Gaussian
window, K1's instantiation with winsize 15 built in against K5a -> K5b
to the bit, with its launch counter, the box
window beyond K1's tile, the seeded entry, K6 (the
full-resolution Gaussian) at any tap count, the configs whose levels
K3 does not take (levels 4 and 5, pyr_scale 0.25) or whose expansion is
wider than cv2's (poly_n 11), K7 (the step with the expansion derived
in-kernel) against K2 -> K1 to the bit, alone, per level and on the
whole path with FUSE_POLYEXP on, and the strip-walking K1 and the
band-staging K3 at shapes that straddle their strip, ring and tile
edges, and the tile-staging K2 and strip-walking K5b equal to their plain
versions to the bit at tile edges, every 1080p level and row-block size;
the mesh's data and spatial axes (`parallel/`) on meshes that repeat the
card, and that a launch leaves the caller's current device as it was.

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
from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
from optical_flow_tpu_torch.kernels.polyexp import poly_exp
from optical_flow_tpu_torch.kernels.resample import area_plan, resize_bilinear
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
                                                     smooth_texture_pair,
                                                     vertical_jump_pair)
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
                                "K5a": 0, "K5b": 0, "K6": 0, "K7": 0,
                                "X1": 0, "X2": 0}


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
                                "K6": 0, "K7": 0, "X1": n_levels - 1, "X2": 0}
    ref = calc_flow_batched(prev, nxt, device="cpu")
    d = (got.cpu() - ref).abs()
    assert float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean()) >= 0.999
    assert float(d.mean()) <= 1e-3
    sums = magnitude_sums(torch.as_tensor(prev).to(dev),
                          torch.as_tensor(nxt).to(dev), FarnebackConfig())
    assert kernels.LAUNCHES["X2"] == 1
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
                                "K6": 0, "K7": 0, "X1": n_levels - 1, "X2": 0}
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
                                "K5a": 3, "K5b": 4, "K6": 0, "K7": 0,
                                "X1": 0, "X2": 0}


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
    coarsest = build_plan(h, w, cfg).levels[0]
    # the upsamples, and the seed's INTER_AREA downsample where flags has 4
    x1 = n_levels - 1 + (len(area_plan(h, w, coarsest.height, coarsest.width))
                         if cfg.use_initial_flow else 0)
    assert kernels.LAUNCHES == {"K1": steps if k1 else 0, "K2": n_levels,
                                "K3": n_levels - 1, "K4": 0,
                                "K5a": 0 if k1 else steps,
                                "K5b": 0 if k1 else steps, "K6": 0, "K7": 0,
                                "X1": x1, "X2": 0}
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
                                "K5b": 0, "K6": n_k6, "K7": 0,
                                "X1": n_levels - 1 + n_k6, "X2": 0}
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


def _spread_flow(kind, B, h, w, seed):
    """(B, 2, h, w) f32 flows that spread the fetch targets: "smooth" (a
    block's box holds every target), "random60" (±60 px), "jump" (strips
    of +40 and +104 rows, vertical_jump_pair's) or "borders" (targets from
    2 px inside to 8 px past the nearest edge of each axis, clamped)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flows = []
    for b in range(B):
        if kind == "smooth":
            f = np.stack([2.5 * np.sin(yy / 9.0 + b) + 1.3, 1.7 * np.cos(xx / 7.0) - 0.6])
        elif kind == "random60":
            f = (rng.random((2, h, w)) - 0.5) * 120
        elif kind == "jump":
            f = (rng.random((2, h, w)) - 0.5) * 1.5
            for r0f, r1f, dy in ((0.37, 0.445, 40), (0.46, 0.535, 104)):
                f[1, int(h * r0f):int(h * r1f)] += dy
        else:
            push = 10 * rng.random((h, w)) - 2
            f = np.stack([np.where(xx < w / 2, -(xx + push), (w - 1 - xx) + push),
                          np.where(yy < h / 2, -(yy + push), (h - 1 - yy) + push)])
        flows.append(f)
    return torch.as_tensor(np.stack(flows).astype(np.float32))


# (winsize, Gaussian window, tile width): both widths where 64 columns fit
K7_SPREAD_WINDOWS = [(1, False, 32), (1, False, 64), (15, False, 32), (15, False, 64),
                     (15, True, 32), (15, True, 64), (61, False, 32), (61, True, 32)]


@pytest.mark.parametrize("poly_n", [5, 7])
@pytest.mark.parametrize("winsize,gaussian,tile_w", K7_SPREAD_WINDOWS)
@pytest.mark.parametrize("kind", ["u8_pre", "f32"])
@pytest.mark.parametrize("flow_kind", ["smooth", "random60", "jump", "borders"])
def test_update_blur_poly_fetch_box(dev, flow_kind, kind, winsize, gaussian, poly_n,
                                    tile_w):
    """K7 where the fetch targets spread beyond a block's box (±60 px, the
    vertical jump), leave the image at every border, or stay in a box the
    block stages whole: equal to K2 -> K1 to the bit, at both tile widths
    (the counted entry) and through update_blur_poly; both paths taken
    where ±60 px targets spread past the block's boxes."""
    from optical_flow_tpu_torch.kernels.update_gather import update_blur_poly_counted
    h, w = (160, 130) if flow_kind == "jump" else (99, 130)
    if flow_kind == "jump":
        f1, f2 = vertical_jump_pair(h, w)
    else:
        f1, f2 = smooth_texture_pair(h, w, (1, 2))
    img0, img1 = np.stack([f1, f2]), np.stack([f2, f1])
    pre = PRE_TAPS if kind == "u8_pre" else None
    if kind == "f32":
        img0, img1 = (x.astype(np.float32) * 0.7 + 3.0 for x in (img0, img1))
    img0, img1 = torch.as_tensor(img0).to(dev), torch.as_tensor(img1).to(dev)
    flow = _spread_flow(flow_kind, 2, h, w, winsize * 10 + poly_n).to(dev)
    sigma = 0.3 * poly_n
    got, counts = update_blur_poly_counted(img0, img1, flow, winsize, gaussian,
                                           poly_n, sigma, pre, tile_w=tile_w)
    ref = update_blur(poly_exp(img0, poly_n, sigma, pre_taps=pre),
                      poly_exp(img1, poly_n, sigma, pre_taps=pre), flow, winsize, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert torch.equal(update_blur_poly(img0, img1, flow, winsize, gaussian, poly_n,
                                        sigma, pre), ref)
    assert kernels.LAUNCHES["K7"] == 2
    assert counts["per_pixel"] + counts["boxed"] <= counts["m_pixels"]
    if flow_kind == "smooth" and winsize <= 15:
        assert counts["per_pixel"] == 0 and counts["boxed"] > 0, counts
    if flow_kind == "random60" and winsize == 15 and tile_w == 32:
        assert counts["per_pixel"] > 0 and counts["boxed"] > 0, counts


@pytest.mark.parametrize("kind", ["u8_pre", "f32"])
@pytest.mark.parametrize("winsize,poly_n", [(5, 95), (39, 56), (1, 96)])
def test_update_blur_poly_wide_expansion(dev, winsize, poly_n, kind):
    """Expansions so wide that the block's region holds no row of R0's
    vertical sums (R0 per pixel from the staged img0: winsize 5 at
    poly_n 95, 39 at 56) or only a few (R0 in bands: 1 at 96), and
    hardly a fetch box: equal to K2 -> K1 to the bit."""
    _k7_against_k2_k1(dev, 37, 53, winsize, False, poly_n, kind)


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
                                "K5a": 0, "K5b": 0, "K6": 0, "K7": 3 * n_levels,
                                "X1": n_levels - 1, "X2": 0}
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


@pytest.mark.parametrize("loop", ["extract", "visualize"])
def test_pinned_counters_are_the_pools_growth(dev, loop):
    """The loops' counters `pinned_allocs` and `pinned_alloc_us` equal the
    deltas of `torch.cuda.host_memory_stats()` around each call (the
    first from a fresh `PipelineMetrics`), and every frame is one
    `upload` stage; a torch whose statistics lack a key has no counter."""
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor, visualizer
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PINNED_STATS, PipelineMetrics

    m = PipelineMetrics(loop)
    want = dict.fromkeys(PINNED_STATS, 0)
    frames = 0
    for n in (9, 21):         # the second call's frames are larger
        h, w = (72, 129) if n == 9 else (144, 258)
        seq = list(zip(range(n), translating_clip(h, w, list(range(n)))))
        before = torch.cuda.host_memory_stats()
        if loop == "extract":
            windows = list(enumerate((i, i + 2) for i in range(n - 2)))
            extractor.extract_frames(seq, windows, ExtractorConfig(), chunk_size=4,
                                     device=dev, metrics=m)
        else:
            visualizer.visualize_frames(seq, lambda pos, bgr: None, chunk_size=4,
                                        device=dev, metrics=m)
        after = torch.cuda.host_memory_stats()
        frames += n
        for counter, key in PINNED_STATS.items():
            if key in after:
                want[counter] += after[key] - before.get(key, 0)
        assert m.stages["upload"].count == frames
        assert m.counters.get("pinned_allocs") == (
            want["pinned_allocs"] if "num_host_alloc" in after else None)
        assert m.counters.get("pinned_alloc_us") == (
            want["pinned_alloc_us"] if "host_alloc_time.total" in after else None)
    assert m.stages["drain" if loop == "extract" else "download"].count > 0


def test_visualize_frames_dispatches_a_long_shot_by_pixels(dev, monkeypatch):
    """A 1080p shot of 40 pairs at the chunk `pair_chunk_for` gives, each
    dispatch's kernels queued behind about 10 ms of `torch.cuda._sleep`
    (so the frames' copies and pinned blocks wait on them): the images
    equal the shot's as one chunk to the bit, the counters are the
    dispatches `dispatch_pairs` gives, and in a profile the first
    dispatch's kernels start before the last frame's `Memcpy HtoD`."""
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import prefetch, visualizer
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    h, w, pairs = 1080, 1920, 40
    seq = list(enumerate(translating_clip(h, w, [i % 97 - 48 for i in range(pairs + 1)])))
    chunk = prefetch.pair_chunk_for(h, w, device=dev)
    per = prefetch.dispatch_pairs(h, w, chunk)
    assert per < min(chunk, pairs)

    def run(**kw):
        out = []
        visualizer.visualize_frames(seq, lambda pos, bgr: out.append(bgr.copy()),
                                    chunk_size=chunk, device=dev, **kw)
        return np.stack(out)

    with monkeypatch.context() as mp:
        mp.setattr(prefetch, "DISPATCH_PIXELS", chunk * h * w)
        one = run()
    dispatch = visualizer.calc_flow_chain_batched

    def late_dispatch(frames, *args, **kw):
        torch.cuda._sleep(20_000_000)
        return dispatch(frames, *args, **kw)

    monkeypatch.setattr(visualizer, "calc_flow_chain_batched", late_dispatch)
    run()
    torch.cuda.synchronize()
    m = PipelineMetrics("visualize")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = run(metrics=m)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(got, one)
    assert m.counters["dispatches"] == -(-pairs // per)
    assert m.counters["early_dispatches"] == pairs // per
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    copies = sorted(e.start_ns() for e in ops if e.name().startswith("Memcpy HtoD"))
    work = sorted(e.start_ns() for e in ops if not e.name().startswith(("Memcpy", "Memset")))
    assert len(copies) == pairs + 1
    assert work[0] < copies[-1]


def test_visualize_frames_copies_a_1080p_frame_at_a_time(dev):
    """A 1080p shot of 16 pairs through `visualize_frames`: each 2 MB
    frame is past `GROUP_BYTES`, a group of its own, so the trace's
    `Memcpy HtoD` are the counter `h2d_copies`, one a frame, and
    `staged_bytes` the frames' bytes."""
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import visualizer
    from optical_flow_tpu_torch.pipeline.prefetch import pair_chunk_for
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    h, w, n = 1080, 1920, 17
    seq = list(enumerate(translating_clip(h, w, list(range(n)))))

    def run(**kw):
        return visualizer.visualize_frames(seq, lambda pos, bgr: None,
                                           chunk_size=pair_chunk_for(h, w, device=dev),
                                           device=dev, **kw)

    run()
    torch.cuda.synchronize()
    m = PipelineMetrics("visualize")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert run(metrics=m) == n - 1
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    copies = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and e.name().startswith("Memcpy HtoD")]
    assert len(copies) == m.counters["h2d_copies"] == n == m.stages["upload"].count
    assert m.counters["staged_bytes"] == n * h * w


def _clip_w129():
    """A 10 s clip at 25 fps and 72x129, windows and step 300 ms: 36
    windows over 72 frames, each its own crop of one texture."""
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor

    windows, _ = extractor._window_schedule(250, 25.0, 300, 300)
    todo = list(enumerate(windows))
    needed = sorted({f for _, win in todo for f in win})
    return list(zip(needed, translating_clip(72, 129, [f % 97 - 48 for f in needed]))), todo


def test_h2d_copies_are_the_traces_memcpy(dev):
    """One `extract_frames` call on a 10 s clip at 72x129: its 72 frames
    go to the card in one group, and the trace's `Memcpy HtoD` are the
    counter `h2d_copies`, one."""
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    seq, todo = _clip_w129()
    extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=128, device=dev)
    torch.cuda.synchronize()
    m = PipelineMetrics("extract")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=128,
                                       device=dev, metrics=m)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    copies = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and e.name().startswith("Memcpy HtoD")]
    assert sorted(got) == list(range(36))
    assert len(copies) == m.counters["h2d_copies"] == 1
    assert m.stages["upload"].count == m.counters["frames_decoded"] == 72


def test_staging_is_safe_while_copies_are_queued(dev, monkeypatch):
    """Groups of 4 frames, each group's copy queued behind about 10 ms of
    `torch.cuda._sleep`, enqueued as its buffer is taken, while the host
    stages the next groups with other frames: a pinned buffer written
    again before its copy ran would
    change the sums, which equal the default grouping's to the bit and
    the plain path's on the CPU within 1e-4 rel."""
    from optical_flow_tpu_torch.pipeline import extractor, prefetch
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    seq, todo = _clip_w129()

    def run(**kw):
        return extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=8, **kw)

    ref = run(device=dev)
    cpu = run(device="cpu")
    put = prefetch.DeviceStager.put

    def late_put(self, key, frame):
        if self._group is None:
            # a new group's buffer: ahead of this group's copy on the stream
            torch.cuda._sleep(20_000_000)
        put(self, key, frame)

    monkeypatch.setattr(prefetch, "GROUP_BYTES", 4 * seq[0][1].nbytes)
    monkeypatch.setattr(prefetch.DeviceStager, "put", late_put)
    m = PipelineMetrics("extract")
    got = run(device=dev, metrics=m)
    assert m.counters["h2d_copies"] >= len(seq) // 4
    assert got == ref and sorted(got) == list(range(36))
    for i, (s, e, v) in got.items():
        assert (s, e) == cpu[i][:2]
        assert abs(v - cpu[i][2]) <= 1e-4 * abs(cpu[i][2])


def test_extract_frames_at_1080p(dev):
    """A 10 s clip at 1080x1920 (`--frame_width 1920` on 1080p sources)
    through `extract_frames` at the default GROUP_BYTES and the chunk
    `pair_chunk_for` gives, one chunk of its 36 windows: each 2 MB frame
    is a group of its own, so the trace's `Memcpy HtoD` are the counter
    `h2d_copies`, 72, and `staged_bytes` the 72 frames' bytes; X2 runs in
    its two launches; the sums are the plain path's on the card within
    1e-4 rel."""
    from torch.profiler import ProfilerActivity, profile
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.pipeline.prefetch import pair_chunk_for
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    windows, _ = extractor._window_schedule(250, 25.0, 300, 300)
    todo = list(enumerate(windows))
    needed = sorted({f for _, win in todo for f in win})
    seq = list(zip(needed, translating_clip(1080, 1920, [f % 97 - 48 for f in needed])))
    chunk = pair_chunk_for(1080, 1920, device=dev)
    assert chunk >= len(todo) == 36 and len(seq) == 72

    def run(**kw):
        return extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=chunk,
                                        device=dev, **kw)

    ref = run(plain=True)
    run()
    torch.cuda.synchronize()
    kernels.reset_launches()
    m = PipelineMetrics("extract")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = run(metrics=m)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    copies = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and e.name().startswith("Memcpy HtoD")]
    assert sorted(got) == sorted(ref) == list(range(36))
    assert len(copies) == m.counters["h2d_copies"] == 72
    assert m.counters["staged_bytes"] == 72 * 1080 * 1920
    assert kernels.LAUNCHES["X2"] == 2
    for i, (s, e, v) in got.items():
        assert (s, e) == ref[i][:2]
        assert abs(v - ref[i][2]) <= 1e-4 * abs(ref[i][2])


@pytest.fixture
def fresh_graphs(monkeypatch):
    """The extractor's cache of captured dispatches, empty for one test."""
    from optical_flow_tpu_torch.pipeline import extractor
    graphs = extractor.ChunkGraphs(extractor._ChunkGraph)
    monkeypatch.setattr(extractor, "_GRAPHS", graphs)
    return graphs


def _clip_moving(h, w, n_frames, speed):
    """A 25 fps clip of n_frames at h x w, its windows at the default step
    and window, each frame a crop of one texture moving `speed` px a frame
    (a triangle wave): (frames, windows)."""
    from optical_flow_tpu_torch.oracle.synthetic import translating_clip
    from optical_flow_tpu_torch.pipeline import extractor

    windows, _ = extractor._window_schedule(n_frames, 25.0, 300, 300)
    needed = sorted({f for win in windows for f in win})
    amp = min(48, w // 2 - 1)
    dxs = [amp - abs(amp - (speed * f) % (2 * amp)) for f in needed]
    return list(zip(needed, translating_clip(h, w, dxs))), list(enumerate(windows))


def _extract_counted(seq, todo, chunk, dev):
    """extract_frames on the card: (sums, its launches as
    `kernels.launch_counts` gives them, its counters)."""
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    kernels.reset_launches()
    m = PipelineMetrics("extract")
    got = extractor.extract_frames(seq, todo, ExtractorConfig(), chunk_size=chunk,
                                   device=dev, metrics=m)
    torch.cuda.synchronize()
    return got, kernels.launch_counts(), m.counters


def test_replayed_chunks_equal_the_eager_dispatch(dev, fresh_graphs, monkeypatch):
    """Three 36-window clips at 72x129, each moving at its own speed, and
    a 40 s video in chunks of 16 (two chunks in flight, a partial last
    one): the first clip runs eagerly, the second captures its dispatch
    and replays it, the third replays; the video's first full chunk of 16
    runs eagerly, the next captures, the rest replay, its last chunk of 15
    stays eager.  Every sum equals the eager dispatch's to the bit, and
    `kernels.LAUNCHES` counts the kernels the replays ran as the eager
    calls count theirs, and `kernels.FIXED_WINDOW` every K1 launch of
    them (winsize 15).  Sums handed back from the graph's own output, not
    copied, would carry the next replay's."""
    from optical_flow_tpu_torch.pipeline import extractor

    runs = [(_clip_moving(72, 129, 250, speed), 128) for speed in (1, 2, 3)]
    runs.append((_clip_moving(72, 129, 1000, 2), 16))
    with monkeypatch.context() as mp:
        mp.setattr(extractor, "graph_engaged", lambda *a, **k: False)
        eager = [_extract_counted(seq, todo, chunk, dev) for (seq, todo), chunk in runs]
    assert not fresh_graphs._graphs
    replays = []
    for ((seq, todo), chunk), (want, launches, _) in zip(runs, eager):
        got, got_launches, counters = _extract_counted(seq, todo, chunk, dev)
        assert got == want and sorted(got) == list(range(len(todo)))
        assert got_launches == launches
        assert launches["fixed_window", "K1"] == launches["launches", "K1"] > 0
        assert counters["dispatches"] == -(-len(todo) // chunk)
        replays.append(counters["graph_replays"])
    assert len(runs[3][0][1]) == 143            # 8 chunks of 16 and one of 15
    assert replays == [0, 1, 1, 7]


def test_a_replayed_clip_profiles_as_an_eager_one(dev, fresh_graphs):
    """In a profile, a replayed clip's dispatch shows the same kernels
    under their own names, as many times, as the eager one's: the
    per-kernel device times and the roofline read them."""
    from torch.profiler import ProfilerActivity, profile

    seq, todo = _clip_moving(72, 129, 250, 1)

    def kernel_names():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, _, counters = _extract_counted(seq, todo, 128, dev)
        cuda = torch.autograd.DeviceType.CUDA
        names = sorted(e.name() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == cuda
                       and not e.name().startswith(("Memcpy", "Memset")))
        return names, counters["graph_replays"]

    eager = kernel_names()
    _extract_counted(seq, todo, 128, dev)            # the capture
    replayed = kernel_names()
    assert eager[1] == 0 and replayed[1] == 1
    assert any("update_blur" in n for n in eager[0])
    assert replayed[0] == eager[0]


def test_a_1080p_clip_is_never_graphed(dev, fresh_graphs):
    """A 36-pair chunk of 1080p frames is past `GRAPH_PIXELS`: its
    dispatch runs eagerly at every sight, and the cache never sees it."""
    seq, todo = _clip_moving(1080, 1920, 250, 1)
    for _ in range(3):
        _, launches, counters = _extract_counted(seq, todo, 80, dev)
        assert counters["dispatches"] == 1 and counters["graph_replays"] == 0
        assert launches["launches", "K1"] == launches["fixed_window", "K1"] == 12
    assert not fresh_graphs._graphs and not fresh_graphs._seen


def _clear_device_tables():
    """Empty every cache of device tables the kernels' wrappers keep."""
    from optical_flow_tpu_torch.kernels import blur_solve, gauss, gauss_resize, resample
    from optical_flow_tpu_torch.ops import resize
    for cached in (gauss_resize._tables, resample._table, resample._row_block_table,
                   blur_solve.window_taps, gauss._taps, resize.coeff_tensors,
                   resize._u8_coeff_tensors, resize._area_tensors):
        cached.cache_clear()


def test_a_graph_keeps_its_device_tables(dev, fresh_graphs, monkeypatch):
    """The tables a captured dispatch reads (K3's, X1's) are the graph's
    own: with the caches emptied between the first sight and the capture,
    and again before the replay, their freed blocks handed out and
    zeroed, the replayed sums equal the eager dispatch's to the bit."""
    from optical_flow_tpu_torch.pipeline import extractor

    seq, todo = _clip_moving(72, 129, 250, 2)
    with monkeypatch.context() as mp:
        mp.setattr(extractor, "graph_engaged", lambda *a, **k: False)
        want, launches, _ = _extract_counted(seq, todo, 128, dev)
    sights = []
    for _ in range(3):
        got, got_launches, counters = _extract_counted(seq, todo, 128, dev)
        sights.append((got == want, got_launches == launches, counters["graph_replays"]))
        _clear_device_tables()
        junk = [torch.zeros(n, dtype=torch.int32, device=dev)
                for n in (16, 64, 129, 256, 1024, 4096, 16384) for _ in range(500)]
        del junk
    assert sights == [(True, True, 0), (True, True, 1), (True, True, 1)]


def test_two_loops_share_the_graphs(dev, fresh_graphs, monkeypatch):
    """Two threads each run `extract_frames` over three 72x129 clips at
    once, as `run_corpus` does with `video_workers=2`: one capture serves
    both, and every sum equals the one-thread eager dispatch's to the
    bit."""
    import threading
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.utils.config import ExtractorConfig
    from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

    clips = [[_clip_moving(72, 129, 250, speed) for speed in speeds]
             for speeds in ((1, 2, 3), (4, 5, 1))]
    with monkeypatch.context() as mp:
        mp.setattr(extractor, "graph_engaged", lambda *a, **k: False)
        want = [[_extract_counted(seq, todo, 128, dev)[0] for seq, todo in loop]
                for loop in clips]
    got, replays, errors = [None, None], [0, 0], []

    def loop(i):
        try:
            got[i] = []
            for seq, todo in clips[i]:
                m = PipelineMetrics("extract")
                got[i].append(extractor.extract_frames(seq, todo, ExtractorConfig(),
                                                       chunk_size=128, device=dev,
                                                       metrics=m))
                replays[i] += m.counters["graph_replays"]
        except Exception as e:     # noqa: BLE001 - raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert got == want
    assert len(fresh_graphs._graphs) == 1 and sum(replays) == 5


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


FIXED_SHAPES = [(5, 7), (37, 53), (72, 129), (1080, 1920), (540, 960), (270, 480),
                (135, 240), (40, 7700)]


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("h,w", FIXED_SHAPES)
def test_update_blur_fixed_window_equals_unfused(dev, h, w, gaussian):
    """K1's instantiation with winsize 15 built in, at B = 1, a +-6 px flow,
    the small shapes, the four 1080p levels and width 7700: equal to the
    bit to K5a -> K5b, and counted once in `kernels.FIXED_WINDOW` as in
    `LAUNCHES`, whose keys stay the kernels'."""
    R0, R1, flow = _wide_operands(dev, 1, h, w, 6.0)
    kernels.reset_launches()
    got = update_blur(R0, R1, flow, 15, gaussian)
    unfused = blur_solve(update_matrices(R0, R1, flow), 15, gaussian)
    torch.cuda.synchronize()
    assert torch.equal(got, unfused), float((got - unfused).abs().max())
    assert kernels.FIXED_WINDOW == {"K1": 1}
    assert kernels.LAUNCHES["K1"] == 1
    assert sorted(kernels.LAUNCHES) == ["K1", "K2", "K3", "K4", "K5a", "K5b", "K6",
                                        "K7", "X1", "X2"]


@pytest.mark.parametrize("winsize,fixed", [(15, 3), (14, 3), (9, 0), (21, 0), (61, 0)])
@pytest.mark.parametrize("gaussian", [False, True])
def test_k1_fixed_window_counts_its_launches(dev, winsize, fixed, gaussian):
    """A 3-step level counts its K1 launches in `LAUNCHES` at any window,
    and in `kernels.FIXED_WINDOW` only where the window is built in
    (winsize // 2 == 7)."""
    R0, R1, flow = _step_operands(dev, 37, 53)
    kernels.reset_launches()
    update_flow(R0, R1, flow, winsize, 3, gaussian)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["K1"] == 3
    assert kernels.FIXED_WINDOW == {"K1": fixed}


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
    assert verdict["n_cases"] == 53
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


def _rolled_chain(n, h, w):
    """n frames of a texture rolled (1, 2) px a frame, with +-1 noise."""
    base = smooth_texture_pair(h, w, (1, 2), seed=3)[0].astype(np.int16)
    noise = np.random.default_rng(3).integers(0, 2, (n, h, w))
    return np.stack([np.clip(np.roll(base, (i, 2 * i), (0, 1)) + noise[i], 0, 255)
                     for i in range(n)]).astype(np.uint8)


def test_mesh_dp_on_one_card_equals_one_device(dev):
    """chip_smoke's mesh_dp_1080p at a small size: on a [card, card] mesh,
    sharded_flow_step, the extractor's branch (5 pairs padded to 6) and
    sharded_bgr_chain_step over chain_shards equal the one-device entries
    to the bit, through the kernels."""
    from optical_flow_tpu_torch.parallel import (chain_shards, make_mesh,
                                                 sharded_bgr_chain_step, sharded_flow_step)
    from optical_flow_tpu_torch.pipeline import extractor
    from optical_flow_tpu_torch.utils.config import ExtractorConfig

    mesh = make_mesh(2, 1, devices=[dev, dev])
    frames = torch.as_tensor(_rolled_chain(6, 72, 129)).to(dev)
    prev, nxt = frames[:-1], frames[1:]
    assert torch.equal(sharded_flow_step(mesh, prev, nxt), calc_flow_batched(prev, nxt))
    sums, _ = extractor._sharded_magnitude_sums(mesh, prev, nxt, ExtractorConfig())
    assert torch.equal(sums, magnitude_sums(prev, nxt))
    kernels.reset_launches()
    bgr = sharded_bgr_chain_step(mesh, chain_shards(frames, 2))[:5]
    L = len(build_plan(72, 129, FarnebackConfig()).levels)    # per shard
    assert {k: kernels.LAUNCHES[k] for k in ("K1", "K2", "K3", "K4")} == {
        "K1": 2 * 3 * L, "K2": 2 * L, "K3": 2 * (L - 1), "K4": 2}
    assert torch.equal(bgr, calc_flow_bgr_chain_batched(frames))


def test_mesh_sp_on_one_card(dev):
    """chip_smoke's mesh_sp_8k at a small size, on a 1x2 [card, card] mesh:
    the flow within the share gate of the one-device path, through K6, K2,
    K5a and K5b only; and the cross-seam update, a band of dy = 45 px rows
    just above the seam (past the 32-row halo), equal to K5a."""
    from optical_flow_tpu_torch.parallel import HaloKernels, make_mesh, sharded_flow_step
    from optical_flow_tpu_torch.parallel.halo import Blocks

    mesh = make_mesh(1, 2, devices=[dev, dev])
    f1, f2 = smooth_texture_pair(256, 384, (2, 3))
    prev, nxt = (torch.as_tensor(f[None]).to(dev) for f in (f1, f2))
    kernels.reset_launches()
    flow = sharded_flow_step(mesh, prev, nxt)
    launches = dict(kernels.LAUNCHES)
    assert launches["K1"] == launches["K3"] == launches["K7"] == 0, launches
    assert all(launches[k] > 0 for k in ("K2", "K5a", "K5b", "K6", "X1")), launches
    ref = calc_flow_batched(prev, nxt)
    d = (flow - ref).abs()
    assert float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean()) >= 0.999
    assert float(d.mean()) <= 1e-3

    R = poly_exp(torch.as_tensor(np.stack([f1, f2])).to(dev), 5, 1.2)
    R0, R1 = R[:1].contiguous(), R[1:].contiguous()
    gen = torch.Generator(dev).manual_seed(4)
    fl = (torch.rand((1, 2, 256, 384), generator=gen, device=dev) - 0.5) * 12.0
    fl[:, 1, 120:128, 40:200] = 45.0
    hk = HaloKernels(mesh)
    M, n_fixed = hk.update_matrices_stats(*(Blocks.split(t, [dev, dev]) for t in (R0, R1, fl)))
    _close(M.gather(), update_matrices(R0, R1, fl), STENCIL_TOL)
    assert n_fixed >= 8 * 160


def test_launch_leaves_the_current_device(dev):
    """Each kernel's entry restores the caller's current device: after
    launches on cuda:0 tensors the current device is the one the caller
    set.  Trivially true on one card; with several, the current device is
    set to the last card first, so that only the guard keeps it there."""
    last = torch.cuda.device_count() - 1
    before = torch.cuda.current_device()
    torch.cuda.set_device(last)
    try:
        img = torch.as_tensor(_frames(2, 40, 64)).to(dev)
        R = poly_exp(img, 5, 1.2, pre_taps=PRE_TAPS)
        flow = torch.zeros((1, 2, 40, 64), device=dev)
        gauss_resize(img, LEVEL_TAPS[1], 32, 20)
        gaussian_blur(img, LEVEL_TAPS[2])
        update_blur(R[:1], R[1:], flow, 15)
        blur_solve(update_matrices(R[:1], R[1:], flow), 15, False)
        update_blur_poly(img[:1], img[1:], flow, 15, False, 5, 1.2)
        flow_to_bgr_planar(torch.ones((1, 2, 40, 64), device=dev))
        resize_bilinear(flow, 128, 80, 2.0)
        magnitude_sum(flow)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == last
        assert all(kernels.LAUNCHES[k] == 1 for k in kernels.LAUNCHES), kernels.LAUNCHES
    finally:
        torch.cuda.set_device(before)


def test_mesh_across_the_visible_cards(dev):
    """With two or more cards: the data axis over every card (the mesh
    `dp_mesh` builds), the extractor's and the visualizer's loops with no
    device named (sharded) against one named card, and the spatial axis
    over real cards (1 x n, and 2 x n/2 where n is even and at least 4),
    held as on one repeated card."""
    from optical_flow_tpu_torch.parallel import (HaloKernels, chain_shards, make_mesh,
                                                 sharded_bgr_chain_step, sharded_flow_step)
    from optical_flow_tpu_torch.parallel.halo import Blocks
    from optical_flow_tpu_torch.parallel.mesh import dp_mesh
    from optical_flow_tpu_torch.pipeline import extractor, visualizer
    from optical_flow_tpu_torch.utils.config import ExtractorConfig

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    dp_mesh.cache_clear()
    mesh = dp_mesh()
    assert mesh is not None and mesh.shape == {"data": n, "spatial": 1}
    host = _rolled_chain(2 * n + 3, 72, 129)
    frames = torch.as_tensor(host).to(dev)
    prev, nxt = frames[:-1], frames[1:]
    assert torch.equal(sharded_flow_step(mesh, prev, nxt), calc_flow_batched(prev, nxt))
    assert torch.equal(sharded_bgr_chain_step(mesh, chain_shards(frames, n))[:2 * n + 2],
                       calc_flow_bgr_chain_batched(frames))
    seq = list(enumerate(host))
    windows = [(i, (i, i + 1)) for i in range(2 * n + 2)]
    assert (extractor.extract_frames(seq, windows, ExtractorConfig(), chunk_size=n + 1)
            == extractor.extract_frames(seq, windows, ExtractorConfig(), chunk_size=n + 1,
                                        device=dev))

    def loop(device):
        out = []
        visualizer.visualize_frames(seq, lambda pos, b: out.append(b), chunk_size=n + 1,
                                    device=device)
        return np.stack(out)

    np.testing.assert_array_equal(loop(None), loop(dev))

    f1, f2 = smooth_texture_pair(256, 384, (2, 3))
    p1, n1 = (torch.as_tensor(f[None]).to(dev) for f in (f1, f2))
    ref = calc_flow_batched(p1, n1)
    shapes = [(1, n)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0 else [])
    for n_dp, n_sp in shapes:
        m = make_mesh(n_dp, n_sp)
        flow = sharded_flow_step(m, p1.expand(n_dp, -1, -1), n1.expand(n_dp, -1, -1))
        d = (flow - ref).abs()
        assert float((d <= 2e-3 + 1e-3 * ref.abs()).float().mean()) >= 0.999, (n_dp, n_sp)
        assert float(d.mean()) <= 1e-3
    R = poly_exp(torch.as_tensor(np.stack([f1, f2])).to(dev), 5, 1.2)
    R0, R1 = R[:1].contiguous(), R[1:].contiguous()
    fl = (torch.rand((1, 2, 256, 384), generator=torch.Generator(dev).manual_seed(4),
                     device=dev) - 0.5) * 12.0
    fl[:, 1, 56:64, 40:200] = 45.0
    cards = [torch.device("cuda", i) for i in range(n)]
    M, _ = HaloKernels(make_mesh(1, n)).update_matrices_stats(
        *(Blocks.split(t, cards) for t in (R0, R1, fl)))
    assert [p.device for p in M.parts] == cards
    _close(M.gather(dev), update_matrices(R0, R1, fl), STENCIL_TOL)


# --- X1 resample and X2 magnitude sum ----------------------------------------

def _bit_equal(got, ref) -> bool:
    """Equal to the bit, NaNs at the same places (a NaN's payload aside)."""
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    return (tuple(got.shape) == tuple(ref.shape) and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                            ref.masked_fill(nan, 0).view(torch.int32)))


def _odd_values(x):
    """NaN and +-inf at a few places of an (N, C, H, W) tensor, pixel
    (0, 0) among them (where an area table's zero-weight pads point)."""
    x = x.clone()
    x[0, 0, 0, 0] = float("nan")
    x[-1, -1, 0, 0] = float("inf")
    x[0, -1, x.shape[2] // 2, x.shape[3] // 3] = -float("inf")
    return x


@pytest.mark.parametrize("n,h,w,dh,dw,scale", [
    (16, 135, 240, 270, 480, 2.0),          # the 1080p pyramid's x2 steps
    (16, 270, 480, 540, 960, 2.0),
    (4, 540, 960, 1080, 1920, 2.0),
    (2, 540, 959, 1079, 1917, 2.0),         # odd sizes
    (2, 1, 37, 2, 74, 2.0), (2, 37, 1, 74, 2, 2.0),    # 1-tall and 1-wide
    (2, 37, 53, 37, 106, 4.0),              # an axis that keeps its size
    (32, 1080, 1920, 68, 120, 1.0),         # the K6 route's level resize
    (1, 2160, 3840, 4320, 7680, 2.0),       # 8K
])
def test_resample_bilinear_kernel(dev, n, h, w, dh, dw, scale):
    """X1's bilinear resize with its scale against the plain version, to
    the bit, in one launch; NaN and +-inf placed where they spread."""
    from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32
    gen = torch.Generator(dev).manual_seed(h + w)
    x = _odd_values((torch.rand((n, 2, h, w), generator=gen, device=dev) - 0.5) * 12.0)
    got = resize_bilinear(x, dw, dh, scale)
    assert kernels.LAUNCHES["X1"] == 1 and got.is_contiguous()
    assert _bit_equal(got, resize_bilinear_f32(x, dw, dh) * scale)


@pytest.mark.parametrize("n,h,w,dh,dw", [
    (16, 1080, 1920, 135, 240),             # the seed at 1080p, levels 3
    (2, 1079, 1917, 135, 240),              # odd sizes
    (1, 4320, 7680, 540, 960),
    (2, 67, 121, 9, 13), (2, 1, 40, 1, 7), (2, 40, 1, 7, 1),
    (2, 10, 40, 20, 10), (2, 40, 10, 10, 20),          # an axis that grows
    (2, 10, 10, 20, 30), (2, 10, 40, 10, 7), (2, 37, 53, 37, 53),
    (2, 40, 1000, 5, 13),                   # more horizontal taps than registers hold
])
def test_resample_area_kernel(dev, n, h, w, dh, dw):
    """X1's INTER_AREA downsample with its scale, reading the seed's
    (B, H, W, 2) layout in place, against the plain version on the same
    strided view, to the bit, in `area_plan`'s launches (two where an axis
    grows); NaN and +-inf in the seed, pixel (0, 0) among them."""
    from optical_flow_tpu_torch.kernels.resample import resize_area
    from optical_flow_tpu_torch.ops.resize import resize_area_f32
    gen = torch.Generator(dev).manual_seed(h * w)
    seed = (torch.rand((n, h, w, 2), generator=gen, device=dev) - 0.5) * 12.0
    x = _odd_values(seed.movedim(-1, 1).contiguous()).movedim(1, -1).contiguous().movedim(-1, 1)
    assert not x.is_contiguous()
    got = resize_area(x, dw, dh, 0.125)
    assert kernels.LAUNCHES["X1"] == len(area_plan(h, w, dh, dw)) and got.is_contiguous()
    assert _bit_equal(got, resize_area_f32(x, dw, dh) * 0.125)
    assert _bit_equal(resize_area(x.contiguous(), dw, dh, 0.125), got)


@pytest.mark.parametrize("sh,dh,parts", [(270, 540, 2), (135, 270, 3), (541, 1079, 4)])
def test_resample_row_blocks(dev, sh, dh, parts):
    """X1 on a row block with the frame's shifted vertical table (the halo
    path's resize) equals the plain `bilinear_rows` on the same block, and
    the blocks together the whole frame's resize, to the bit."""
    from optical_flow_tpu_torch.kernels.resample import bilinear_rows
    from optical_flow_tpu_torch.ops import resize
    gen = torch.Generator(dev).manual_seed(sh)
    x = (torch.rand((2, 2, sh, 480), generator=gen, device=dev) - 0.5) * 12.0
    s0, s1, _ = resize._coeffs_f32(sh, dh)
    sy0, sy1, ty = resize.coeff_tensors(sh, dh, dev)
    rows = []
    for block in np.array_split(np.arange(dh), parts):
        a, b = int(block[0]), int(block[-1]) + 1
        lo, hi = int(s0[a]), int(s1[b - 1]) + 1
        got = bilinear_rows(x[..., lo:hi, :], 960, sh, dh, a, b, lo, 2.0)
        ref = resize.bilinear_rows(x[..., lo:hi, :], 960, sy0[a:b] - lo, sy1[a:b] - lo,
                                   ty[a:b]) * 2.0
        assert _bit_equal(got, ref)
        rows.append(got)
    assert _bit_equal(torch.cat(rows, -2), resize.resize_bilinear_f32(x, 960, dh) * 2.0)
    assert kernels.LAUNCHES["X1"] == parts


def test_resample_input_checks(dev):
    """The launch takes f32 on the card and tables made for x's device;
    a table's dtypes, shape and contiguity are checked where it is made
    (once: tables are cached per device), not at every launch."""
    from optical_flow_tpu_torch.kernels.resample import _resample, _table, _to_table
    x = torch.zeros((1, 2, 8, 8), device=dev)
    tab = _table("bilinear", 8, 16, dev)
    cpu = torch.device("cpu")
    with pytest.raises(TypeError):
        _resample(x.double(), tab, tab, False)
    with pytest.raises(ValueError):                                         # tables off the card
        _resample(x, _table("bilinear", 8, 16, cpu), tab, False)
    with pytest.raises(ValueError):
        _resample(x.cpu(), _table("bilinear", 8, 16, cpu),
                  _table("bilinear", 8, 16, cpu), False)                   # a CPU tensor
    with pytest.raises(ValueError):                                         # shapes disagree
        _to_table(np.zeros((16, 2), np.int64), np.zeros((16, 3), np.float32), dev)
    with pytest.raises(ValueError):                                         # no taps
        _to_table(np.zeros((16, 0), np.int64), np.zeros((16, 0), np.float32), dev)
    made = _to_table(np.zeros((16, 2), np.int64), np.ones((16, 2), np.float64), dev)
    assert made.index.dtype == torch.int32 and made.weight.dtype == torch.float32
    assert made.index.is_contiguous() and made.index.device == made.device == x.device
    assert kernels.LAUNCHES["X1"] == 0


# (label, source layout and shape, resize, dh, dw, the plan's path and load):
# tile edges (dw % 4 != 0, a plane count not a multiple of a block's),
# rows and planes not 16-byte aligned (a view 1 column into a wider
# frame), a row's 16-byte loads ending past the frame's width (a view of
# the first w columns of a frame 2 wider), the strided seed, and the
# generic kernel's shapes (INTER_AREA on planar rows among them)
RESAMPLE_PLAN_CASES = [
    ("x2_7_planes", "planar", (1, 7, 540, 960), "bilinear", 1080, 1920, ("band", 4)),
    ("x2_ragged_dw", "planar", (2, 2, 37, 64), "bilinear", 73, 127, ("band", 4)),
    ("x2_offset_view", "offset", (2, 2, 37, 62), "bilinear", 73, 123, ("band", 1)),
    ("x2_pairs", "pairs", (2, 2, 37, 62), "bilinear", 73, 124, ("band", 1)),
    ("x2_narrow_view", "narrow", (2, 2, 37, 62), "bilinear", 73, 124, ("band", 4)),
    ("x0.55_tile8", "planar", (2, 2, 400, 800), "bilinear", 220, 440, ("band", 4)),
    ("half_read_once", "planar", (2, 2, 400, 1024), "bilinear", 200, 512, ("generic", 1)),
    ("x2_chunk_72x129", "planar", (3, 2, 36, 64), "bilinear", 72, 129, ("generic", 1)),
    ("eighth", "planar", (2, 2, 64, 64), "bilinear", 8, 8, ("generic", 1)),
    ("quarter_past_smem", "planar", (1, 2, 400, 640), "bilinear", 100, 160, ("generic", 1)),
    ("area_pairs", "pairs", (2, 2, 24, 480), "area", 6, 120, ("columns", 2)),
    ("area_pairs_pads", "pairs", (3, 2, 30, 360), "area", 7, 101, ("columns", 2)),
    ("area_seed_3", "pairs", (3, 2, 1080, 1920), "area", 135, 240, ("columns", 2)),
    ("area_planar", "planar", (2, 2, 36, 1000), "area", 9, 125, ("generic", 1)),
    ("area_narrow_view", "narrow", (2, 2, 36, 998), "area", 9, 125, ("generic", 1)),
    ("area_offset_view", "offset", (2, 2, 36, 1000), "area", 9, 125, ("columns", 1)),
    ("area_grow_rows", "pairs", (2, 2, 60, 512), "area", 120, 128, ("band", 1)),
    ("area_grow_rows_5_taps", "pairs", (2, 2, 60, 500), "area", 120, 128, ("band", 1)),
    ("area_grow_cols", "pairs", (2, 2, 512, 60), "area", 128, 120, ("columns", 2)),
    ("area_seed_72x129", "pairs", (2, 2, 72, 129), "area", 36, 64, ("generic", 1)),
    ("area_78_taps", "pairs", (2, 2, 40, 1000), "area", 5, 13, ("generic", 1)),
]


@pytest.mark.parametrize("label,layout,shape,kind,dh,dw,path", RESAMPLE_PLAN_CASES,
                         ids=[c[0] for c in RESAMPLE_PLAN_CASES])
def test_resample_plans(dev, label, layout, shape, kind, dh, dw, path):
    """Each of X1's kernels (`resample.plan`'s band, columns and generic
    paths, 16-byte and element loads) against the plain resize with its
    scale, to the bit, NaN and +-inf placed where they spread; the path
    the host picked is the one named."""
    from optical_flow_tpu_torch.kernels.resample import _table, plan, resize_area
    from optical_flow_tpu_torch.ops.resize import resize_area_f32, resize_bilinear_f32
    n, c, h, w = shape
    gen = torch.Generator(dev).manual_seed(h * w + n)
    x = _odd_values((torch.rand((n, c, h, w + 2), generator=gen, device=dev) - 0.5) * 12.0)
    if layout == "offset":
        x = x[..., 1:w + 1]
    elif layout == "narrow":
        x = x[..., :w]
    else:
        x = x[..., :w].contiguous()
        if layout == "pairs":
            x = x.movedim(1, -1).contiguous().movedim(-1, 1)
    if kind == "bilinear":
        first = plan(x, _table("bilinear", h, dh, dev), _table("bilinear", w, dw, dev), False)
        got, ref = resize_bilinear(x, dw, dh, 2.0), resize_bilinear_f32(x, dw, dh) * 2.0
    else:
        (vert, horiz, vertical_first), *_ = area_plan(h, w, dh, dw)
        first = plan(x, _table(*vert, dev), _table(*horiz, dev), vertical_first)
        got, ref = resize_area(x, dw, dh, 0.125), resize_area_f32(x, dw, dh) * 0.125
    assert (first.path, first.load) == path
    assert got.is_contiguous() and _bit_equal(got, ref)


def test_resample_tables_past_the_frame_raise(dev):
    """A table built for a longer axis, or a row block shorter than its
    table reaches, raises before a launch: the kernel reads no index past
    the frame it is given."""
    from optical_flow_tpu_torch.kernels.resample import _resample, _table, bilinear_rows
    from optical_flow_tpu_torch.ops import resize
    x = torch.zeros((1, 2, 8, 12), device=dev)
    with pytest.raises(ValueError):
        _resample(x, _table("bilinear", 9, 16, dev), _table("bilinear", 12, 24, dev), False)
    with pytest.raises(ValueError):
        _resample(x, _table("bilinear", 8, 16, dev), _table("area", 13, 6, dev), True)
    s0, s1, _ = resize._coeffs_f32(270, 540)
    a, b = 100, 200
    lo, hi = int(s0[a]), int(s1[b - 1]) + 1
    frame = torch.zeros((1, 2, 270, 48), device=dev)
    with pytest.raises(ValueError):                         # a row short at the bottom
        bilinear_rows(frame[..., lo:hi - 1, :], 96, 270, 540, a, b, lo)
    with pytest.raises(ValueError):                         # the block's start past lo
        bilinear_rows(frame[..., lo + 1:hi, :], 96, 270, 540, a, b, lo + 1)
    assert kernels.LAUNCHES["X1"] == 0
    assert bilinear_rows(frame[..., lo:hi, :], 96, 270, 540, a, b, lo).shape == (1, 2, b - a, 96)
    assert kernels.LAUNCHES["X1"] == 1


def _ulps(got, ref):
    """Units in the last place between two non-negative f32 tensors."""
    return (got.view(torch.int32).long() - ref.view(torch.int32).long()).abs()


@pytest.mark.parametrize("b,h,w", [(16, 1080, 1920), (128, 72, 129), (7, 1079, 1917),
                                   (3, 1, 1), (2, 5, 7), (1, 360, 365), (2, 256, 512),
                                   (1, 4320, 7680)])
def test_magnitude_sum_kernel(dev, b, h, w):
    """X2 within 1 ulp of the plain version per pair, equal across two
    runs, and each pair's sum the same alone as in the batch."""
    from optical_flow_tpu_torch.ops.polar import magnitude_sums as plain
    gen = torch.Generator(dev).manual_seed(b * h)
    flow = (torch.rand((b, 2, h, w), generator=gen, device=dev) - 0.5) * 12.0
    got = magnitude_sum(flow)
    # the span sums, and the combine past one span of 2^17 pixels
    assert kernels.LAUNCHES["X2"] == (1 if h * w <= 1 << 17 else 2) and got.shape == (b,)
    assert int(_ulps(got, plain(flow[:, 0], flow[:, 1])).max()) <= 1
    assert torch.equal(magnitude_sum(flow), got)
    for i in {0, b // 2, b - 1}:
        assert torch.equal(magnitude_sum(flow[i:i + 1]), got[i:i + 1])


def test_magnitude_sum_checks_and_nan(dev):
    """A NaN spoils its own pair's sum alone; the wrapper takes planar,
    contiguous (B, 2, H, W) f32 only."""
    from optical_flow_tpu_torch.ops.polar import magnitude_sums as plain
    flow = torch.ones((3, 2, 40, 64), device=dev)
    flow[1, 0, 5, 5] = float("nan")
    got = magnitude_sum(flow)
    ref = plain(flow[:, 0], flow[:, 1])
    assert torch.isnan(got[1]) and torch.equal(got[0], got[2])
    assert int(_ulps(got[0::2], ref[0::2]).max()) <= 1
    with pytest.raises(ValueError):
        magnitude_sum(flow[:, :1])                              # not planar (B, 2, H, W)
    with pytest.raises(ValueError):
        magnitude_sum(flow.movedim(1, -1).contiguous().movedim(-1, 1))   # strided
    assert kernels.LAUNCHES["X2"] == 1
