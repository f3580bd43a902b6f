"""The port's halo-exchanged stages (`optical_flow_tpu_torch/parallel/halo.py`)
against the JAX package's `HaloKernels(..., use_pallas=False)` and the
one-device op, on the CPU, mirroring tests/test_halo.py's
TestStageEquality.

The port's meshes repeat the CPU device, as the JAX tests force 8 host
devices (tests/conftest.py).  A port stage takes the row blocks of one
spatial group; JAX's takes global arrays, so its calls are jitted here
(one compile per stage and shape instead of an eager shard_map per op).
Stages: atol 1e-4 / rtol 1e-5 (ROADMAP's f32 stage gate; JAX's own
decomposition differs from its global op by float reassociation), and the
port's decomposed stencils equal its one-device op to the bit (direct
sums, same order).  The fallbacks (indivisible height, shallow shards, a
deep halo) equal the one-device op to the bit: the same op on the
gathered array.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from optical_flow_tpu.models.farneback import core as jcore
from optical_flow_tpu.models.farneback.params import gaussian_kernel
from optical_flow_tpu.parallel import make_mesh as jax_make_mesh
from optical_flow_tpu.parallel.halo import HaloKernels as JaxHaloKernels
from optical_flow_tpu.parallel.halo import halo_extend as jax_halo_extend
from optical_flow_tpu_torch.models.farneback import core
from optical_flow_tpu_torch.ops.resize import resize_bilinear_f32
from optical_flow_tpu_torch.parallel import HaloKernels, halo_extend, make_mesh
from optical_flow_tpu_torch.parallel.halo import WIN_H, Blocks

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-5)


def _jax_mesh(n_dp, n_sp):
    return jax_make_mesh(n_dp, n_sp, devices=jax.devices()[:n_dp * n_sp])


def _port(n_dp, n_sp):
    """The port's HaloKernels over an n_dp x n_sp mesh of the CPU, and the
    devices of its first spatial group."""
    mesh = make_mesh(n_dp, n_sp, devices=[CPU] * (n_dp * n_sp))
    return HaloKernels(mesh), list(mesh.devices[0])


def _split(x, devices) -> Blocks:
    return Blocks.split(torch.as_tensor(np.array(x)), devices)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, (4, 64, 128)).astype(np.float32)


@pytest.mark.parametrize("mode", ["reflect101", "edge"])
@pytest.mark.parametrize("n_sp", [1, 2, 4])
def test_halo_extend_rows_equal_jax_s(n_sp, mode):
    rng = np.random.default_rng(n_sp)
    x = rng.uniform(0, 255, (2, 3, 32, 16)).astype(np.float32)
    r = 3
    if n_sp == 1:
        ref = np.asarray(jax_halo_extend(x, r, 1, mode))
    else:
        fn = jax.shard_map(lambda xl: jax_halo_extend(xl, r, n_sp, mode),
                           mesh=_jax_mesh(1, n_sp),
                           in_specs=P(None, None, "spatial", None),
                           out_specs=P(None, None, "spatial", None), check_vma=False)
        ref = np.asarray(jax.jit(fn)(x))
    _, devs = _port(1, n_sp)
    got = halo_extend(_split(x, devs), r, mode)
    assert [tuple(g.shape) for g in got] == [(2, 3, 32 // n_sp + 2 * r, 16)] * n_sp
    np.testing.assert_array_equal(torch.cat(got, dim=-2).numpy(), ref)


def test_halo_extend_refuses_a_halo_past_the_neighbour():
    _, devs = _port(1, 4)
    x = _split(np.zeros((1, 16, 8), np.float32), devs)       # 4 rows a block
    assert len(halo_extend(x, 3, "edge")) == 4
    with pytest.raises(ValueError, match="halo depth 4"):
        halo_extend(x, 4, "edge")


@pytest.mark.parametrize("ks,sigma", [(9, 1.5), (5, 1.1), (3, 0.0)])
def test_gauss(imgs, ks, sigma):
    taps = gaussian_kernel(ks, sigma)
    hk, devs = _port(2, 4)
    assert hk._plan(64, ks // 2)
    got = hk.gauss(_split(imgs, devs), taps).gather()
    jhk = JaxHaloKernels(_jax_mesh(2, 4), use_pallas=False)
    _close(got, jax.jit(lambda x: jhk.gauss(x, taps))(imgs))
    _close(got, jcore.gaussian_blur_reflect101(imgs, taps))
    assert torch.equal(got, core.gaussian_blur_reflect101(torch.as_tensor(imgs), taps))


@pytest.mark.parametrize("n_sp", [2, 4])
def test_poly_exp(imgs, n_sp):
    hk, devs = _port(8 // n_sp, n_sp)
    got = hk.poly_exp(_split(imgs, devs), 5, 1.2).gather()
    jhk = JaxHaloKernels(_jax_mesh(8 // n_sp, n_sp), use_pallas=False)
    _close(got, jax.jit(lambda x: jhk.poly_exp(x, 5, 1.2))(imgs))
    _close(got, jcore.poly_exp(imgs, 5, 1.2))
    assert torch.equal(got, core.poly_exp(torch.as_tensor(imgs), 5, 1.2))
    with pytest.raises(ValueError, match="pre-smooth"):
        hk.poly_exp(_split(imgs, devs), 5, 1.2, pre_taps=gaussian_kernel(3, 0.0))


def _matrices(shape, seed):
    rng = np.random.default_rng(seed)
    r4, r5, r6, r2, r3 = (rng.standard_normal(shape).astype(np.float32)
                          for _ in range(5))
    return np.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], axis=1)


@pytest.mark.parametrize("ws,gaussian", [(15, False), (21, False), (15, True)])
def test_blur_solve(ws, gaussian):
    M = _matrices((4, 64, 128), 1)
    hk, devs = _port(2, 4)
    got = hk.blur_solve(_split(M, devs), ws, gaussian).gather()
    jhk = JaxHaloKernels(_jax_mesh(2, 4), use_pallas=False)
    _close(got, jax.jit(lambda m: jhk.blur_solve(m, ws, gaussian))(M))
    _close(got, JaxHaloKernels._fallback_blur(M, ws, gaussian))
    assert torch.equal(got, core.blur_solve(torch.as_tensor(M), ws, gaussian))


def _update_inputs(h=128, w=128, B=2, seed=6):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (2 * B, h, w)).astype(np.float32)
    R = np.asarray(jcore.poly_exp(img, 5, 1.2))
    flow = rng.standard_normal((B, 2, h, w)).astype(np.float32) * 2
    return R[:B], R[B:], flow


@pytest.fixture(scope="module")
def jax_update_2x2():
    """JAX's sharded update on its 2x2 mesh, compiled once for the
    (2, 5, 128, 128) cases."""
    jhk = JaxHaloKernels(_jax_mesh(2, 2), use_pallas=False)
    return jax.jit(jhk.update_matrices_stats)


def _flow_case(case):
    R0, R1, flow = _update_inputs()
    if case == "smooth_flow":
        # keep the global-border fetches in the image (tests/test_halo.py)
        flow[:, 1, :8] = 0.3
        flow[:, 1, -8:] = -0.3
    elif case == "cross_seam_spill":
        flow[:, 1, 60:64, 40:90] = 45.0       # shard 0 -> deep in shard 1
    elif case == "edge_fallback":
        flow[:, 1, :8, :] = -6.0              # y1 < 0, inside the top halo
    elif case == "out_of_image":
        flow[:, 1] = 1e4                      # the fallback everywhere
    return R0, R1, flow


@pytest.mark.parametrize("case", ["smooth_flow", "cross_seam_spill", "edge_fallback",
                                  "out_of_image"])
def test_update(case, jax_update_2x2):
    R0, R1, flow = _flow_case(case)
    hk, devs = _port(2, 2)
    assert hk._plan(128, WIN_H)                # really sharded
    M, n_fixed = hk.update_matrices_stats(*(_split(t, devs) for t in (R0, R1, flow)))
    got = M.gather()
    # out of image: every M term is R0's alone, and the border rows'
    # post-multiply moves the last bits of larger values; JAX's own test
    # holds its decomposition to rtol 1e-4 there
    tol = dict(atol=1e-4, rtol=1e-4) if case == "out_of_image" else TOL
    _close(got, jax_update_2x2(R0, R1, flow)[0], **tol)
    _close(got, jcore.update_matrices(R0, R1, flow), **tol)
    _close(got, core.update_matrices(*(torch.as_tensor(t) for t in (R0, R1, flow))), **tol)
    if case == "cross_seam_spill":
        assert n_fixed >= 2 * 4 * 50           # every spilled fetch recomputed
    if case == "edge_fallback":
        assert n_fixed > 0


def test_update_four_shards():
    R0, R1, flow = _update_inputs(h=256, B=1)
    flow[:, 1, 120:128, :30] = 50.0
    hk, devs = _port(1, 4)
    assert hk._plan(256, WIN_H)
    M, n_fixed = hk.update_matrices_stats(*(_split(t, devs) for t in (R0, R1, flow)))
    jhk = JaxHaloKernels(_jax_mesh(1, 4), use_pallas=False)
    _close(M.gather(), jax.jit(jhk.update_matrices_stats)(R0, R1, flow)[0])
    _close(M.gather(), jcore.update_matrices(R0, R1, flow))
    assert n_fixed >= 8 * 30


def test_update_fallback_on_shallow_shards():
    # hl = 16 < WIN_H + 1: the one-device op on the gathered arrays, exactly
    R0, R1, flow = _update_inputs()
    hk, devs = _port(1, 8)
    assert not hk._plan(128, WIN_H)
    M, n_fixed = hk.update_matrices_stats(*(_split(t, devs) for t in (R0, R1, flow)))
    ref = core.update_matrices(*(torch.as_tensor(t) for t in (R0, R1, flow)))
    assert torch.equal(M.gather(), ref) and n_fixed == 0
    assert [tuple(p.shape) for p in M.parts] == [(2, 5, 16, 128)] * 8
    _close(M.gather(), jcore.update_matrices(R0, R1, flow))


def test_fallback_on_indivisible_height():
    # h = 66 % 4 != 0: the one-device op, exactly; blocks of 17, 17, 16, 16
    x = np.random.default_rng(2).uniform(0, 255, (4, 66, 128)).astype(np.float32)
    taps = gaussian_kernel(9, 1.5)
    hk, devs = _port(2, 4)
    out = hk.gauss(_split(x, devs), taps)
    assert [p.shape[-2] for p in out.parts] == [17, 17, 16, 16]
    assert torch.equal(out.gather(), core.gaussian_blur_reflect101(torch.as_tensor(x), taps))
    _close(out.gather(), jcore.gaussian_blur_reflect101(x, taps))


def test_fallback_on_deep_halo():
    # local height 8 cannot host a 10-row halo (winsize 21): the global op.
    # M as an update builds it (G positive semidefinite): on raw normals the
    # 2x2 solves are near singular and amplify JAX's prefix-sum box error
    M = _matrices((4, 64, 128), 3)
    hk, devs = _port(1, 8)
    assert not hk._plan(64, 10)
    got = hk.blur_solve(_split(M, devs), 21, False).gather()
    assert torch.equal(got, core.blur_solve(torch.as_tensor(M), 21, False))
    _close(got, JaxHaloKernels._fallback_blur(M, 21, False))


@pytest.mark.parametrize("n_sp", [2, 3, 4])
@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)), ((33, 50), (17, 25)),
                                     ((17, 25), (33, 50)), ((135, 240), (270, 480))])
def test_resize_per_block_equals_the_one_device_resize(n_sp, src, dst):
    """The level resize and the flow's upsample run per output block on the
    source rows it reads: the one-device resize's rows, to the bit."""
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((2, 2) + src)
                        .astype(np.float32))
    hk, devs = _port(1, n_sp)
    out = hk.resize_bilinear(Blocks.split(x, devs), dst[1], dst[0])
    assert [p.shape[-2] for p in out.parts] == [
        p.shape[-2] for p in torch.tensor_split(torch.empty(dst), n_sp)]
    assert torch.equal(out.gather(), resize_bilinear_f32(x, dst[1], dst[0]))
