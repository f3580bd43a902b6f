"""The port's device meshes and sharded steps (`optical_flow_tpu_torch/
parallel/mesh.py`), and the extractor's, visualizer's and warmers' mesh
routes, against the JAX package's mesh on the same numpy inputs, on the
CPU.

JAX runs on the suite's 8 forced host devices (tests/conftest.py); the
port's meshes repeat the CPU device.  Inputs are JAX's own fixtures
(tests/test_parallel.py): `smooth_texture_pair(96, 128, (1, 2), seed=s)`
for s in 0..7 and its 10-frame rolled chain.  Flow and sums: atol 1e-4 /
rtol 1e-4 against JAX, as JAX's own mesh tests; the port's sharded steps
equal its one-device entries to the bit (each pair's compute, its
magnitude sum included, is independent of the split).  BGR: the port's gate against JAX (at most 1e-3 of the bytes
differ), and byte-equal to the port's one-device entry.
"""

import jax
import numpy as np
import pytest
import torch

from optical_flow_tpu.models.farneback import calc_flow_bgr_chain_batched as jax_bgr_chain
from optical_flow_tpu.oracle import smooth_texture_pair
from optical_flow_tpu.parallel import chain_shards as jax_chain_shards
from optical_flow_tpu.parallel import make_mesh as jax_make_mesh
from optical_flow_tpu.parallel import shard_pairs as jax_shard_pairs
from optical_flow_tpu.parallel import sharded_bgr_chain_step as jax_bgr_chain_step
from optical_flow_tpu.parallel import sharded_extract_step as jax_extract_step
from optical_flow_tpu.parallel import sharded_flow_step as jax_flow_step
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.models.farneback.flow import (calc_flow_batched,
                                                          calc_flow_bgr_batched,
                                                          calc_flow_bgr_chain_batched)
from optical_flow_tpu_torch.parallel import (chain_shards, make_mesh, shard_pairs,
                                             sharded_bgr_chain_step, sharded_bgr_step,
                                             sharded_extract_step, sharded_flow_step)
from optical_flow_tpu_torch.parallel import mesh as tmesh
from optical_flow_tpu_torch.pipeline import extractor, prefetch, visualizer
from optical_flow_tpu_torch.pipeline.extractor import magnitude_sums
from optical_flow_tpu_torch.utils.config import ExtractorConfig
from optical_flow_tpu_torch.utils.metrics import PipelineMetrics

CPU = torch.device("cpu")
FLOW_TOL = dict(atol=1e-4, rtol=1e-4)


def _mesh(n_dp, n_sp=1):
    return make_mesh(n_dp, n_sp, devices=[CPU] * (n_dp * n_sp))


def _jax_mesh(n_dp, n_sp=1):
    return jax_make_mesh(n_dp, n_sp, devices=jax.devices()[:n_dp * n_sp])


@pytest.fixture(scope="module")
def batch():
    pairs = [smooth_texture_pair(96, 128, (1, 2), seed=s) for s in range(8)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def chain():
    """tests/test_parallel.py's 10-frame chain (9 pairs)."""
    rng = np.random.default_rng(3)
    base = smooth_texture_pair(96, 128, (1, 2), seed=3)[0]
    return np.stack([np.roll(base, (i, 2 * i), (0, 1))
                     + rng.integers(0, 2, base.shape).astype(base.dtype)
                     for i in range(10)])


def _bgr_gate(got, ref):
    """tests/test_torch_visualizer.py's BGR gate against JAX: at most 1e-3
    of the bytes differ (a flow that differs in its last bits can flip a
    truncated hue or value level, which moves a channel by up to 8.5)."""
    share = float((np.asarray(got) != np.asarray(ref)).mean())
    assert share <= 1e-3, share


def test_dp_flow_and_sums_match_jax(batch):
    prev, nxt = batch
    jm = _jax_mesh(8)
    ref = np.asarray(jax_flow_step(jm, jax_shard_pairs(jm, prev), jax_shard_pairs(jm, nxt)))
    ref_sums = np.asarray(jax_extract_step(jm, jax_shard_pairs(jm, prev),
                                           jax_shard_pairs(jm, nxt)))
    mesh = _mesh(8)
    flow = sharded_flow_step(mesh, shard_pairs(mesh, prev), shard_pairs(mesh, nxt))
    sums = sharded_extract_step(mesh, prev, nxt)
    np.testing.assert_allclose(flow.numpy(), ref, **FLOW_TOL)
    np.testing.assert_allclose(sums.numpy(), ref_sums, **FLOW_TOL)
    assert torch.equal(flow, calc_flow_batched(prev, nxt, device="cpu"))
    assert torch.equal(sums, magnitude_sums(prev, nxt, device="cpu"))


def test_dp_uneven_batch_and_bgr_step(batch):
    """B need not divide the data shards: 5 pairs on 2 shards split 3 + 2."""
    prev, nxt = batch[0][:5], batch[1][:5]
    mesh = _mesh(2)
    sp = shard_pairs(mesh, prev)
    assert [blk[0].shape[0] for blk in sp.blocks] == [3, 2] and sp.shape == (5, 96, 128)
    assert torch.equal(sharded_flow_step(mesh, prev, nxt),
                       calc_flow_batched(prev, nxt, device="cpu"))
    assert torch.equal(sharded_bgr_step(mesh, prev, nxt),
                       calc_flow_bgr_batched(prev, nxt, device="cpu"))


def test_dp_sp_flow_matches_jax(batch):
    """dp x sp 2x2 at 64x128: the halo path inside each data shard."""
    prev, nxt = batch[0][:4, :64], batch[1][:4, :64]
    jm = _jax_mesh(2, 2)
    ref = np.asarray(jax_flow_step(jm, jax_shard_pairs(jm, prev), jax_shard_pairs(jm, nxt)))
    flow = sharded_flow_step(_mesh(2, 2), prev, nxt)
    np.testing.assert_allclose(flow.numpy(), ref, **FLOW_TOL)
    one = calc_flow_batched(prev, nxt, device="cpu")
    d = (flow - one).abs()
    assert float(d.max()) <= 1e-4


@pytest.mark.parametrize("N,n", [(10, 8), (10, 3), (17, 2), (18, 2), (5, 4), (2, 1)])
def test_chain_shards_equal_jax_s(chain, N, n):
    frames = np.concatenate([chain] * 2)[:N]
    got = chain_shards(frames, n)
    ref = np.asarray(jax_chain_shards(frames, n))
    assert tuple(got.shape) == ref.shape == (n, -(-(N - 1) // n) + 1, 96, 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[:-1, -1].numpy(), got[1:, 0].numpy())  # overlap


def test_bgr_chain_matches_jax(chain):
    mesh = _mesh(8)
    nk = chain_shards(chain, 8)                  # k = 2, the tail padded
    assert tuple(nk.shape) == (8, 3, 96, 128)
    got = sharded_bgr_chain_step(mesh, nk)[:9]
    jm = _jax_mesh(8)
    ref = np.asarray(jax_bgr_chain_step(jm, jax_chain_shards(chain, 8)))[:9]
    _bgr_gate(got.numpy(), ref)
    _bgr_gate(got.numpy(), np.asarray(jax_bgr_chain(chain)))
    assert torch.equal(got, calc_flow_bgr_chain_batched(chain, device="cpu"))
    with pytest.raises(ValueError, match="sub-chains"):
        sharded_bgr_chain_step(mesh, chain_shards(chain, 4))


def test_extractor_branch_pads_and_trims(batch, monkeypatch):
    """B = 7 on 4 shards: padded to 8 with the last pair, sums[:7], equal to
    the one-device branch to the bit and to JAX's mesh branch (its 8
    forced devices pad 7 to 8 too)."""
    from optical_flow_tpu.pipeline import extractor as jax_extractor

    from optical_flow_tpu_torch.parallel import mesh as port_mesh

    prev, nxt = batch[0][:7], batch[1][:7]
    seen = []
    shard_flows = port_mesh._shard_flows

    def spy(mesh, p, n, config):
        p = torch.as_tensor(p)
        seen.append((tuple(p.shape), torch.equal(p[7], p[6])))
        return shard_flows(mesh, p, n, config)

    monkeypatch.setattr(port_mesh, "_shard_flows", spy)
    cfg = ExtractorConfig()
    sums, finite = extractor._magnitude_sums(prev, nxt, cfg, device=CPU, mesh=_mesh(4),
                                             nan_check=True)
    assert seen == [((8, 96, 128), True)]
    assert tuple(sums.shape) == (7,) and bool(finite)
    one, _ = extractor._magnitude_sums(prev, nxt, cfg, device=CPU)
    assert torch.equal(sums, one)
    ref = np.asarray(jax_extractor._magnitude_sums(prev, nxt, cfg))
    np.testing.assert_allclose(sums.numpy(), ref, **FLOW_TOL)


def test_make_mesh_sizes():
    mesh = _mesh(2, 4)
    assert mesh.shape == {"data": 2, "spatial": 4} and mesh.devices.shape == (2, 4)
    assert mesh.devices.size == 8 and mesh.devices.dtype == object
    assert make_mesh(devices=[CPU] * 6).shape == {"data": 6, "spatial": 1}
    assert make_mesh(n_spatial=3, devices=[CPU] * 6).shape == {"data": 2, "spatial": 3}
    for args in [(3, 1), (4, 2), (None, 4), (None, 0), (0, 1)]:
        with pytest.raises(ValueError):
            make_mesh(*args, devices=[CPU] * 6)
        with pytest.raises(ValueError):
            _jax_mesh_of(args, 6)


def _jax_mesh_of(args, n):
    """JAX's make_mesh on the same sizes (it raises ValueError for each; a
    zero spatial count divides by zero, which the port reports as a
    ValueError too)."""
    try:
        return jax_make_mesh(*args, devices=jax.devices()[:n])
    except ZeroDivisionError as e:
        raise ValueError(str(e)) from e


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default mesh is its cards")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()


def test_dp_mesh_rules(monkeypatch):
    """A mesh only with several cards, OFT_DISABLE_MESH unset and no device
    named (None, or "cuda" without an index)."""
    sentinel = object()
    monkeypatch.setattr(tmesh, "make_mesh", lambda n_spatial: sentinel)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("OFT_DISABLE_MESH", raising=False)
    tmesh.dp_mesh.cache_clear()
    try:
        assert tmesh.dp_mesh() is sentinel
        assert tmesh.dp_mesh("cuda") is sentinel
        assert tmesh.dp_mesh("cuda:0") is None
        assert tmesh.dp_mesh("cpu") is None
        tmesh.dp_mesh.cache_clear()
        monkeypatch.setenv("OFT_DISABLE_MESH", "1")
        assert tmesh.dp_mesh() is None
        tmesh.dp_mesh.cache_clear()
        monkeypatch.delenv("OFT_DISABLE_MESH")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert tmesh.dp_mesh() is None
    finally:
        tmesh.dp_mesh.cache_clear()


def test_extract_frames_through_a_mesh(batch, monkeypatch):
    """The extractor's device loop with a 3-way mesh gives the one-device
    loop's results to the bit, chunks of 4 windows padded to 6 pairs."""
    frames = [(i, f) for i, f in enumerate(np.concatenate([batch[0][:5], batch[1][:5]]))]
    windows = [(i, (i, i + 1)) for i in range(9)]
    cfg = ExtractorConfig()
    solo = extractor.extract_frames(frames, windows, cfg, chunk_size=4, device="cpu")
    monkeypatch.setattr(extractor, "dp_mesh", lambda device=None: _mesh(3))
    meshed = extractor.extract_frames(frames, windows, cfg, chunk_size=4, device="cpu")
    assert meshed == solo and len(solo) == 9


def test_visualize_frames_through_a_mesh(chain, monkeypatch):
    """The visualizer's device loop with a 4-way mesh: each chunk split
    into overlapping sub-chains, the BGR bytes of the one-device loop."""
    frames = [(float(i), f) for i, f in enumerate(chain)]

    def run():
        out = []
        n = visualizer.visualize_frames(frames, lambda pos, bgr: out.append((pos, bgr)),
                                        chunk_size=5, device="cpu")
        return n, out

    n_solo, solo = run()
    monkeypatch.setattr(visualizer, "dp_mesh", lambda device=None: _mesh(4))
    n_mesh, meshed = run()
    assert n_mesh == n_solo == 9
    for (p, a), (q, b) in zip(meshed, solo):
        assert p == q
        np.testing.assert_array_equal(a, b)


def test_visualize_frames_pixel_budget_scales_with_the_mesh(chain, monkeypatch):
    """The visualizer's dispatch budget is one card's pixels times the
    mesh's cards: at 2 pairs a card, one device dispatches 9 pairs as
    2, 2, 2, 2, 1 and a 2-way mesh as 4, 4, 1, with the same BGR bytes."""
    frames = [(float(i), f) for i, f in enumerate(chain)]
    monkeypatch.setattr(prefetch, "DISPATCH_PIXELS", 2 * chain[0].size)
    sizes = []
    split = visualizer.chain_shards

    def shards(frames, n):
        sizes.append(frames.shape[0] - 1)
        return split(frames, n)

    monkeypatch.setattr(visualizer, "chain_shards", shards)

    def run():
        out = []
        m = PipelineMetrics("visualize")
        visualizer.visualize_frames(frames, lambda pos, bgr: out.append(bgr),
                                    chunk_size=8, device="cpu", metrics=m)
        return np.stack(out), m.counters

    solo, solo_counts = run()
    monkeypatch.setattr(visualizer, "dp_mesh", lambda device=None: _mesh(2))
    meshed, mesh_counts = run()
    assert (solo_counts["dispatches"], solo_counts["early_dispatches"]) == (5, 4)
    assert sizes == [4, 4, 1]
    assert (mesh_counts["dispatches"], mesh_counts["early_dispatches"]) == (3, 2)
    np.testing.assert_array_equal(meshed, solo)


def test_warmers_through_a_mesh(monkeypatch):
    from optical_flow_tpu_torch.utils import warmup
    monkeypatch.setattr(warmup, "dp_mesh", lambda device=None: _mesh(2))
    kernels.reset_launches()
    ext = warmup.warmup_extractor(24, 32, ExtractorConfig(frame_width=32), device="cpu")
    vis = warmup.warmup_visualizer(24, 32, device="cpu")
    assert ext["shards"] == vis["shards"] == 2
    assert vis["chunk"] == prefetch.dispatch_pairs(24, 32, prefetch.pair_chunk_for(24, 32), 2)
    assert vis["shape"] == [vis["chunk"] + 1, 24, 32]
    assert all(v == 0 for v in kernels.LAUNCHES.values())
