"""Device meshes and sharded flow steps over the local cards, a port of
`optical_flow_tpu.parallel.mesh`.

  * data parallelism: the frame-pair batch is split over the mesh's
    'data' axis; each shard runs the port's one-device pyramid
    (`models/farneback/flow.py:_flow_pyramid`: K3/K6 -> K2 -> K1, or
    K5a -> K5b past K1's window, and K4 for BGR) on its own device.  The
    shards are launched back to back, each on its device's current
    stream, with no host sync between them; their outputs are gathered
    on the mesh's first device;
  * spatial parallelism: with 'spatial' > 1 the frame height is split
    too, and each stage runs as a halo-exchanged block per device
    (`parallel/halo.py`), for frames that outgrow one card.

A mesh is a grid of `torch.device`s, any of them, repeated or not: the
CPU tests and the one-card smoke build 2-, 4- and 8-way meshes from one
device, as the JAX tests force 8 host devices.  There is no NCCL and no
second process: one process launches on every card of its host, and
blocks move with peer copies.  A CUDA device runs the kernels, the CPU
their plain versions.

Not ported: the per-shard exactness-tier counters (`_note_shard_tiers`).
They count the TPU gather's spill tiers, and the card's gather is exact
with no tiers to count.

Every per-pair computation here is independent of how the batch is
split, so the flow and the BGR equal the one-device entries' to the bit.
The magnitude sums too: X2 (`kernels/magnitude_sum.py`) sums each pair in
an order fixed by (H, W) alone, so each shard sums its own pairs and the
(B,) sums are gathered.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from optical_flow_tpu_torch.kernels.colorize import flow_to_bgr_planar
from optical_flow_tpu_torch.kernels.magnitude_sum import magnitude_sum
from optical_flow_tpu_torch.models.farneback.flow import (_flow_pyramid,
                                                          _on_device)
from optical_flow_tpu_torch.models.farneback.params import build_plan
from optical_flow_tpu_torch.parallel.halo import Blocks, HaloKernels
from optical_flow_tpu_torch.utils.config import FarnebackConfig
from optical_flow_tpu_torch.utils.device import default_device, resolve_device


class Mesh:
    """A ('data', 'spatial') grid of devices: `devices` is a numpy object
    array of shape (n_data, n_spatial), `shape` maps each axis name to its
    size, as a JAX mesh does."""

    axis_names = ("data", "spatial")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices=None) -> Mesh:
    """Build a ('data', 'spatial') mesh over `devices`, by default every
    visible CUDA card (raises RuntimeError where there is none).  Any
    `torch.device`s may be named, one more than once; the sizes must
    multiply to their count (ValueError)."""
    if devices is None:
        default_device()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n_total = len(devices)
    if n_spatial < 1:
        raise ValueError(f"mesh needs n_spatial >= 1, got {n_spatial}")
    if n_data is None:
        n_data = n_total // n_spatial
    if n_data * n_spatial != n_total or n_total == 0:
        raise ValueError(f"mesh {n_data}x{n_spatial} != {n_total} devices")
    arr = np.empty(n_total, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_data, n_spatial))


@functools.lru_cache(maxsize=8)
def dp_mesh(device=None) -> Optional[Mesh]:
    """The device loops' data-parallel mesh over every visible card, or
    None: with OFT_DISABLE_MESH=1, with one card or none visible, or where
    the caller named a device (an indexed card, or the CPU; None and
    "cuda" name none), as the JAX package's `_dp_mesh`
    (`pipeline/extractor.py:70-80`)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return None
    if os.environ.get("OFT_DISABLE_MESH") == "1":
        return None
    if torch.cuda.device_count() <= 1:
        return None
    return make_mesh(n_spatial=1)


class ShardedBatch(NamedTuple):
    """A (B, H, W) batch placed on a mesh: `blocks[i][j]` holds the i-th
    slice of the batch (B split over 'data') and its j-th rows (H split
    over 'spatial'), on `mesh.devices[i, j]`.  `torch.tensor_split`
    sizes: equal where the axis divides, else the first blocks one
    longer."""
    blocks: tuple
    shape: tuple


def shard_pairs(mesh: Mesh, batch) -> ShardedBatch:
    """Place a (B, H, W) batch (numpy or tensor) with B over 'data' and H
    over 'spatial'.  uint8 stays uint8; any other dtype becomes f32."""
    batch = torch.as_tensor(batch)
    if batch.dim() != 3:
        raise ValueError(f"expected (B, H, W), got {tuple(batch.shape)}")
    n_data, n_sp = mesh.devices.shape
    blocks = tuple(
        tuple(_on_device(rows.contiguous(), mesh.devices[i, j])
              for j, rows in enumerate(torch.tensor_split(part, n_sp, dim=-2)))
        for i, part in enumerate(torch.tensor_split(batch, n_data)))
    return ShardedBatch(blocks, tuple(batch.shape))


def _sharded(mesh: Mesh, x) -> ShardedBatch:
    if isinstance(x, ShardedBatch):
        if (len(x.blocks), len(x.blocks[0])) != mesh.devices.shape:
            raise ValueError(f"batch sharded over a {len(x.blocks)}x{len(x.blocks[0])} "
                             f"mesh, not {mesh.devices.shape}")
        return x
    return shard_pairs(mesh, x)


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices[0, 0]


def _shard_flows(mesh: Mesh, prev, nxt, config: FarnebackConfig) -> list:
    """The planar (b_i, 2, H, W) flow of each data shard that holds pairs,
    on its device; with 'spatial' > 1 each stage runs on the row blocks of
    the shard's spatial group and the flow's blocks are gathered once, on
    the mesh's first device.  All launched before any is read."""
    prev, nxt = _sharded(mesh, prev), _sharded(mesh, nxt)
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {prev.shape} vs {nxt.shape}")
    _, h, w = prev.shape
    plan = build_plan(h, w, config)
    sp = HaloKernels(mesh) if mesh.shape["spatial"] > 1 else None
    flows = []
    for p_row, n_row in zip(prev.blocks, nxt.blocks):
        if p_row[0].shape[0] == 0:
            continue
        if sp is None:
            flows.append(_flow_pyramid(torch.cat([p_row[0], n_row[0]]), plan,
                                       plain=False, chain=False))
        else:
            both = Blocks([torch.cat([p, n]) for p, n in zip(p_row, n_row)])
            flows.append(_flow_pyramid(both, plan, plain=False, chain=False,
                                       sp_kernels=sp).gather(_first(mesh)))
    return flows


def _gather(parts, device: torch.device) -> torch.Tensor:
    """Per-shard tensors concatenated on `device`."""
    return torch.cat([p.to(device) for p in parts])


def sharded_flow_step(mesh: Mesh, prev, nxt,
                      config: FarnebackConfig = FarnebackConfig()) -> torch.Tensor:
    """(B, H, W) uint8 pairs -> (B, H, W, 2) f32 flow on the mesh's first
    device, dp+sp sharded; equal to calc_flow_batched's."""
    flows = _shard_flows(mesh, prev, nxt, config)
    return _gather(flows, _first(mesh)).movedim(1, -1)


def _shard_magnitude_sums(mesh: Mesh, prev, nxt, config: FarnebackConfig,
                          nan_check: bool = False):
    """(B,) f32 sums of the flow magnitude per pair on the mesh's first
    device, each shard's summed by X2 on its device, and with nan_check a
    device bool: whether every flow component is finite."""
    sums, finite = [], []
    for f in _shard_flows(mesh, prev, nxt, config):
        sums.append(magnitude_sum(f))
        if nan_check:
            finite.append(torch.isfinite(f).all())
    dev = _first(mesh)
    ok = torch.stack([t.to(dev) for t in finite]).all() if nan_check else None
    return _gather(sums, dev), ok


def sharded_extract_step(mesh: Mesh, prev, nxt,
                         config: FarnebackConfig = FarnebackConfig()) -> torch.Tensor:
    """The extractor's device step: (B, H, W) pairs -> (B,) summed
    magnitudes (`np.sum(mag)` of `optical_flow.py:64`), dp+sp sharded, on
    the mesh's first device; equal to magnitude_sums'."""
    return _shard_magnitude_sums(mesh, prev, nxt, config)[0]


def sharded_bgr_step(mesh: Mesh, prev, nxt,
                     config: FarnebackConfig = FarnebackConfig()) -> torch.Tensor:
    """(B, H, W) gray pairs -> planar BGR uint8 (B, 3, H, W) on the mesh's
    first device, dp sharded (the per-frame min-max normalize is
    per-image, so dp is exact)."""
    return _gather([flow_to_bgr_planar(f) for f in _shard_flows(mesh, prev, nxt, config)],
                   _first(mesh))


def chain_shards(frames, n: int) -> torch.Tensor:
    """(N, H, W) consecutive frames -> (n, k+1, H, W) overlapping
    sub-chains for sharded_bgr_chain_step: shard i gets frames
    [i*k, (i+1)*k] inclusive, so its last frame is shard i+1's first
    (k = ceil((N-1)/n) pairs per shard; the tail is padded by repeating
    the last frame and those pairs' outputs are the caller's to drop).
    The one frame per shard that two shards share is the whole cost of
    keeping the chained pairs under dp sharding."""
    frames = torch.as_tensor(frames)
    N = frames.shape[0]
    k = -(-(N - 1) // n)
    total = n * k + 1
    if total > N:
        frames = torch.cat([frames, frames[-1:].expand((total - N,) + frames.shape[1:])])
    idx = torch.arange(n)[:, None] * k + torch.arange(k + 1)[None, :]
    return frames[idx.to(frames.device)]


def _bgr_chain_shards(mesh: Mesh, frames_nk, config: FarnebackConfig,
                      nan_check: bool = False) -> list:
    """Each data shard's sub-chain through the chained pyramid and K4 on
    the shard's first device: [(planar BGR (k, 3, H, W), finite or
    None)], launched back to back.  The visualizer downloads the shards
    one by one; sharded_bgr_chain_step gathers them."""
    frames_nk = torch.as_tensor(frames_nk)
    n, k1, h, w = frames_nk.shape
    if n != mesh.shape["data"]:
        raise ValueError(f"{n} sub-chains for a mesh of {mesh.shape['data']} data shards")
    plan = build_plan(h, w, config)
    out = []
    for i in range(n):
        chain = _on_device(frames_nk[i], mesh.devices[i, 0])
        flow = _flow_pyramid(chain, plan, plain=False, chain=True)
        out.append((flow_to_bgr_planar(flow),
                    torch.isfinite(flow).all() if nan_check else None))
    return out


def sharded_bgr_chain_step(mesh: Mesh, frames_nk,
                           config: FarnebackConfig = FarnebackConfig()) -> torch.Tensor:
    """(n_data, k+1, H, W) overlapping sub-chains (chain_shards) ->
    planar BGR uint8 (n_data*k, 3, H, W) on the mesh's first device, for
    the n*k consecutive pairs of the underlying chain, in order.  Equal to
    calc_flow_bgr_chain_batched on the flat chain (per-pair compute is
    batch-independent and the colorize normalization is per-image)."""
    parts = [bgr for bgr, _ in _bgr_chain_shards(mesh, frames_nk, config)]
    return _gather(parts, _first(mesh))
