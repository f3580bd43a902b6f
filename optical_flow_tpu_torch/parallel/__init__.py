from optical_flow_tpu_torch.parallel.mesh import (
    chain_shards,
    make_mesh,
    shard_pairs,
    sharded_bgr_chain_step,
    sharded_bgr_step,
    sharded_extract_step,
    sharded_flow_step,
)
from optical_flow_tpu_torch.parallel.corpus import shard_videoids
from optical_flow_tpu_torch.parallel.halo import HaloKernels, halo_extend

__all__ = [
    "HaloKernels",
    "halo_extend",
    "chain_shards",
    "make_mesh",
    "shard_pairs",
    "sharded_bgr_chain_step",
    "sharded_bgr_step",
    "sharded_extract_step",
    "sharded_flow_step",
    "shard_videoids",
]
