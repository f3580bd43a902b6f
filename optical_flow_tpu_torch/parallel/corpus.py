"""Corpus sharding across workers and hosts: `shard_videoids`, a copy of
`optical_flow_tpu.parallel.corpus.shard_videoids`, and
`maybe_init_distributed`, which reads the same environment as the JAX
module's.

Deterministic round-robin assignment of videoids to workers; the `.done`
sentinels keep reruns idempotent, so any worker can crash and be
restarted.  The split is embarrassingly parallel at video granularity, so
a process needs only its index and the process count: no
`torch.distributed` group and no collectives.  Recipe (one line per
process):

    OFT_COORDINATOR_ADDRESS=host0:9801 OFT_NUM_PROCESSES=4 \
    OFT_PROCESS_ID=<k> python -m optical_flow_tpu_torch.cli.optical_flow \
        /data vid0 vid1 ...   # each process takes videoids[k::4]
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple


def maybe_init_distributed() -> Tuple[int, int]:
    """(process_id, num_processes) from OFT_PROCESS_ID and
    OFT_NUM_PROCESSES when OFT_COORDINATOR_ADDRESS is set, as the JAX
    module reads them; (0, 1) when it is not.  The address is the JAX
    runtime's coordinator; nothing here connects to it."""
    if not os.environ.get("OFT_COORDINATOR_ADDRESS"):
        return 0, 1
    num = int(os.environ["OFT_NUM_PROCESSES"])
    pid = int(os.environ["OFT_PROCESS_ID"])
    return pid, num


def shard_videoids(videoids: Sequence[str], worker_index: int,
                   n_workers: int) -> list:
    """Deterministic round-robin shard of the corpus for one worker."""
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    if not (0 <= worker_index < n_workers):
        raise ValueError(f"worker_index {worker_index} not in [0, {n_workers})")
    return list(videoids[worker_index::n_workers])
