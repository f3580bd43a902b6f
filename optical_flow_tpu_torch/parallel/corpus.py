"""Corpus sharding across workers: `shard_videoids`, a copy of
`optical_flow_tpu.parallel.corpus.shard_videoids`.

Deterministic round-robin assignment of videoids to workers; the `.done`
sentinels keep reruns idempotent, so any worker can crash and be
restarted.  The JAX module's `maybe_init_distributed` starts
`jax.distributed`; a multi-GPU counterpart belongs with the port's data
parallel path and is not here.
"""

from __future__ import annotations

from typing import Sequence


def shard_videoids(videoids: Sequence[str], worker_index: int,
                   n_workers: int) -> list:
    """Deterministic round-robin shard of the corpus for one worker."""
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    if not (0 <= worker_index < n_workers):
        raise ValueError(f"worker_index {worker_index} not in [0, {n_workers})")
    return list(videoids[worker_index::n_workers])
