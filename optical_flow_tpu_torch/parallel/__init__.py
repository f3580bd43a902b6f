from optical_flow_tpu_torch.parallel.corpus import shard_videoids

__all__ = ["shard_videoids"]
