"""Multi-GPU: process groups, batch sharding, replication and the
collectives of data-parallel training and frame-sharded renders."""

from slrsfs_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate"]
