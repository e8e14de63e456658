"""The distribution layer: the device mesh, its placements and the
data-parallel collectives on ``torch.distributed`` (the port of
``scvae_tpu/parallel``; the model axis is not ported)."""

from scvae_tpu_torch.parallel.mesh import (
    Mesh,
    RowShard,
    ShardedBatch,
    batch_sharding,
    collective_counts,
    create_mesh,
    distributed_initialize,
    param_shardings,
    replicate_to_mesh,
    replicated,
    reset_collective_counts,
    resolve_mesh,
    shard_batch,
    shard_train_state,
)

__all__ = [
    "Mesh",
    "RowShard",
    "ShardedBatch",
    "batch_sharding",
    "collective_counts",
    "create_mesh",
    "distributed_initialize",
    "param_shardings",
    "replicate_to_mesh",
    "replicated",
    "reset_collective_counts",
    "resolve_mesh",
    "shard_batch",
    "shard_train_state",
]
