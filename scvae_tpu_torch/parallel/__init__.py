"""The distribution layer: the device mesh, its placements and its
collectives on ``torch.distributed``, over the data axis and the model
(gene) axis (the port of ``scvae_tpu/parallel``)."""

from scvae_tpu_torch.parallel.mesh import (
    GeneSplit,
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
    unshard_train_state,
)

__all__ = [
    "GeneSplit",
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
    "unshard_train_state",
]
