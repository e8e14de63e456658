"""The device mesh and the data-parallel collectives on ``torch.distributed``
(the port of ``scvae_tpu/parallel/mesh.py``).

The mesh has JAX's two axes, ``data`` (cells) and ``model`` (genes).  The
port runs the data axis; a ``model`` axis above 1 (the gene split of the
reconstruction heads) raises ``NotImplementedError``.  PyTorch runs one
process a device, so a mesh is the world of processes: rank r runs on
``cuda:LOCAL_RANK`` (NCCL) or on the CPU (gloo), and a mesh of N devices
needs a world of N processes (``torchrun --nproc-per-node N``).

Under GSPMD, JAX's data-parallel step computes what the unsharded step
computes; the port does explicitly what the JAX compiler inserts.  Every
rank holds the whole train state, and each global batch of B rows is cut
into R contiguous blocks of B/R rows, block r on rank r (a
:class:`RowShard`).  Then:

* batch-norm statistics are the global batch's: each rank's mean is
  averaged over the ranks by a differentiable all-reduce, then the mean
  square deviation from that global mean (``models.networks``);
* every random draw of a step is drawn at the global batch's shape from
  the one generator every rank seeds alike and cut to the rank's rows
  (:meth:`RowShard.normal`, :meth:`RowShard.uniform`);
* each rank's loss is the mean over its rows, the gradients and the
  step's metrics are averaged over the ranks in one all-reduce before the
  clip and Adam (``models.step``).

All-reduces average (``ReduceOp.AVG``): ranks hold equal blocks, so the
average of their means is the global mean.  Each collective that a
wrapper here issues adds one to its count (:func:`collective_counts`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

COLLECTIVES = {"all_reduce": 0}


def collective_counts() -> dict[str, int]:
    """Collectives issued since the last :func:`reset_collective_counts`
    (a CUDA graph's replay adds what its capture recorded)."""
    return dict(COLLECTIVES)


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def add_collective_counts(counts: dict[str, int], times: int = 1) -> None:
    for name in COLLECTIVES.keys() & counts.keys():
        COLLECTIVES[name] += times * counts[name]


def all_reduce_mean(tensor: torch.Tensor) -> torch.Tensor:
    """Average ``tensor`` over the ranks in place."""
    dist.all_reduce(tensor, op=dist.ReduceOp.AVG)
    COLLECTIVES["all_reduce"] += 1
    return tensor


class _Mean(torch.autograd.Function):
    """The average over the ranks, differentiable: its adjoint is the
    average of the gradients."""

    @staticmethod
    def forward(ctx, tensor):
        return all_reduce_mean(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean(grad.contiguous().clone())


def average(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors averaged over the ranks through one flat all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_mean(flat)
    pieces = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(pieces, tensors)]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[offset, offset + rows)`` of a global batch of
    ``total`` rows, cut over the ranks.  Draws and activations hold the
    batch's rows on their axis −2."""

    offset: int
    rows: int
    total: int

    def block(self, tensor: torch.Tensor, axis: int = -2) -> torch.Tensor:
        """The rank's rows of a tensor of the global batch."""
        if tensor.shape[axis] != self.total:
            raise ValueError(f"{tuple(tensor.shape)} has not the {self.total}"
                             f" rows of the global batch on axis {axis}")
        return tensor.narrow(axis, self.offset, self.rows)

    def _global_shape(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        if shape[-2] != self.rows:
            raise ValueError(f"{shape} has not the rank's {self.rows} rows "
                             "on axis -2")
        return shape[:-2] + (self.total,) + shape[-1:]

    def normal(self, shape, generator: torch.Generator | None,
               like: torch.Tensor,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """The rank's block of the standard-normal draws of the global
        batch: ``noise`` when given (at the global shape), else drawn."""
        if noise is None:
            noise = torch.randn(self._global_shape(shape),
                                generator=generator, dtype=like.dtype,
                                device=like.device)
        return self.block(noise)

    def uniform(self, shape, generator: torch.Generator | None,
                device: torch.device) -> torch.Tensor:
        """The rank's block of uniform [0, 1) draws of the global batch."""
        return self.block(torch.rand(self._global_shape(shape),
                                     generator=generator, device=device))

    def mean(self, tensor: torch.Tensor) -> torch.Tensor:
        """The average over the ranks (differentiable)."""
        return _Mean.apply(tensor)


class ShardedBatch(dict):
    """A batch dictionary that holds this rank's block (``shard``) of a
    global batch; a plain dictionary is a whole batch, the same on every
    rank (replicated)."""

    def __init__(self, fields: dict[str, Any], shard: RowShard):
        super().__init__(fields)
        self.shard = shard


def batch_rows(batch: dict[str, Any]) -> int:
    """The rows of the global batch that ``batch`` holds or is part of."""
    if isinstance(batch, ShardedBatch):
        return batch.shard.total
    return int(batch["t"].shape[0])


class Mesh:
    """A ``(data, model)`` mesh over the world's ranks, one device a process.
    ``shape`` maps each axis to its size, as JAX's ``Mesh.shape`` does;
    ``device`` is this process's device."""

    axis_names = ("data", "model")

    def __init__(self, ranks, model_parallelism: int, device: torch.device):
        self.ranks = tuple(ranks)
        self.shape = {"data": len(self.ranks) // model_parallelism,
                      "model": model_parallelism}
        self.device = torch.device(device)

    @property
    def rank(self) -> int:
        """This process's position on the data axis."""
        return dist.get_rank()

    def rows(self, total: int) -> RowShard:
        """This rank's block of a global batch of ``total`` rows, which the
        data axis must divide."""
        n = self.shape["data"]
        if total % n:
            raise ValueError(f"{total} rows are not divisible over {n} ranks")
        rows = total // n
        return RowShard(self.rank * rows, rows, total)

    def gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of a (rows, …) tensor, concatenated in rank
        order."""
        parts = [torch.empty_like(tensor) for _ in range(self.shape["data"])]
        dist.all_gather(parts, tensor.contiguous())
        return torch.cat(parts)

    def gather_picked(self, tensor: torch.Tensor, picked: torch.Tensor,
                      shard: RowShard) -> torch.Tensor:
        """The rows ``picked`` (sorted positions in the global batch) of a
        (rows, …) tensor that holds the rank's block ``shard``, on every
        rank: each rank sends its picked rows, padded to the most that a
        rank holds."""
        block = torch.div(picked, shard.rows, rounding_mode="floor")
        counts = torch.bincount(block, minlength=self.shape["data"]).tolist()
        width = max(counts)
        mine = picked[block == self.rank] - shard.offset
        part = tensor.new_zeros((width,) + tuple(tensor.shape[1:]))
        part[:mine.numel()] = tensor.index_select(0, mine.to(tensor.device))
        kept = torch.cat([torch.arange(count) + r * width
                          for r, count in enumerate(counts)])
        return self.gather_rows(part).index_select(0, kept.to(tensor.device))

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def distributed_initialize(*, device: torch.device | str = "cuda",
                           **kwargs: Any) -> None:
    """``init_process_group`` for ranks on ``device``: NCCL on CUDA (each
    rank on ``cuda:LOCAL_RANK``), gloo on the CPU; no-op if a group exists.
    ``kwargs`` go to ``init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``store``); without them the group is read
    from torchrun's environment, or, outside torchrun, is a world of one
    on an in-memory store."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not {"init_method", "store"} & kwargs.keys():
        if "MASTER_ADDR" in os.environ:
            kwargs["init_method"] = "env://"
        else:
            kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
    if device.type == "cuda":
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        local = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(local)
        # NCCL's communicator made now, before any CUDA graph capture
        kwargs.setdefault("device_id", local)
    dist.init_process_group(backend, **kwargs)


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def check_model_axis(model_parallelism: int | None) -> None:
    """Raise ``NotImplementedError`` for a model axis above 1."""
    if (model_parallelism or 1) > 1:
        raise NotImplementedError(
            f"model parallelism {model_parallelism}: the gene split of the "
            "reconstruction heads over a model axis (ROADMAP A8.2) is not "
            "ported; the mesh takes the data axis only")


def create_mesh(devices=None, n_devices: int | None = None,
                model_parallelism: int = 1, *,
                device: torch.device | str = "cuda") -> Mesh:
    """A ``(data, model)`` mesh over the world's processes, each running on
    a device of type ``device``.  ``devices`` (ranks) or ``n_devices``, when
    given, must be the world's size; the process group is initialised
    (:func:`distributed_initialize`) if it is not yet."""
    world = _world_size()
    n = world
    if devices is not None:
        n = len(devices)
    if n_devices is not None:
        n = n_devices
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a world of {n} processes, one a "
            f"device; the world size is {world}: run the program under "
            f"`torchrun --nproc-per-node {n}`")
    if n % model_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by model parallelism "
                         f"{model_parallelism}")
    check_model_axis(model_parallelism)
    distributed_initialize(device=device)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", _local_rank(dist.get_rank()))
    return Mesh(range(world), model_parallelism, device)


def resolve_mesh(mesh: Mesh | None = None, devices=None,
                 number_of_devices: int | None = None,
                 model_parallelism: int | None = None, *,
                 device: torch.device | str = "cuda") -> Mesh | None:
    """The user-facing parallelism arguments as a mesh, or None (JAX's
    rules): ``mesh`` wins if given; otherwise a mesh is built when any of
    ``devices`` / ``number_of_devices`` / ``model_parallelism`` asks for
    one."""
    if mesh is not None:
        return mesh
    if devices is None and number_of_devices is None and (
            model_parallelism is None or model_parallelism == 1):
        return None
    return create_mesh(devices=devices, n_devices=number_of_devices,
                       model_parallelism=model_parallelism or 1,
                       device=device)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tensor lies on the mesh: whole on every rank (replicated), or
    its leading (row) axis cut over the data axis (``rows``)."""

    mesh: Mesh
    rows: bool = False


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading (cell) axis over the data axis."""
    return Placement(mesh, rows=True)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate_to_mesh(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` whole on this rank's device."""
    return _tree_map(lambda t: t.to(mesh.device), tree)


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """The placement of each parameter: with the model axis at 1, which
    the mesh requires, every leaf is replicated."""
    return _tree_map(lambda _: replicated(mesh), params)


def shard_train_state(train_state: Any, mesh: Mesh) -> Any:
    """The train state replicated on this rank's device (parameters, batch
    statistics and optimiser state: ``param_shardings`` replicates every
    parameter)."""
    from scvae_tpu_torch.models.step import TrainState

    return TrainState(
        params=replicate_to_mesh(train_state.params, mesh),
        model_state=replicate_to_mesh(train_state.model_state, mesh),
        opt_state=replicate_to_mesh(train_state.opt_state, mesh),
        step=train_state.step)


def shard_batch(batch: dict[str, Any], mesh: Mesh) -> ShardedBatch:
    """This rank's block of each field of a global batch, on its device."""
    shard = mesh.rows(batch_rows(batch))
    return ShardedBatch({k: shard.block(v, 0).to(mesh.device)
                         for k, v in batch.items()}, shard)
