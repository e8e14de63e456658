"""The device mesh and its collectives on ``torch.distributed`` (the port
of ``scvae_tpu/parallel/mesh.py``).

The mesh has JAX's two axes, ``data`` (cells) and ``model`` (genes).
PyTorch runs one process a device, so a mesh is the world of processes:
rank r runs on ``cuda:LOCAL_RANK`` (NCCL) or on the CPU (gloo), and a mesh
of N devices needs a world of N processes (``torchrun --nproc-per-node
N``).  With a model axis of M the ranks lie on JAX's grid, the devices
reshaped to (N / M, M): rank r is at data index r // M and model index
r % M.  The ranks of one data index form a *model group*, those of one
model index a *data group*; every rank makes every group, in one order.

Under GSPMD, JAX's step computes what the unsharded step computes; the
port does explicitly what the JAX compiler inserts.  Each global batch of
B rows is cut into N / M contiguous blocks of B·M/N rows, block d on the
ranks of data index d (a :class:`RowShard`: the ranks of a model group
hold the same rows).  Then:

* batch-norm statistics are the global batch's: each rank's mean is
  averaged over its data group by a differentiable all-reduce, then the
  mean square deviation from that global mean (``models.networks``);
* every random draw of a step is drawn at the global batch's shape from
  the one generator every rank seeds alike and cut to the rank's rows
  (:meth:`RowShard.normal`, :meth:`RowShard.uniform`);
* each rank's loss is the mean over its rows, the gradients and the
  step's metrics are averaged over the data group in one all-reduce
  before the clip and Adam (``models.step``).

With a model axis above 1 each rank holds its F/M-gene block of the
reconstruction heads, the categorised class heads and their Adam moments
(:func:`param_shardings`, :func:`shard_train_state`; JAX's rule: a leaf
whose path names ``reconstruction`` or ``categorised_logits`` and whose
whole last axis M divides); every other leaf is whole.  Whether a width is
cut is :meth:`GeneSplit.splits` of the whole width alone, wherever it is
asked: the placements, the kernels' wrappers (``ops.sharded``) and the
paths that gather the heads (``models.vae.whole_heads``).  The likelihood
kernels run on the block: the row sums and the decoder's gradient are
summed over the model group (:class:`GeneSplit`).  A path that needs the
whole heads gathers them (:meth:`GeneSplit.gather`), and
:func:`unshard_train_state` rebuilds the whole train state on every rank
(checkpoints, callbacks, the state ``train`` returns) by the placements
that cut it, since a block's width no longer tells whether it was cut.

The data axis averages (``ReduceOp.AVG``): ranks hold equal blocks, so the
average of their means is the global mean; the model axis sums.  Each
collective that a wrapper here issues adds one to its count
(:func:`collective_counts`): ``all_reduce`` over the data axis,
``all_reduce_sum`` over the model axis, ``all_gather`` over either.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch
import torch.distributed as dist

COLLECTIVES = {"all_reduce": 0, "all_reduce_sum": 0, "all_gather": 0}


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


def all_reduce_mean(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Average ``tensor`` over the ranks of ``group`` (None: the world) in
    place."""
    dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=group)
    COLLECTIVES["all_reduce"] += 1
    return tensor


def all_gather(tensor: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``tensor`` of ``group`` (None: the world) concatenated in
    rank order along ``dim``."""
    parts = [torch.empty_like(tensor)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim)


class _Mean(torch.autograd.Function):
    """The average over the ranks of a group, differentiable: its adjoint
    is the average of the gradients."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce_mean(tensor.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean(grad.contiguous().clone(), ctx.group), None


def average(tensors: list[torch.Tensor], group=None) -> list[torch.Tensor]:
    """The tensors averaged over the ranks of ``group`` (None: the world)
    through one flat all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_mean(flat, group)
    pieces = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(pieces, tensors)]


class _GatherGenes(torch.autograd.Function):
    """A gene block's whole tensor, gathered over the model group along
    the last axis; its adjoint keeps the rank's block of the gradient, since
    every rank of the group computes the same function of the whole
    tensor."""

    @staticmethod
    def forward(ctx, tensor, split):
        ctx.split = split
        ctx.width = tensor.shape[-1]
        return all_gather(tensor, split.group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        width = ctx.width
        return grad.narrow(-1, ctx.split.index * width, width).contiguous(), None


@dataclasses.dataclass(frozen=True)
class GeneSplit:
    """The gene axis cut into ``size`` equal blocks, of which this rank
    holds block ``index``; ``group`` is the model group, whose ranks hold
    the other blocks (None: no collective, the caller combines the
    blocks).  Only a width that ``size`` divides is cut (JAX's
    ``_can_split_model``); other heads stay whole on every rank."""

    index: int
    size: int
    group: Any = None

    def splits(self, features: int) -> bool:
        return self.size > 1 and features % self.size == 0

    def block(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last axis of a whole tensor (a view)."""
        width = tensor.shape[-1] // self.size
        return tensor.narrow(-1, self.index * width, width)

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the model group in place."""
        if self.group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
            COLLECTIVES["all_reduce_sum"] += 1
        return tensor

    def gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """The whole tensor of this rank's block (differentiable)."""
        return _GatherGenes.apply(tensor, self)

    def whole(self, head: dict[str, torch.Tensor],
              width: int) -> dict[str, torch.Tensor]:
        """A head ({"kernel", "bias"}) of whole width ``width``, gathered
        where it is cut."""
        if not self.splits(width):
            return head
        return {name: self.gather(leaf) for name, leaf in head.items()}


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[offset, offset + rows)`` of a global batch of
    ``total`` rows, cut over the ranks.  Draws and activations hold the
    batch's rows on their axis −2."""

    offset: int
    rows: int
    total: int
    group: Any = None  # the data group (None: the world)

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
        """The average over the data group (differentiable)."""
        return _Mean.apply(tensor, self.group)

    def average(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The tensors averaged over the data group (one all-reduce)."""
        return average(tensors, self.group)


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
    ``device`` is this process's device; ``data_index`` and
    ``model_index`` its place on the grid; ``data_group`` and
    ``model_group`` its groups along each axis (the data group None, the
    world, when the model axis is 1; the model group None then);
    ``genes`` is this rank's :class:`GeneSplit` with a model axis above
    1, else None."""

    axis_names = ("data", "model")

    def __init__(self, ranks, model_parallelism: int, device: torch.device,
                 rank: int = 0, data_group=None, model_group=None):
        self.ranks = tuple(ranks)
        self.shape = {"data": len(self.ranks) // model_parallelism,
                      "model": model_parallelism}
        self.device = torch.device(device)
        self.data_index, self.model_index = divmod(rank, model_parallelism)
        self.data_group, self.model_group = data_group, model_group
        self.genes = (GeneSplit(self.model_index, model_parallelism,
                                model_group)
                      if model_parallelism > 1 else None)

    def rows(self, total: int) -> RowShard:
        """This rank's block of a global batch of ``total`` rows, which the
        data axis must divide."""
        n = self.shape["data"]
        if total % n:
            raise ValueError(f"{total} rows are not divisible over {n} ranks")
        rows = total // n
        return RowShard(self.data_index * rows, rows, total, self.data_group)

    def gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """The data group's blocks of a (rows, …) tensor, concatenated in
        order along the data axis."""
        return all_gather(tensor, self.data_group)

    def gather_picked(self, tensor: torch.Tensor, picked: torch.Tensor,
                      shard: RowShard) -> torch.Tensor:
        """The rows ``picked`` (sorted positions in the global batch) of a
        (rows, …) tensor that holds the rank's block ``shard``, on every
        rank: each rank sends its picked rows, padded to the most that a
        rank holds."""
        block = torch.div(picked, shard.rows, rounding_mode="floor")
        counts = torch.bincount(block, minlength=self.shape["data"]).tolist()
        width = max(counts)
        mine = picked[block == self.data_index] - shard.offset
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


# (the world's default group, world size, model axis) → every rank's
# (data group, model group): each rank makes every group of the grid once.
# The key holds the default group itself, not its id: a world made after
# ``destroy_process_group`` is another object and makes its own groups.
_GROUPS: dict[tuple, tuple] = {}


def _grid_groups(world: int, model_parallelism: int) -> tuple:
    """This rank's (data group, model group) of the (world / M, M) grid:
    every rank makes every group, data groups first, in one order, as
    ``dist.new_group`` requires."""
    default = dist.group.WORLD
    for stale in [key for key in _GROUPS if key[0] is not default]:
        del _GROUPS[stale]  # groups of a destroyed world
    key = (default, world, model_parallelism)
    if key not in _GROUPS:
        m, rank = model_parallelism, dist.get_rank()
        data_index, model_index = divmod(rank, m)
        data_groups = [dist.new_group(list(range(j, world, m)))
                       for j in range(m)]
        model_groups = [dist.new_group(list(range(i * m, (i + 1) * m)))
                        for i in range(world // m)]
        _GROUPS[key] = (data_groups[model_index], model_groups[data_index])
    return _GROUPS[key]


def create_mesh(devices=None, n_devices: int | None = None,
                model_parallelism: int = 1, *,
                device: torch.device | str = "cuda") -> Mesh:
    """A ``(data, model)`` mesh over the world's processes, each running on
    a device of type ``device``.  ``devices`` (ranks) or ``n_devices``, when
    given, must be the world's size, which ``model_parallelism`` must
    divide; the process group is initialised
    (:func:`distributed_initialize`) if it is not yet, and with a model
    axis above 1 the grid's groups are made (every rank must call this
    alike)."""
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
        raise ValueError(
            f"{n} devices not divisible by model parallelism "
            f"{model_parallelism}: a model axis of {model_parallelism} needs "
            "a world of a multiple of as many processes: run the program "
            f"under `torchrun --nproc-per-node {model_parallelism}`")
    distributed_initialize(device=device)
    rank = dist.get_rank()
    groups = ((None, None) if model_parallelism == 1
              else _grid_groups(world, model_parallelism))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", _local_rank(rank))
    return Mesh(range(world), model_parallelism, device, rank, *groups)


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
    """How a tensor lies on the mesh: whole on every rank (replicated), its
    leading (row) axis cut over the data axis (``rows``), or its last (gene)
    axis cut over the model axis (``genes``)."""

    mesh: Mesh
    rows: bool = False
    genes: bool = False


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading (cell) axis over the data axis, replicated over model."""
    return Placement(mesh, rows=True)


def _tree_map(fn: Callable[..., Any], tree: Any, *others: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``others`` (trees of its structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def _is_gene_axis_param(path: tuple) -> bool:
    names = "".join(f"[{key!r}]" for key in path)
    return "reconstruction" in names or "categorised_logits" in names


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """The placement of each parameter of the whole ``params`` (JAX's
    rule): the reconstruction and categorised class heads' kernels and
    biases cut on their last (gene) axis over ``model`` where the mesh's
    gene split cuts that width (:meth:`GeneSplit.splits`); everything else
    replicated.  A block's width does not say whether it was cut, so the
    placements of a cut state are those of the whole one it came from."""
    genes = mesh.genes

    def rule(path, leaf):
        if (genes is not None and _is_gene_axis_param(path)
                and leaf.dim() >= 1 and genes.splits(leaf.shape[-1])):
            return Placement(mesh, genes=True)
        return replicated(mesh)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return rule(path, tree)

    return walk(params, ())


def replicate_to_mesh(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` whole on this rank's device."""
    return _tree_map(lambda t: t.to(mesh.device), tree)


def _like_params(fn, train_state, placements, mesh):
    """A train state whose parameters and Adam moments are ``fn(leaf,
    placement)`` by ``placements``, everything else on the rank's
    device."""
    from scvae_tpu_torch.models.step import TrainState

    place = lambda tree: _tree_map(fn, tree, placements)  # noqa: E731
    opt_state = {key: (place(value) if key in ("mu", "nu")
                       else replicate_to_mesh(value, mesh))
                 for key, value in train_state.opt_state.items()}
    return TrainState(
        params=place(train_state.params),
        model_state=replicate_to_mesh(train_state.model_state, mesh),
        opt_state=opt_state, step=train_state.step)


def shard_train_state(train_state: Any, mesh: Mesh) -> Any:
    """The whole train state placed on the mesh: on this rank's device, and
    each leaf that ``param_shardings`` cuts on the gene axis (the heads and
    their Adam moments) as this rank's block, a tensor of its own."""

    def place(leaf, placement):
        leaf = leaf.to(mesh.device)
        if placement.genes:
            return mesh.genes.block(leaf).clone(
                memory_format=torch.contiguous_format)
        return leaf

    return _like_params(place, train_state,
                        param_shardings(train_state.params, mesh), mesh)


def _cut(placements: Any) -> list[Placement]:
    """The placements of a tree (or None) that cut a gene axis."""
    if isinstance(placements, dict):
        placements = list(placements.values())
    if isinstance(placements, (list, tuple)):
        return [p for tree in placements for p in _cut(tree)]
    return [placements] if placements is not None and placements.genes else []


def unshard_train_state(train_state: Any, placements: Any) -> Any:
    """The inverse of :func:`shard_train_state`: the whole train state on
    every rank, the cut leaves gathered over the model group (every rank
    must call it).  ``placements`` are ``param_shardings`` of the whole
    parameters that the state was cut from; where they cut nothing (or are
    None) the state as it is."""
    cut = _cut(placements)
    if not cut:
        return train_state
    mesh = cut[0].mesh

    def whole(leaf, placement):
        if placement.genes:
            return all_gather(leaf, mesh.model_group, dim=-1)
        return leaf

    return _like_params(whole, train_state, placements, mesh)


def shard_batch(batch: dict[str, Any], mesh: Mesh) -> ShardedBatch:
    """This rank's block of each field of a global batch, on its device."""
    shard = mesh.rows(batch_rows(batch))
    return ShardedBatch({k: shard.block(v, 0).to(mesh.device)
                         for k, v in batch.items()}, shard)
