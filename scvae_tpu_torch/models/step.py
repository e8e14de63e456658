"""Training steps, the optimiser, the train state, and whole epochs.

Counterpart of ``scvae_tpu/models/step.py``.  The optimiser is the
reference's: element-wise gradient clipping to [−1, 1], then Adam with the
optax defaults (b1 0.9, b2 0.999, eps 1e-8).  Parameters, batch-norm
statistics and the optimiser's moments and count are updated in place
under ``no_grad``, so a train state keeps its tensors for its whole life.

An epoch is the counterpart of JAX's ``lax.scan`` over the rows of an
(n_batches, B) index array (``make_train_epoch``, ``make_eval_epoch``).  On
the CPU it is a Python loop of eager steps.  On a CUDA device the first step
of the object's life runs eagerly: it builds the kernels and fixes every
allocation's shape.  The next one is captured once in a CUDA graph, and it
and every later step are replays of that graph: one launch a step instead
of hundreds of operations dispatched from Python.  A replay reads fixed
buffers: the data, the epoch's index rows (copied into a static buffer once
per epoch), the train state, the warm-up weight and a 0-d step index that
the graph itself advances, and writes each step's metrics at that index.

Data streamed from the host (``data.pipeline.BatchPipeline``) trains one
batch per call of :class:`TrainStep` (JAX ``make_train_step``) and is
evaluated by :class:`EvalStep`: the CSR wire is densified on the device
(:func:`materialize_batch`), and on CUDA each batch signature has a graph
of its own, whose fixed inputs every batch is copied into before the
replay.

Data parallel (``parallel.Mesh``): the epochs take a ``mesh``, and each
rank gathers its block of each global row of indices; a streamed batch
that holds a rank's block (``parallel.ShardedBatch``) carries its
``RowShard``.  The loss then reads the global batch's statistics and
draws, and the step averages the gradients and its metrics over the
rank's data group in one all-reduce before the clip and Adam, inside the
captured graph on CUDA.  A whole batch (a streamed remainder that the
ranks do not divide) runs replicated: every rank computes it alike, with
no data-axis collective.  Under a model axis the loss function holds the
gene split (the API binds it): its model-axis all-reduces run inside the
step too, and the clip, element-wise, needs no norm across the blocks.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable

import numpy as np
import torch

from scvae_tpu_torch import ops
from scvae_tpu_torch.data.pipeline import CSRWire
from scvae_tpu_torch.parallel import mesh as parallel
from scvae_tpu_torch.utils import tracing

LossFn = Callable[..., tuple[torch.Tensor, tuple[dict[str, torch.Tensor], Any]]]


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """Tensors of a nested dict/list tree in a fixed order (dict keys in
    insertion order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in tree_leaves(item)]


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return [tree_map(fn, v) for v in tree]


def matching_leaves(tree: Any, like: Any) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the order of ``like``'s leaves, found by
    the keys and positions of ``like`` (``tree`` may hold more)."""
    if isinstance(like, torch.Tensor):
        return [tree]
    if isinstance(like, dict):
        return [leaf for key, value in like.items()
                for leaf in matching_leaves(tree[key], value)]
    return [leaf for i, value in enumerate(like)
            for leaf in matching_leaves(tree[i], value)]


@dataclasses.dataclass
class TrainState:
    params: Any
    model_state: Any  # batch-norm running statistics
    opt_state: dict[str, Any]
    step: int = 0


def snapshot_state(ts: TrainState) -> TrainState:
    """A copy of ``ts`` whose tensors are device-to-device clones (the
    optimiser's count too), for reading one epoch's state while the next
    epoch updates ``ts`` in place."""
    copy = lambda tree: tree_map(lambda t: t.detach().clone(), tree)  # noqa: E731
    return TrainState(params=copy(ts.params),
                      model_state=copy(ts.model_state),
                      opt_state=copy(ts.opt_state), step=ts.step)


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(optax.clip(1.0), optax.adam(learning_rate))``.  The
    step count is a 0-d int32 tensor on the parameters' device and the
    bias corrections ``1 − b**count`` are computed there in float32, as
    optax computes them, so a captured step reads the count of the step it
    replays."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = 1.0

    def init(self, params: Any) -> dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update_(self, params: Any, grads: list[torch.Tensor],
                opt_state: dict[str, Any]) -> None:
        """Apply one clipped Adam step to ``params`` in place."""
        p = tree_leaves(params)
        mu = tree_leaves(opt_state["mu"])
        nu = tree_leaves(opt_state["nu"])
        g = torch._foreach_clamp_max(
            torch._foreach_clamp_min(grads, -self.clip), self.clip
        )
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = opt_state["count"]
        count.add_(1)
        exponent = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, exponent))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, exponent))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(p, mu_hat, alpha=-self.learning_rate)


def make_optimizer(learning_rate: float) -> ClipAdam:
    return ClipAdam(learning_rate)


def create_train_state(params: Any, model_state: Any,
                       optimizer: ClipAdam) -> TrainState:
    return TrainState(params=params, model_state=model_state,
                      opt_state=optimizer.init(params))


def gather_batch(data: dict[str, torch.Tensor], idx: torch.Tensor,
                 dtype_overrides: dict[str, torch.dtype] | None = None):
    """One batch of rows from device-resident data.

    2-D fields (the count matrix, and the (N, 1) float32 count sums of the
    constrained Poisson) go through the row-gather kernel (K1); fields that
    are the same tensor and ask for the same dtype (x and t alias one count
    matrix) share one gather.  ``dtype_overrides`` maps field → output
    dtype for 2-D fields (default float32); 1-D fields (the staged
    Σ lgamma(1+t) row constants) use ``index_select``."""
    overrides = dtype_overrides or {}
    gathered: dict[tuple[int, torch.dtype], torch.Tensor] = {}
    batch = {}
    for name, value in data.items():
        if value.dim() != 2:
            batch[name] = value.index_select(0, idx.long())
            continue
        dtype = overrides.get(name, torch.float32)
        key = (id(value), dtype)
        if key not in gathered:
            gathered[key] = ops.gather_rows(value, idx, dtype)
        batch[name] = gathered[key]
    return batch


def cast_batch_to_f32(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Promote integer fields (counts held narrow) to float32."""
    return {
        k: v.float() if not v.is_floating_point() else v
        for k, v in batch.items()
    }


def materialize_batch(batch: dict[str, Any]) -> dict[str, Any]:
    """Densify the :class:`~scvae_tpu_torch.data.pipeline.CSRWire` fields
    on their device: a scatter-add of the padded COO into zeros, float32
    (JAX ``materialize_batch``).  The scatter runs into (B + 1, F) and
    drops the last row, which takes the padding entries (``rows == B``),
    so no index is out of range; duplicate (row, column) entries add, as
    in JAX.  A wire that several fields share is densified once."""
    dense: dict[int, torch.Tensor] = {}
    out = {}
    for name, value in batch.items():
        if isinstance(value, CSRWire):
            if id(value) not in dense:
                flat = torch.zeros((value.n_rows + 1) * value.n_cols,
                                   dtype=torch.float32,
                                   device=value.data.device)
                index = value.rows.long() * value.n_cols + value.cols.long()
                flat.scatter_add_(0, index, value.data.float())
                dense[id(value)] = flat.view(value.n_rows + 1,
                                             value.n_cols)[:value.n_rows]
            out[name] = dense[id(value)]
        else:
            out[name] = value
    return out


def _apply_step(loss_fn: LossFn, optimizer: ClipAdam):
    """``apply(ts, batch, generator, warm_up_weight, shard=None) →
    metrics``: one training step on ``ts`` in place (parameters,
    batch-norm statistics, optimiser state), the host step count
    untouched.  With a ``shard`` the gradients and the metrics are
    averaged over its data group (one all-reduce) before the optimiser."""

    def apply(ts: TrainState, batch, generator, warm_up_weight, shard=None):
        leaves = tree_leaves(ts.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, (metrics, new_model_state) = loss_fn(
            ts.params, ts.model_state, cast_batch_to_f32(batch), generator,
            warm_up_weight, shard=shard,
        )
        grads = list(torch.autograd.grad(loss, leaves))
        for leaf in leaves:
            leaf.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if shard is not None:
            reduced = shard.average(grads + list(metrics.values()))
            grads = reduced[:len(grads)]
            metrics = dict(zip(metrics, reduced[len(grads):]))
        optimizer.update_(ts.params, grads, ts.opt_state)
        state = tree_leaves(ts.model_state)
        if state:
            with torch.no_grad():
                torch._foreach_copy_(
                    state, matching_leaves(new_model_state, ts.model_state))
        return metrics

    return apply


class _GraphedBody:
    """``body`` (a step that reads and writes only fixed tensors) run
    eagerly on the first call, captured in a CUDA graph on the second and
    replayed from then on.  ``generator``, the only generator the body
    draws from, is registered with the graph, so a replay draws what the
    body would draw eagerly from the generator's state at that moment.  The
    kernel launches and collectives counted while capturing were recorded,
    not run: they are taken off the counters and added once per replay.  A
    capture or replay that fails raises.  The eager call and the capture
    are the spans ``step.eager`` and ``step.capture`` (attribute ``kind``),
    and each capture adds one to the counter ``step.graph_captures``."""

    def __init__(self, body: Callable[[], None], generator: torch.Generator,
                 kind: str):
        self._body = body
        self._generator = generator
        self._kind = kind  # "train" or "eval": the spans' attribute
        self._warm = False
        self._graph: torch.cuda.CUDAGraph | None = None
        self._launches: dict[str, int] = {}

    def __call__(self) -> None:
        if not self._warm:
            with tracing.span("step.eager", kind=self._kind):
                self._body()
            self._warm = True
            return
        if self._graph is None:
            with tracing.span("step.capture", kind=self._kind):
                self._capture()
        self._graph.replay()
        _add_counts(self._launches)

    def _capture(self) -> None:
        tracing.count("step.graph_captures")
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._generator)
        before = _counts()
        # A graph destroyed during a capture invalidates the capture (CUDA
        # refuses cudaGraphDestroy then), and the graphs of earlier epochs
        # and ``train`` calls die with the reference cycles around them:
        # collect those first, and keep the collector off while capturing.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._body()
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        self._launches = {name: count - before.get(name, 0)
                          for name, count in after.items()
                          if count != before.get(name, 0)}
        _add_counts(self._launches, times=-1)
        self._graph = graph


def _counts() -> dict[str, int]:
    """The kernel launch and the collective counters (distinct names)."""
    return {**ops.launch_counts(), **parallel.collective_counts()}


def _add_counts(counts: dict[str, int], times: int = 1) -> None:
    ops.add_launch_counts(counts, times)
    parallel.add_collective_counts(counts, times)


def _bound_to(tensors: list[torch.Tensor], bound: list[torch.Tensor],
              what: str) -> None:
    """Raise unless ``tensors`` are the very tensors of ``bound``: a
    captured graph reads the buffers it was captured on."""
    if len(tensors) != len(bound) or any(
            a is not b for a, b in zip(tensors, bound)):
        raise ValueError(f"this epoch runs on the {what} it was first "
                         f"called with; build another for other {what}")


def _batch_parts(batch: dict[str, Any]) -> list[torch.Tensor]:
    """The batch's tensors in field order, each shared object once (a wire
    as its data, columns and rows)."""
    seen: set[int] = set()
    parts: list[torch.Tensor] = []
    for value in batch.values():
        if id(value) in seen:
            continue
        seen.add(id(value))
        parts.extend((value.data, value.cols, value.rows)
                     if isinstance(value, CSRWire) else (value,))
    return parts


def _signature(batch: dict[str, Any]) -> tuple:
    """What a captured graph fixes of a batch: each field's shapes and
    dtypes, and which fields share one object."""
    first: dict[int, str] = {}
    signature = []
    for name, value in batch.items():
        shared = first.setdefault(id(value), name)
        tensors = ((value.data, value.cols, value.rows)
                   if isinstance(value, CSRWire) else (value,))
        shape = (value.n_rows, value.n_cols) if isinstance(
            value, CSRWire) else None
        signature.append((name, shared, shape) + tuple(
            (tuple(t.shape), t.dtype) for t in tensors))
    return tuple(signature)


def _static_copy(batch: dict[str, Any]) -> dict[str, Any]:
    """A batch of the same structure on clones of its tensors."""
    made: dict[int, Any] = {}
    for value in batch.values():
        if id(value) not in made:
            made[id(value)] = (
                CSRWire(value.data.clone(), value.cols.clone(),
                        value.rows.clone(), value.n_rows, value.n_cols)
                if isinstance(value, CSRWire) else value.clone())
    return {name: made[id(value)] for name, value in batch.items()}


def _batch_device(batch: dict[str, Any]) -> torch.device:
    return _batch_parts(batch)[0].device


class _BatchGraphs:
    """``body(static_batch, generator, shard) → outputs`` run once per batch
    through a graph for the batch's signature (:func:`_signature`, and
    the ``RowShard`` of a ``parallel.ShardedBatch``): each
    signature gets fixed input tensors, which every batch of it is copied
    into on the current stream, a generator of its own and a
    :class:`_GraphedBody` (eager on the signature's first batch, captured
    on its second, replayed from then on).  Around each run the given
    generator's state is copied into the signature's generator and back,
    so the draws are those of one generator.  The outputs are the graph's
    own tensors: valid until the next run of the same signature."""

    def __init__(self, body: Callable[..., dict[str, torch.Tensor]],
                 kind: str):
        self._body = body
        self._kind = kind
        self._entries: dict[tuple, dict[str, Any]] = {}

    def __call__(self, batch: dict[str, Any],
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
        shard = getattr(batch, "shard", None)
        key = (_signature(batch), shard)
        entry = self._entries.get(key)
        if entry is None:
            device = _batch_device(batch)
            entry = {"static": _static_copy(batch), "outputs": {},
                     "generator": torch.Generator(device=device)}

            def run(entry=entry):
                entry["outputs"] = self._body(entry["static"],
                                              entry["generator"], shard)

            entry["run"] = _GraphedBody(run, entry["generator"],
                                        self._kind)
            self._entries[key] = entry
        else:
            torch._foreach_copy_(_batch_parts(entry["static"]),
                                 _batch_parts(batch))
        entry["generator"].set_state(generator.get_state())
        entry["run"]()
        generator.set_state(entry["generator"].get_state())
        return entry["outputs"]


class TrainStep:
    """``train_step(ts, batch, generator, warm_up_weight) → (ts, metrics)``
    on one batch that the caller hands over (JAX ``make_train_step``): the
    batch's wire fields densified on its device (:func:`materialize_batch`),
    one step on ``ts`` in place, ``ts.step`` advanced.  On the CPU, or with
    ``capture=False``, each step runs eagerly.  On CUDA each batch
    signature (a full batch of the CSR wire at the pipeline's capacity, a
    dense batch that overflowed it, a shorter last batch) is captured in a
    CUDA graph of its own (:class:`_BatchGraphs`): the batch is copied
    into the graph's fixed inputs, then the graph is replayed; the graphs
    read the train state they were captured on.  A batch that holds a
    rank's block of a global batch (``parallel.ShardedBatch``) trains as
    that block, with the gradients averaged over the ranks; any other
    batch as a whole.  The metrics stay on the device; on CUDA they are
    valid until the next step."""

    def __init__(self, loss_fn: LossFn, optimizer: ClipAdam, *,
                 capture: bool = True):
        self._apply = _apply_step(loss_fn, optimizer)
        self._capture = capture
        self._graphs: _BatchGraphs | None = None
        self._bound: list[torch.Tensor] | None = None

    def _graphed_body(self, static, generator, shard):
        return self._apply(self._ts, materialize_batch(static), generator,
                           self._warm_up_weight, shard)

    def __call__(self, ts: TrainState, batch, generator, warm_up_weight):
        device = _batch_device(batch)
        if not (self._capture and device.type == "cuda"):
            metrics = self._apply(ts, materialize_batch(batch), generator,
                                  warm_up_weight, getattr(batch, "shard",
                                                          None))
        else:
            leaves = tree_leaves(ts.params) + tree_leaves(ts.model_state)
            if self._graphs is None:
                self._ts, self._bound = ts, leaves
                self._warm_up_weight = torch.zeros((), device=device)
                self._graphs = _BatchGraphs(self._graphed_body, "train")
            _bound_to(leaves, self._bound, "train state")
            self._warm_up_weight.fill_(warm_up_weight)
            metrics = self._graphs(batch, generator)
        ts.step += 1
        return ts, metrics


def make_train_step(loss_fn: LossFn, optimizer: ClipAdam, *,
                    capture: bool = True) -> TrainStep:
    """The counterpart of JAX's ``make_train_step`` (``capture`` for its
    ``jit``); ``loss_fn(params, model_state, batch, generator,
    warm_up_weight)`` returns ``(loss, (metrics, new_model_state))``."""
    return TrainStep(loss_fn, optimizer, capture=capture)


class EvalStep:
    """``eval_step(params, model_state, batch, generator) → metrics`` of
    one batch without gradients (JAX ``make_eval_step``): wire fields
    densified on the device, integer fields promoted to float32, then
    ``eval_fn``.  On CUDA (unless ``capture=False``) each batch signature
    runs through a graph of its own, as in :class:`TrainStep`; the graphs
    read the step's own copies of the parameters and batch-norm state,
    which each call fills from the ones it is given.  A rank's block of a
    global batch (``parallel.ShardedBatch``) gives the global batch's
    metrics, averaged over the ranks.  On CUDA the metrics are valid until
    the next call."""

    def __init__(self, eval_fn: Callable[..., dict[str, torch.Tensor]], *,
                 capture: bool = True):
        self._eval_fn = eval_fn
        self._capture = capture
        self._graphs: _BatchGraphs | None = None

    def _evaluate(self, params, model_state, batch, generator, shard):
        metrics = self._eval_fn(params, model_state,
                                cast_batch_to_f32(materialize_batch(batch)),
                                generator, shard=shard)
        if shard is not None:
            metrics = dict(zip(metrics, shard.average(
                list(metrics.values()))))
        return metrics

    def _graphed_body(self, static, generator, shard):
        return self._evaluate(self._params, self._model_state, static,
                              generator, shard)

    @torch.no_grad()
    def __call__(self, params, model_state, batch, generator):
        if not (self._capture and _batch_device(batch).type == "cuda"):
            return self._evaluate(params, model_state, batch, generator,
                                  getattr(batch, "shard", None))
        if self._graphs is None:
            self._params = tree_map(torch.clone, params)
            self._model_state = tree_map(torch.clone, model_state)
            self._graphs = _BatchGraphs(self._graphed_body, "eval")
        for mine, given in ((self._params, params),
                            (self._model_state, model_state)):
            leaves = tree_leaves(mine)
            if leaves:
                torch._foreach_copy_(leaves, matching_leaves(given, mine))
        return self._graphs(batch, generator)


def make_eval_step(eval_fn: Callable[..., dict[str, torch.Tensor]], *,
                   capture: bool = True) -> EvalStep:
    """The counterpart of JAX's ``make_eval_step`` (``capture`` for its
    ``jit``)."""
    return EvalStep(eval_fn, capture=capture)


class TrainEpoch:
    """``train_epoch(ts, data, perm, generator, warm_up_weight) → (ts,
    metrics)`` over device-resident ``data`` and an (n_batches, B) int32
    index tensor ``perm`` on the same device (see the module docstring).
    ``ts`` is updated in place; ``ts.step`` is a host int, advanced once a
    step.  Metrics are device scalars (the mean and last minibatch lower
    bound, the mean loss); the caller decides when to fetch them.  An
    object serves one train state, one data set and one number of batches:
    on CUDA its graph reads their tensors.  The generator's state is copied
    into the graph's own generator before the epoch and back after it.
    With a ``mesh`` (``parallel.Mesh``) every rank holds the whole data and
    the same ``perm``, and trains on its block of each row of it."""

    def __init__(self, loss_fn: LossFn, optimizer: ClipAdam, *,
                 batch_dtypes: dict[str, torch.dtype] | None = None,
                 capture: bool = True, mesh=None):
        self._apply = _apply_step(loss_fn, optimizer)
        self._batch_dtypes = batch_dtypes
        self._capture = capture
        self._mesh = mesh
        self._bound: list[torch.Tensor] | None = None
        self._run: Callable[[], None] | None = None

    def _bind(self, ts: TrainState, data, perm: torch.Tensor) -> None:
        device = perm.device
        self._ts, self._data = ts, data
        self._shard = (None if self._mesh is None
                       else self._mesh.rows(perm.shape[1]))
        self._bound = (tree_leaves(ts.params) + tree_leaves(ts.model_state)
                       + tree_leaves(data))
        self._perm = torch.empty_like(perm)
        self._index = torch.zeros((), dtype=torch.int64, device=device)
        self._warm_up_weight = torch.zeros((), device=device)
        self._bounds = torch.zeros(perm.shape[0], device=device)
        self._losses = torch.zeros(perm.shape[0], device=device)
        self._generator = None
        if self._capture and device.type == "cuda":
            self._generator = torch.Generator(device=device)
            self._run = _GraphedBody(self._body, self._generator, "train")
        else:
            self._run = self._body

    def _body(self) -> None:
        row = self._perm.index_select(0, self._index).reshape(-1)
        if self._shard is not None:
            row = self._shard.block(row, 0)
        batch = gather_batch(self._data, row,
                             dtype_overrides=self._batch_dtypes)
        metrics = self._apply(self._ts, batch, self._draws,
                              self._warm_up_weight, self._shard)
        at = self._index.reshape(1)
        self._bounds.index_copy_(0, at, metrics["lower_bound"].reshape(1))
        self._losses.index_copy_(0, at, metrics["loss"].reshape(1))
        self._index.add_(1)

    def __call__(self, ts: TrainState, data, perm: torch.Tensor,
                 generator: torch.Generator, warm_up_weight: float):
        if self._bound is None:
            self._bind(ts, data, perm)
        _bound_to(tree_leaves(ts.params) + tree_leaves(ts.model_state)
                  + tree_leaves(data), self._bound, "train state and data")
        if perm.shape != self._perm.shape:
            raise ValueError(f"{tuple(perm.shape)} index rows, not the "
                             f"{tuple(self._perm.shape)} of the first epoch")
        self._ts = ts
        self._perm.copy_(perm)
        self._index.zero_()
        self._warm_up_weight.fill_(warm_up_weight)
        self._draws = generator
        if self._generator is not None:
            self._generator.set_state(generator.get_state())
            self._draws = self._generator
        for _ in range(perm.shape[0]):
            self._run()
            ts.step += 1
        if self._generator is not None:
            generator.set_state(self._generator.get_state())
        return ts, {
            "lower_bound": torch.mean(self._bounds),
            "loss": torch.mean(self._losses),
            "last_lower_bound": self._bounds[-1].clone(),
        }


def make_train_epoch(loss_fn: LossFn, optimizer: ClipAdam, *,
                     batch_dtypes: dict[str, torch.dtype] | None = None,
                     capture: bool = True, mesh=None) -> TrainEpoch:
    """The counterpart of JAX's ``make_train_epoch``; ``capture`` (JAX's
    ``jit``) runs the steps on CUDA as graph replays, and ``capture=False``
    eagerly (on the CPU every step runs eagerly); ``mesh`` (JAX's
    ``batch_constraint``) trains each rank on its block of every batch."""
    return TrainEpoch(loss_fn, optimizer, batch_dtypes=batch_dtypes,
                      capture=capture, mesh=mesh)


# Metrics collected by full-pass evaluators.
EVAL_METRIC_KEYS = (
    "lower_bound",
    "reconstruction_error",
    "kl_divergence",
    "kl_divergence_neurons",
)


class EvalEpoch:
    """``eval_epoch(params, model_state, data, idx, generator) → {key:
    mean}`` over the (n_batches, B) row indices ``idx`` of
    device-resident ``data``, without gradients: each batch's
    ``eval_fn(params, model_state, batch, generator)`` metrics
    ``scalar_keys`` summed on the device, then divided by the number of
    batches (the batches are equal-sized; the caller evaluates a remainder
    on its own, as JAX's host wrapper does).  On CUDA the batches are graph
    replays after one eager batch, as in :class:`TrainEpoch`; the graph
    reads its own copies of the parameters and batch-norm state, which
    each call fills from the ones it is given.  With a ``mesh`` each rank
    evaluates its block of every batch, and the sums are averaged over the
    ranks once, at the end of the call."""

    def __init__(self, eval_fn: Callable[..., dict[str, torch.Tensor]],
                 scalar_keys: tuple[str, ...] = EVAL_METRIC_KEYS, *,
                 capture: bool = True, mesh=None):
        self._eval_fn = eval_fn
        self._keys = scalar_keys
        self._capture = capture
        self._mesh = mesh
        self._bound: list[torch.Tensor] | None = None
        self._sums: list[torch.Tensor] | None = None

    def _bind(self, params, model_state, data, idx: torch.Tensor) -> None:
        device = idx.device
        self._data = data
        self._shard = (None if self._mesh is None
                       else self._mesh.rows(idx.shape[1]))
        self._bound = tree_leaves(data)
        self._idx = torch.empty_like(idx)
        self._index = torch.zeros((), dtype=torch.int64, device=device)
        self._generator = None
        self._run: Callable[[], None] = self._body
        if self._capture and device.type == "cuda":
            self._params = tree_map(torch.clone, params)
            self._model_state = tree_map(torch.clone, model_state)
            self._generator = torch.Generator(device=device)
            self._run = _GraphedBody(self._body, self._generator, "eval")

    def _body(self) -> None:
        row = self._idx.index_select(0, self._index).reshape(-1)
        if self._shard is not None:
            row = self._shard.block(row, 0)
        batch = cast_batch_to_f32(gather_batch(self._data, row))
        metrics = self._eval_fn(self._params, self._model_state, batch,
                                self._draws, shard=self._shard)
        values = [metrics[k] for k in self._keys]
        if self._sums is None:
            self._sums = [torch.zeros_like(v) for v in values]
        torch._foreach_add_(self._sums, values)
        self._index.add_(1)

    @torch.no_grad()
    def __call__(self, params, model_state, data, idx: torch.Tensor,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
        if self._bound is None:
            self._bind(params, model_state, data, idx)
        _bound_to(tree_leaves(data), self._bound, "data")
        if idx.shape != self._idx.shape:
            raise ValueError(f"{tuple(idx.shape)} index rows, not the "
                             f"{tuple(self._idx.shape)} of the first call")
        self._idx.copy_(idx)
        self._index.zero_()
        if self._sums is not None:
            torch._foreach_zero_(self._sums)
        self._draws = generator
        if self._generator is None:
            self._params, self._model_state = params, model_state
        else:
            for mine, given in ((self._params, params),
                                (self._model_state, model_state)):
                leaves = tree_leaves(mine)
                if leaves:
                    torch._foreach_copy_(leaves,
                                         matching_leaves(given, mine))
            self._generator.set_state(generator.get_state())
            self._draws = self._generator
        for _ in range(idx.shape[0]):
            self._run()
        if self._generator is not None:
            generator.set_state(self._generator.get_state())
        sums = self._sums
        if self._shard is not None:
            sums = self._shard.average(sums)
        return {k: s / idx.shape[0] for k, s in zip(self._keys, sums)}


def make_eval_epoch(eval_fn: Callable[..., dict[str, torch.Tensor]],
                    scalar_keys: tuple[str, ...] = EVAL_METRIC_KEYS, *,
                    capture: bool = True, mesh=None) -> EvalEpoch:
    """The counterpart of JAX's ``make_eval_epoch`` (``capture`` for its
    ``jit``, ``mesh`` for its ``batch_constraint``)."""
    return EvalEpoch(eval_fn, scalar_keys, capture=capture, mesh=mesh)


def sequential_batches(n: int, batch_size: int) -> np.ndarray:
    """(n_batches, B) sequential full batches; remainder rows excluded."""
    n_batches = n // batch_size
    return np.arange(n_batches * batch_size, dtype=np.int32).reshape(
        n_batches, batch_size
    )


def epoch_permutation(n: int, batch_size: int,
                      seed_rng: np.random.RandomState) -> np.ndarray:
    """Host-side shuffled (n_batches, B) index array, dropping the
    remainder — the same numpy calls as the JAX package, so one seed gives
    one minibatch order in both."""
    perm = seed_rng.permutation(n)
    n_batches = n // batch_size
    return np.asarray(
        perm[: n_batches * batch_size].reshape(n_batches, batch_size),
        np.int32,
    )


def tree_finite(tree: Any) -> bool:
    """True iff every tensor of the tree is finite (the NaN-abort check)."""
    return all(bool(torch.isfinite(leaf).all()) for leaf in tree_leaves(tree))
