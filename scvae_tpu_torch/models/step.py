"""Training steps, the optimiser and the train state.

Counterpart of ``scvae_tpu/models/step.py``.  The optimiser is the
reference's: element-wise gradient clipping to [−1, 1], then Adam with the
optax defaults (b1 0.9, b2 0.999, eps 1e-8).  PyTorch runs eagerly, so a
step is a plain function and an epoch a Python loop over the rows of a
(n_batches, B) index array; parameters and optimiser moments are updated in
place under ``no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from scvae_tpu_torch import ops

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


@dataclasses.dataclass
class TrainState:
    params: Any
    model_state: Any  # batch-norm running statistics
    opt_state: dict[str, Any]
    step: int = 0


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(optax.clip(1.0), optax.adam(learning_rate))``."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = 1.0

    def init(self, params: Any) -> dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

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
        opt_state["count"] += 1
        count = opt_state["count"]
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
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


def make_train_step(loss_fn: LossFn, optimizer: ClipAdam):
    """``train_step(ts, batch, generator, warm_up_weight) → (ts, metrics)``.

    ``loss_fn(params, model_state, batch, generator, warm_up_weight)`` returns
    ``(loss, (metrics, new_model_state))``.  Metrics stay on the device."""

    def train_step(ts: TrainState, batch, generator, warm_up_weight):
        leaves = tree_leaves(ts.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, (metrics, new_model_state) = loss_fn(
            ts.params, ts.model_state, cast_batch_to_f32(batch), generator,
            warm_up_weight,
        )
        grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        optimizer.update_(ts.params, list(grads), ts.opt_state)
        ts.model_state = new_model_state
        ts.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return ts, metrics

    return train_step


def make_train_epoch(loss_fn: LossFn, optimizer: ClipAdam, *,
                     batch_dtypes: dict[str, torch.dtype] | None = None):
    """``train_epoch(ts, data, perm, generator, warm_up_weight) → (ts,
    metrics)`` over device-resident ``data`` and an (n_batches, B) int32
    index tensor ``perm`` on the same device.  Metrics are device scalars;
    the caller decides when to fetch them."""
    train_step = make_train_step(loss_fn, optimizer)

    def train_epoch(ts: TrainState, data, perm, generator, warm_up_weight):
        bounds, losses = [], []
        for idx in perm:
            batch = gather_batch(data, idx, dtype_overrides=batch_dtypes)
            ts, metrics = train_step(ts, batch, generator, warm_up_weight)
            bounds.append(metrics["lower_bound"])
            losses.append(metrics["loss"])
        bounds = torch.stack(bounds)
        return ts, {
            "lower_bound": torch.mean(bounds),
            "loss": torch.mean(torch.stack(losses)),
            "last_lower_bound": bounds[-1],
        }

    return train_epoch


# Metrics collected by full-pass evaluators.
EVAL_METRIC_KEYS = (
    "lower_bound",
    "reconstruction_error",
    "kl_divergence",
    "kl_divergence_neurons",
)


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
