"""The training loop (the ported part of ``scvae_tpu/models/training.py``).

``run_training_loop`` runs epochs synchronously: KL warm-up weight, one
epoch through the runner, NaN abort, the per-epoch training ``lower_bound``
(a full evaluation pass when an evaluator is given), an optional callback.
Checkpoints, learning-curve files, early stopping, resume and the deferred
metric fetch are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from scvae_tpu_torch.models.objectives import warm_up_weight
from scvae_tpu_torch.models.step import TrainState, epoch_permutation, tree_finite

EpochRunner = Callable[[TrainState, int, float, torch.Generator], tuple[TrainState, dict]]
Evaluator = Callable[[TrainState, torch.Generator], dict[str, Any]]


@dataclasses.dataclass
class TrainingResult:
    train_state: TrainState
    number_of_epochs_trained: int
    history: dict[str, dict[str, list[float]]]
    # wall seconds of each epoch's training pass (evaluation excluded),
    # ending with the host fetch of the epoch's metrics
    epoch_seconds: list[float]
    steps_per_epoch: int


def device_epoch_runner(train_epoch: Callable, data: dict[str, torch.Tensor],
                        n_examples: int, batch_size: int,
                        seed: int) -> EpochRunner:
    """Runner for device-resident data: the epoch's shuffled (n_batches, B)
    permutation is made on the host from ``seed + epoch`` (as in the JAX
    package) and copied to the device once."""
    device = next(iter(data.values())).device

    def run_epoch(train_state, epoch, wuw, generator):
        perm = epoch_permutation(
            n_examples, batch_size, np.random.RandomState(seed + epoch)
        )
        perm = torch.from_numpy(perm).to(device)
        train_state, metrics = train_epoch(
            train_state, data, perm, generator, wuw
        )
        return train_state, {"lower_bound": float(metrics["lower_bound"])}

    return run_epoch


def run_training_loop(
    *,
    train_state: TrainState,
    run_epoch: EpochRunner,
    evaluate_training: Evaluator | None,
    number_of_epochs: int,
    generator: torch.Generator,
    steps_per_epoch: int,
    number_of_warm_up_epochs: int = 0,
    verbose: bool = True,
    epoch_callback: Callable[[int, TrainState, dict], None] | None = None,
) -> TrainingResult:
    history: dict[str, dict[str, list[float]]] = {}
    epoch_seconds: list[float] = []
    for epoch in range(number_of_epochs):
        wuw = warm_up_weight(epoch, number_of_warm_up_epochs)
        start = time.perf_counter()
        train_state, train_metrics = run_epoch(train_state, epoch, wuw, generator)
        epoch_seconds.append(time.perf_counter() - start)
        if not np.isfinite(train_metrics["lower_bound"]):
            raise ArithmeticError(
                f"The lower bound became NaN/inf at epoch {epoch + 1}."
            )
        epoch_metrics = {
            "training": (
                evaluate_training(train_state, generator)
                if evaluate_training is not None else train_metrics
            )
        }
        if epoch_callback is not None:
            epoch_callback(epoch, train_state, epoch_metrics)
        for kind, metrics in epoch_metrics.items():
            kind_history = history.setdefault(kind, {})
            for name, value in metrics.items():
                if np.ndim(value) == 0:
                    kind_history.setdefault(name, []).append(float(value))
        if verbose:
            print(
                f"Epoch {epoch + 1}/{number_of_epochs} "
                f"({epoch_seconds[-1]:.3g} s)  ELBO(train): "
                f"{epoch_metrics['training']['lower_bound']:.6g}"
            )
    if not tree_finite(train_state.params):
        raise ArithmeticError("Model parameters became non-finite.")
    return TrainingResult(
        train_state=train_state,
        number_of_epochs_trained=number_of_epochs,
        history=history,
        epoch_seconds=epoch_seconds,
        steps_per_epoch=steps_per_epoch,
    )
