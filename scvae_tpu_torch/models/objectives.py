"""Objective helpers: stable log-mean-exp, the KL warm-up schedule and the
early-stopping state machine (counterparts in
``scvae_tpu/models/objectives.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch


def log_reduce_exp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """log(mean(exp(x), dim)) computed stably — the IW bound over the
    importance-sample axis."""
    x_max = torch.amax(x, dim=dim, keepdim=True).detach()
    out = torch.log(torch.mean(torch.exp(x - x_max), dim=dim, keepdim=True)) + x_max
    return torch.squeeze(out, dim=dim)


def warm_up_weight(epoch: int, number_of_warm_up_epochs: int) -> float:
    """Linear KL warm-up: ``min(epoch / W, 1)`` (0-indexed epoch)."""
    if number_of_warm_up_epochs:
        return float(min(epoch / number_of_warm_up_epochs, 1.0))
    return 1.0


@dataclasses.dataclass
class EarlyStopping:
    """Validation-ELBO early stopping with ``rounds`` degradation rounds:
    training stops after ``rounds`` consecutive epochs without improvement
    over the best validation lower bound seen so far; the snapshot to keep
    is that of the epoch before degradation began."""

    rounds: int = 10
    best: float = -math.inf
    epochs_without_improvement: int = 0
    stopped: bool = False
    best_epoch: int | None = None

    def update(self, metric: float, epoch: int) -> dict[str, bool]:
        """Returns {'improved': …, 'stop': …, 'start_degrading': …}."""
        improved = metric > self.best
        start_degrading = False
        if improved:
            self.best = metric
            self.best_epoch = epoch
            self.epochs_without_improvement = 0
        else:
            start_degrading = self.epochs_without_improvement == 0
            self.epochs_without_improvement += 1
        stop = self.epochs_without_improvement >= self.rounds
        if stop:
            self.stopped = True
        return {
            "improved": improved,
            "stop": stop,
            "start_degrading": start_degrading,
        }
