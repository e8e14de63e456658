"""Objective helpers: stable log-mean-exp and the KL warm-up schedule
(counterparts in ``scvae_tpu/models/objectives.py``)."""

from __future__ import annotations

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
