"""Distribution protocol for the likelihood library.

Counterpart of ``scvae_tpu/distributions/base.py``: small immutable objects
holding parameter tensors, with ``log_prob`` / ``mean`` / ``variance`` /
``sample``.  Parameters broadcast like tensors: a distribution
parameterised per cell and gene holds (B, F) tensors.
"""

from __future__ import annotations

from typing import Any

import torch


class Distribution:
    """Base class.  Subclasses implement ``log_prob`` and the moments."""

    def parameters(self) -> tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.log_prob(x))

    def mean(self) -> torch.Tensor:
        raise NotImplementedError

    def variance(self) -> torch.Tensor:
        raise NotImplementedError

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance())

    def batch_shape(self) -> torch.Size:
        """Broadcast shape of the parameter tensors."""
        return torch.broadcast_shapes(*(p.shape for p in self.parameters()))


def kl_divergence(q: Any, p: Any) -> torch.Tensor:
    """Analytic KL(q‖p) where defined (Normal pairs)."""
    from scvae_tpu_torch.distributions.normal import Normal

    if isinstance(q, Normal) and isinstance(p, Normal):
        var_ratio = torch.square(q.scale / p.scale)
        t1 = torch.square((q.loc - p.loc) / p.scale)
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
    raise NotImplementedError(
        f"No analytic KL for {type(q).__name__} ‖ {type(p).__name__}"
    )
