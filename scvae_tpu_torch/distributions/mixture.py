"""Mixture of diagonal Gaussians (counterpart of
``scvae_tpu/distributions/mixture.py``).

``logits`` (..., K) are the mixture weights and ``means`` / ``scale_diags``
the components stacked on a leading axis, (K, ..., D); the event is the
trailing D axis.  As in the JAX package, the components' log-probabilities
broadcast x against the stacked parameters and the mixture axis of the
weights is moved to the front, so parameters without a component axis (the
reconstruction heads, (S, B, F)) broadcast over it: every component is
then the same Gaussian, log_prob is its log-density, and the moments
are its moments.
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.distributions.normal import MultivariateNormalDiag


def _mix(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Σ_k weights_k·values_k with weights (K, ...) and values (K, ..., D)
    broadcast as ``weights[..., None] * values``.  Values without a
    component axis factor out of the sum, which keeps it from materialising
    a (K, ..., D) product."""
    if values.dim() <= weights.dim():
        return torch.sum(weights, dim=0)[..., None] * values
    return torch.sum(weights[..., None] * values, dim=0)


@dataclasses.dataclass(frozen=True)
class GaussianMixture(Distribution):
    logits: torch.Tensor
    means: torch.Tensor
    scale_diags: torch.Tensor

    def parameters(self):
        return (self.logits, self.means, self.scale_diags)

    @property
    def num_components(self) -> int:
        return self.means.shape[0]

    def mixture_log_probs(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def mixture_probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def components_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log N_k(x) of every component, (K, ...)."""
        return MultivariateNormalDiag(loc=self.means,
                                      scale_diag=self.scale_diags).log_prob(x)

    def log_prob(self, x):
        mix_lp = torch.movedim(self.mixture_log_probs(), -1, 0)  # (K, ...)
        return torch.logsumexp(self.components_log_prob(x) + mix_lp, dim=0)

    def mean(self):
        return _mix(torch.movedim(self.mixture_probs(), -1, 0), self.means)

    def variance(self):
        # V[x] = Σ_k π_k (σ_k² + μ_k²) − mean²
        probs = torch.movedim(self.mixture_probs(), -1, 0)
        second = _mix(probs, torch.square(self.scale_diags)
                      + torch.square(self.means))
        return second - torch.square(self.mean())

    def sample(self, generator, sample_shape=()):
        """Component indices from the weights, then a Gaussian draw of the
        chosen component."""
        batch = torch.broadcast_shapes(self.logits.shape[:-1],
                                       self.means.shape[1:-1])
        event = self.means.shape[-1]
        shape = tuple(sample_shape) + tuple(batch)
        k = self.logits.shape[-1]
        probs = self.mixture_probs().expand(shape + (k,)).reshape(-1, k)
        ks = torch.multinomial(probs, 1, generator=generator).reshape(shape)
        eps = torch.randn(shape + (event,), generator=generator,
                          dtype=self.means.dtype, device=self.means.device)

        def select(stacked):
            full = torch.movedim(
                stacked.expand((self.num_components,) + tuple(batch)
                               + (event,)), 0, -2)
            full = full.expand(shape + (self.num_components, event))
            index = ks[..., None, None].expand(shape + (1, event))
            return torch.gather(full, -2, index)[..., 0, :]

        return select(self.means) + select(self.scale_diags) * eps
