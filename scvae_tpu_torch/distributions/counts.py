"""The negative-binomial count likelihood (counterpart of
``NegativeBinomial`` in ``scvae_tpu/distributions/counts.py``).

TFP convention, as the reference uses it: ``NegativeBinomial(total_count=r,
probs=p)`` counts successes before ``r`` failures, so
``log_prob(x) = lgamma(x+r) − lgamma(r) − lgamma(x+1) + r·log1p(−p) +
x·log(p)`` and the mean is ``r·p/(1−p)``.  ``lgamma`` is the port's series
(:mod:`scvae_tpu_torch.ops.special`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.ops.special import lgamma


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(Distribution):
    total_count: torch.Tensor  # r > 0 (may be non-integer)
    probs: torch.Tensor  # success probability p in (0, 1)

    def parameters(self):
        return (self.total_count, self.probs)

    def log_prob(self, x):
        r = self.total_count
        p = self.probs
        return (
            lgamma(x + r)
            - lgamma(r)
            - lgamma(1.0 + x)
            + r * torch.log1p(-p)
            + torch.xlogy(x, p)
        )

    def mean(self):
        return self.total_count * self.probs / (1.0 - self.probs)

    def variance(self):
        return self.mean() / (1.0 - self.probs)
