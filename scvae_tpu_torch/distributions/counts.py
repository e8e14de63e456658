"""Count likelihoods: Poisson and negative binomial (counterparts of
``Poisson`` and ``NegativeBinomial`` in ``scvae_tpu/distributions/counts.py``).

TFP conventions, as the reference uses them:

* ``Poisson(log_rate)`` on (possibly non-integer) float targets:
  ``log_prob(x) = x·log_rate − rate − lgamma(1+x)``;
* ``NegativeBinomial(total_count=r, probs=p)`` counts successes before ``r``
  failures, so ``log_prob(x) = lgamma(x+r) − lgamma(r) − lgamma(x+1) +
  r·log1p(−p) + x·log(p)`` and the mean is ``r·p/(1−p)``.

``lgamma`` is the port's series (:mod:`scvae_tpu_torch.ops.special`), as in
the JAX package, which imports its series ``lgamma`` under the name
``gammaln`` for both.
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.ops.special import lgamma


@dataclasses.dataclass(frozen=True)
class Poisson(Distribution):
    log_rate: torch.Tensor

    @property
    def rate(self) -> torch.Tensor:
        return torch.exp(self.log_rate)

    def parameters(self):
        return (self.log_rate,)

    def log_prob(self, x):
        return x * self.log_rate - self.rate - lgamma(1.0 + x)

    def mean(self):
        return self.rate

    def variance(self):
        return self.rate


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
