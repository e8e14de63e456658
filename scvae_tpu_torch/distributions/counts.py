"""Count and positive-value likelihoods: Poisson, negative binomial,
Bernoulli and gamma (counterparts of ``Poisson``, ``NegativeBinomial``,
``Bernoulli`` and ``Gamma`` in ``scvae_tpu/distributions/counts.py``).

TFP conventions, as the reference uses them:

* ``Poisson(log_rate)`` on (possibly non-integer) float targets:
  ``log_prob(x) = x·log_rate − rate − lgamma(1+x)``;
* ``NegativeBinomial(total_count=r, probs=p)`` counts successes before ``r``
  failures, so ``log_prob(x) = lgamma(x+r) − lgamma(r) − lgamma(x+1) +
  r·log1p(−p) + x·log(p)`` and the mean is ``r·p/(1−p)``.

``lgamma`` is the port's series (:mod:`scvae_tpu_torch.ops.special`), as in
the JAX package, which imports its series ``lgamma`` under the name
``gammaln`` for all of them; ``xlogy`` is ``torch.xlogy`` (0 where its first
argument is 0, as ``jax.scipy.special.xlogy``).
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.ops.special import lgamma, softplus


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


@dataclasses.dataclass(frozen=True)
class Bernoulli(Distribution):
    logits: torch.Tensor

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def parameters(self):
        return (self.logits,)

    def log_prob(self, x):
        # x·logits − softplus(logits), stable for any float x ∈ {0, 1}
        return x * self.logits - softplus(self.logits)

    def mean(self):
        return self.probs

    def variance(self):
        p = self.probs
        return p * (1.0 - p)

    def mode(self):
        return (self.logits > 0).to(self.logits.dtype)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        return torch.bernoulli(self.probs.expand(shape), generator=generator)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(concentration a, rate b): ``a·log b − lgamma(a) +
    xlogy(a − 1, x) − b·x``, which at x = 0 is −inf for a > 1, +inf for
    a < 1 and a·log b − lgamma(a) for a = 1, as in the JAX package."""

    concentration: torch.Tensor
    rate: torch.Tensor

    def parameters(self):
        return (self.concentration, self.rate)

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return a * torch.log(b) - lgamma(a) + torch.xlogy(a - 1.0, x) - b * x

    def mean(self):
        return self.concentration / self.rate

    def variance(self):
        return self.concentration / torch.square(self.rate)

    def mode(self):
        return torch.clamp(self.concentration - 1.0, min=0.0) / self.rate

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        return torch._standard_gamma(
            self.concentration.expand(shape).contiguous(),
            generator=generator) / self.rate
