"""Zero-inflated wrapper: a mixture of a point mass at 0 (probability π)
and a base count distribution (counterpart of
``scvae_tpu/distributions/zero_inflated.py``).

* ``log_prob(x) = log(1−π) + dist.log_prob(x)``          for x > 0
* ``log_prob(0) = log(π + (1−π)·dist.prob(0))``, in log space with
  ``logaddexp``; both branches are evaluated and ``where`` picks one
* ``mean = (1−π)·dist.mean()``
* ``variance = (1−π)·(dist.variance() + dist.mean()²) − mean²``
"""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.ops.special import logaddexp


@dataclasses.dataclass(frozen=True)
class ZeroInflated(Distribution):
    dist: Distribution
    pi: torch.Tensor

    def parameters(self):
        return (*self.dist.parameters(), self.pi)

    def log_prob(self, x):
        log_pi = torch.log(self.pi)
        log1m_pi = torch.log1p(-self.pi)
        base_lp = self.dist.log_prob(x)
        y_pos = log1m_pi + base_lp
        y_zero = logaddexp(log_pi, log1m_pi + base_lp)
        return torch.where(x > 0, y_pos, y_zero)

    def mean(self):
        return (1.0 - self.pi) * self.dist.mean()

    def variance(self):
        base_mean = self.dist.mean()
        second_moment = (1.0 - self.pi) * (
            self.dist.variance() + torch.square(base_mean)
        )
        return second_moment - torch.square(self.mean())
