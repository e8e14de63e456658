"""Lomax (Pareto type II) distribution (counterpart of
``scvae_tpu/distributions/lomax.py``): ``log_prob(x) = log α − log λ −
(α+1)·log1p(x/λ)``, ``cdf(x) = 1 − (1 + x/λ)^−α``; the mean is defined
for α > 1 and the variance for α > 2 (NaN or inf otherwise).  The variance
is λ²α / ((α−1)²(α−2)), the JAX package's corrected form, not the scVAE
reference's."""

from __future__ import annotations

import dataclasses

import torch

from scvae_tpu_torch.distributions.base import Distribution


@dataclasses.dataclass(frozen=True)
class Lomax(Distribution):
    concentration: torch.Tensor  # α
    scale: torch.Tensor  # λ

    def parameters(self):
        return (self.concentration, self.scale)

    def log_prob(self, x):
        a, lam = self.concentration, self.scale
        return torch.log(a) - torch.log(lam) - (a + 1.0) * torch.log1p(x / lam)

    def cdf(self, x):
        return 1.0 - torch.pow(1.0 + x / self.scale, -self.concentration)

    def log_cdf(self, x):
        return torch.log(self.cdf(x))

    def mean(self):
        a = self.concentration
        mean = self.scale / (a - 1.0)
        return torch.where(a > 1.0, mean, torch.full_like(mean, float("nan")))

    def variance(self):
        a = self.concentration
        var = torch.square(self.scale) * a / (torch.square(a - 1.0) * (a - 2.0))
        return torch.where(
            a > 2.0, var,
            torch.where(a > 1.0, torch.full_like(var, float("inf")),
                        torch.full_like(var, float("nan"))))

    def mode(self):
        return torch.zeros(self.batch_shape(), dtype=self.scale.dtype,
                           device=self.scale.device)

    def sample(self, generator, sample_shape=()):
        """Inverse cdf: x = λ·(u^(−1/α) − 1), u uniform on [tiny, 1)."""
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        tiny = torch.finfo(self.scale.dtype).tiny
        u = torch.rand(shape, generator=generator, dtype=self.scale.dtype,
                       device=self.scale.device).clamp(min=tiny)
        return self.scale * torch.expm1(-torch.log(u) / self.concentration)
