"""Exponentially modified Gaussian: X = Normal(loc, scale) +
Exponential(rate) (counterpart of
``scvae_tpu/distributions/exponentially_modified_normal.py``).  With
u = rate·(x − loc) and v = rate·scale:

``log_prob(x) = −u + v²/2 + log(erfc((−u + v²)/(√2·v))) − log 2 + log rate``

The erfc value is clipped below at the float's ``tiny`` before the log, as
in the JAX package, so the far right tail gives a finite value and
gradient."""

from __future__ import annotations

import dataclasses
import math

import torch

from scvae_tpu_torch.distributions.base import Distribution


@dataclasses.dataclass(frozen=True)
class ExponentiallyModifiedNormal(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor
    rate: torch.Tensor

    def parameters(self):
        return (self.loc, self.scale, self.rate)

    def log_prob(self, x):
        u = self.rate * (x - self.loc)
        v = self.rate * self.scale
        v2 = torch.square(v)
        tiny = torch.finfo(torch.result_type(x, self.loc)).tiny
        erfc_value = torch.clamp(
            torch.special.erfc((-u + v2) / (math.sqrt(2.0) * v)), min=tiny)
        log_unnormalised = -u + 0.5 * v2 + torch.log(erfc_value)
        return log_unnormalised - (math.log(2.0) - torch.log(self.rate))

    def cdf(self, x):
        u = self.rate * (x - self.loc)
        v = self.rate * self.scale
        v2 = torch.square(v)
        return torch.special.ndtr(u / v) - torch.exp(
            -u + 0.5 * v2 + torch.log(torch.special.ndtr((u - v2) / v)))

    def mean(self):
        return self.loc * torch.ones_like(self.scale) + 1.0 / self.rate

    def variance(self):
        return (torch.square(self.scale) * torch.ones_like(self.loc)
                + torch.pow(self.rate, -2.0))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        like = self.loc
        tiny = torch.finfo(like.dtype).tiny
        normal = torch.randn(shape, generator=generator, dtype=like.dtype,
                             device=like.device)
        uniform = torch.rand(shape, generator=generator, dtype=like.dtype,
                             device=like.device).clamp(min=tiny)
        return normal * self.scale + self.loc - torch.log(uniform) / self.rate
