"""The Gaussian distribution (counterpart of ``Normal`` in
``scvae_tpu/distributions/normal.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from scvae_tpu_torch.distributions.base import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: torch.Tensor
    scale: torch.Tensor

    def parameters(self):
        return (self.loc, self.scale)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - 0.5 * _LOG_2PI

    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape())

    def variance(self):
        return torch.broadcast_to(torch.square(self.scale), self.batch_shape())

    def sample(self, generator: torch.Generator | None, sample_shape=(),
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Reparameterised draw ``loc + scale·ε`` of shape
        ``sample_shape + batch_shape``.  ``noise`` supplies ε instead of the
        generator (parity tests feed both frameworks the same draws)."""
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        if noise is None:
            noise = torch.randn(
                shape, generator=generator, dtype=self.loc.dtype,
                device=self.loc.device,
            )
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise {tuple(noise.shape)} is not {shape}")
        return self.loc + self.scale * noise
