"""Gaussian-family distributions (counterparts of
``scvae_tpu/distributions/normal.py``): the Gaussian, the log-normal, the
diagonal and the full-covariance multivariate Gaussians, and
``fill_triangular``."""

from __future__ import annotations

import dataclasses
import math

import torch

from scvae_tpu_torch.distributions.base import Distribution

_LOG_2PI = math.log(2.0 * math.pi)


def _draws(shape, like: torch.Tensor, generator: torch.Generator | None,
           noise: torch.Tensor | None) -> torch.Tensor:
    """Standard-normal draws of ``shape``: ``noise`` when given (parity
    tests feed both frameworks the same draws), else from ``generator``."""
    shape = tuple(shape)
    if noise is None:
        return torch.randn(shape, generator=generator, dtype=like.dtype,
                           device=like.device)
    if tuple(noise.shape) != shape:
        raise ValueError(f"noise {tuple(noise.shape)} is not {shape}")
    return noise


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

    def mode(self):
        return self.mean()

    def sample(self, generator: torch.Generator | None, sample_shape=(),
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """Reparameterised draw ``loc + scale·ε`` of shape
        ``sample_shape + batch_shape``; ``noise`` supplies ε."""
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        return self.loc + self.scale * _draws(shape, self.loc, generator,
                                              noise)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    """exp(Normal(loc, scale)); x is clamped to the float's ``tiny`` before
    the log, as in the JAX package."""

    loc: torch.Tensor
    scale: torch.Tensor

    def parameters(self):
        return (self.loc, self.scale)

    def _normal(self) -> Normal:
        return Normal(loc=self.loc, scale=self.scale)

    def log_prob(self, x):
        log_x = torch.log(torch.clamp(x, min=torch.finfo(x.dtype).tiny))
        return self._normal().log_prob(log_x) - log_x

    def mean(self):
        return torch.exp(self.loc + 0.5 * torch.square(self.scale))

    def variance(self):
        s2 = torch.square(self.scale)
        return (torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)

    def mode(self):
        return torch.exp(self.loc - torch.square(self.scale))

    def sample(self, generator, sample_shape=(), noise=None):
        return torch.exp(self._normal().sample(generator, sample_shape, noise))


def fill_triangular(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pack a (..., m(m+1)/2) vector into a lower-triangular (..., m, m)
    matrix with ``tfp.distributions.fill_triangular``'s layout: the rows of
    ``concat([x[..., m:], reversed(x)])`` reshaped to (m, m), lower
    triangle kept."""
    m = dim
    n = m * (m + 1) // 2
    if x.shape[-1] != n:
        raise ValueError(f"expected trailing dim {n} for m={m}, got {x.shape[-1]}")
    xc = torch.cat([x[..., m:], torch.flip(x, dims=(-1,))], dim=-1)
    return torch.tril(xc.reshape(x.shape[:-1] + (m, m)))


@dataclasses.dataclass(frozen=True)
class MultivariateNormalDiag(Distribution):
    """Diagonal multivariate Gaussian; the event is the trailing axis."""

    loc: torch.Tensor
    scale_diag: torch.Tensor

    def parameters(self):
        return (self.loc, self.scale_diag)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale_diag
        return torch.sum(
            -0.5 * torch.square(z) - torch.log(self.scale_diag)
            - 0.5 * _LOG_2PI, dim=-1)

    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape())

    def variance(self):
        return torch.broadcast_to(torch.square(self.scale_diag),
                                  self.batch_shape())

    def covariance(self):
        var = self.variance()
        return var[..., :, None] * torch.eye(var.shape[-1], dtype=var.dtype,
                                             device=var.device)

    def mode(self):
        return self.mean()

    def sample(self, generator, sample_shape=(), noise=None):
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        return self.loc + self.scale_diag * _draws(shape, self.loc, generator,
                                                   noise)


@dataclasses.dataclass(frozen=True)
class MultivariateNormalTriL(Distribution):
    """Full-covariance multivariate Gaussian with a lower-triangular scale
    ``scale_tril`` (..., m, m); log_prob solves L y = x − loc with
    ``torch.linalg.solve_triangular``."""

    loc: torch.Tensor
    scale_tril: torch.Tensor

    def parameters(self):
        return (self.loc, self.scale_tril)

    def _dim(self) -> int:
        return self.scale_tril.shape[-1]

    def _batch(self, *shapes) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape[:-1],
                                      self.scale_tril.shape[:-2], *shapes)

    def batch_shape(self):
        return self._batch() + (self._dim(),)

    def log_prob(self, x):
        m = self._dim()
        diff = x - self.loc
        batch = self._batch(diff.shape[:-1])
        scale = self.scale_tril.expand(batch + (m, m))
        y = torch.linalg.solve_triangular(
            scale, diff.expand(batch + (m,))[..., None], upper=False)[..., 0]
        half_log_det = torch.sum(
            torch.log(torch.abs(torch.diagonal(self.scale_tril, dim1=-2,
                                               dim2=-1))), dim=-1)
        return (-0.5 * torch.sum(torch.square(y), dim=-1) - half_log_det
                - 0.5 * m * _LOG_2PI)

    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape())

    def covariance(self):
        return torch.matmul(self.scale_tril, self.scale_tril.transpose(-1, -2))

    def variance(self):
        return torch.diagonal(self.covariance(), dim1=-2, dim2=-1)

    def mode(self):
        return self.mean()

    def sample(self, generator, sample_shape=(), noise=None):
        """``loc + L ε`` of shape ``sample_shape + batch + (m,)``."""
        shape = tuple(sample_shape) + tuple(self.batch_shape())
        eps = _draws(shape, self.loc, generator, noise)
        return self.loc + torch.matmul(self.scale_tril, eps[..., None])[..., 0]
