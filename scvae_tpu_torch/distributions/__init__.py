"""Likelihood / latent distribution library (the ported part)."""

from scvae_tpu_torch.distributions.base import Distribution, kl_divergence
from scvae_tpu_torch.distributions.counts import NegativeBinomial
from scvae_tpu_torch.distributions.normal import Normal
from scvae_tpu_torch.distributions.registry import (
    DISTRIBUTIONS,
    LATENT_DISTRIBUTIONS,
    DistributionSpec,
    ParameterSpec,
    parse_distribution,
)

__all__ = [
    "DISTRIBUTIONS",
    "Distribution",
    "DistributionSpec",
    "LATENT_DISTRIBUTIONS",
    "NegativeBinomial",
    "Normal",
    "ParameterSpec",
    "kl_divergence",
    "parse_distribution",
]
