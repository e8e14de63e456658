"""Likelihood / latent distribution library (the ported part)."""

from scvae_tpu_torch.distributions.base import Distribution, kl_divergence
from scvae_tpu_torch.distributions.categorised import Categorical, Categorised
from scvae_tpu_torch.distributions.counts import NegativeBinomial, Poisson
from scvae_tpu_torch.distributions.normal import Normal
from scvae_tpu_torch.distributions.registry import (
    DISTRIBUTIONS,
    GAUSSIAN_MIXTURE_DISTRIBUTIONS,
    LATENT_DISTRIBUTIONS,
    DistributionSpec,
    ParameterSpec,
    parse_distribution,
)
from scvae_tpu_torch.distributions.zero_inflated import ZeroInflated

__all__ = [
    "Categorical",
    "Categorised",
    "DISTRIBUTIONS",
    "Distribution",
    "DistributionSpec",
    "GAUSSIAN_MIXTURE_DISTRIBUTIONS",
    "LATENT_DISTRIBUTIONS",
    "NegativeBinomial",
    "Normal",
    "ParameterSpec",
    "Poisson",
    "ZeroInflated",
    "kl_divergence",
    "parse_distribution",
]
