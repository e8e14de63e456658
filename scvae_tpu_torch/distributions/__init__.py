"""Likelihood / latent distribution library."""

from scvae_tpu_torch.distributions.base import Distribution, kl_divergence
from scvae_tpu_torch.distributions.categorised import Categorical, Categorised
from scvae_tpu_torch.distributions.counts import (
    Bernoulli,
    Gamma,
    NegativeBinomial,
    Poisson,
)
from scvae_tpu_torch.distributions.exponentially_modified_normal import (
    ExponentiallyModifiedNormal,
)
from scvae_tpu_torch.distributions.lomax import Lomax
from scvae_tpu_torch.distributions.mixture import GaussianMixture
from scvae_tpu_torch.distributions.normal import (
    LogNormal,
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    Normal,
    fill_triangular,
)
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
    "Bernoulli",
    "Categorical",
    "Categorised",
    "DISTRIBUTIONS",
    "Distribution",
    "DistributionSpec",
    "ExponentiallyModifiedNormal",
    "GAUSSIAN_MIXTURE_DISTRIBUTIONS",
    "Gamma",
    "GaussianMixture",
    "LATENT_DISTRIBUTIONS",
    "LogNormal",
    "Lomax",
    "MultivariateNormalDiag",
    "MultivariateNormalTriL",
    "NegativeBinomial",
    "Normal",
    "ParameterSpec",
    "Poisson",
    "ZeroInflated",
    "fill_triangular",
    "kl_divergence",
    "parse_distribution",
]
