"""Declarative distribution registry (counterpart of
``scvae_tpu/distributions/registry.py``).

Maps a distribution name to per-parameter specs (support interval,
activation, head-size function) and a constructor ``theta → Distribution``.
The model builds one dense head per parameter from these specs: every name
of the JAX registry, the reconstruction likelihoods, the VAE latents and
the GMVAE's mixtures (the full-covariance one included).  The JAX
``ParameterSpec.initial_value`` is left out: no model reads it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from scvae_tpu_torch.distributions.base import Distribution
from scvae_tpu_torch.distributions.categorised import Categorical
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
    MultivariateNormalTriL,
    Normal,
    fill_triangular,
)
from scvae_tpu_torch.distributions.zero_inflated import ZeroInflated
from scvae_tpu_torch.ops.special import softplus
from scvae_tpu_torch.utils.strings import normalise_string

_F32 = np.finfo(np.float32)
_HALF_MIN = float(_F32.min / 2)
_HALF_MAX = float(_F32.max / 2)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _softmax_last(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def _interior(lo: float, hi: float) -> tuple[float, float]:
    """Nearest float32 values strictly inside [lo, hi]."""
    return (
        float(np.nextafter(np.float32(lo), np.float32(np.inf))),
        float(np.nextafter(np.float32(hi), np.float32(-np.inf))),
    )


@dataclasses.dataclass(frozen=True)
class ParameterSpec:
    """One distribution parameter: how its head output becomes a value."""

    support: tuple[float, float]
    activation: Callable[[torch.Tensor], torch.Tensor] = _identity
    # Head width as a function of the event size m.
    size_fn: Callable[[int], int] = lambda m: m

    def constrain(self, raw: torch.Tensor) -> torch.Tensor:
        """activation → clip to the nearest float32 strictly inside the
        support (the reference's ``bound ∓ tiny`` rounds back to the bound
        in float32).  The gradient is zero outside the clip range."""
        lo_in, hi_in = _interior(*self.support)
        return torch.clamp(self.activation(raw), lo_in, hi_in)


@dataclasses.dataclass(frozen=True)
class DistributionSpec:
    name: str
    parameters: dict[str, ParameterSpec]
    constructor: Callable[..., Distribution]
    uses_count_sum: bool = False  # the constrained classes take N
    # log_prob of a (..., F) target is one value per example (the event is
    # the feature axis), not one per feature
    event: bool = False

    def build(self, theta: dict[str, torch.Tensor],
              count_sum: torch.Tensor | None = None) -> Distribution:
        if self.uses_count_sum:
            return self.constructor(theta, count_sum)
        return self.constructor(theta)


def _make_gaussian(theta):
    return Normal(loc=theta["mu"], scale=torch.exp(theta["log_sigma"]))


def _make_softplus_gaussian(theta):
    return Normal(loc=theta["mean"],
                  scale=torch.sqrt(softplus(theta["softplus_scale"])))


def _make_multivariate_gaussian(theta):
    loc = theta["locations"]
    return MultivariateNormalTriL(
        loc=loc, scale_tril=fill_triangular(theta["scales"], loc.shape[-1]))


def _make_gaussian_mixture(theta):
    return GaussianMixture(logits=theta["logits"], means=theta["mus"],
                           scale_diags=torch.exp(theta["log_sigmas"]))


def _make_log_normal(theta):
    return LogNormal(loc=theta["mean"], scale=torch.sqrt(theta["variance"]))


def _make_emg(theta):
    return ExponentiallyModifiedNormal(
        loc=theta["location"], scale=theta["scale"], rate=theta["rate"])


def _make_gamma(theta):
    return Gamma(concentration=theta["concentration"], rate=theta["rate"])


def _make_bernoulli(theta):
    return Bernoulli(logits=theta["logits"])


def _make_lomax(theta):
    return Lomax(concentration=torch.exp(theta["log_concentration"]),
                 scale=torch.exp(theta["log_scale"]))


def _make_categorical(theta):
    return Categorical(logits=theta["logits"])


def _make_poisson(theta):
    return Poisson(log_rate=theta["log_lambda"])


def _make_constrained_poisson(theta, count_sum):
    # rate = softmax-normalised λ over genes × per-cell total count N
    return Poisson(log_rate=torch.log(theta["lambda"] * count_sum))


def _make_zero_inflated_poisson(theta):
    return ZeroInflated(dist=Poisson(log_rate=theta["log_lambda"]),
                        pi=theta["pi"])


def _make_negative_binomial(theta):
    return NegativeBinomial(
        total_count=torch.exp(theta["log_r"]), probs=theta["p"]
    )


def _make_zero_inflated_negative_binomial(theta):
    return ZeroInflated(dist=_make_negative_binomial(theta), pi=theta["pi"])


DISTRIBUTIONS: dict[str, DistributionSpec] = {
    "gaussian": DistributionSpec(
        name="gaussian",
        parameters={
            "mu": ParameterSpec(support=(_HALF_MIN, _HALF_MAX)),
            "log_sigma": ParameterSpec(support=(-3.0, 3.0)),
        },
        constructor=_make_gaussian,
    ),
    "softplus gaussian": DistributionSpec(
        name="softplus gaussian",
        parameters={
            "mean": ParameterSpec(support=(_HALF_MIN, _HALF_MAX)),
            "softplus_scale": ParameterSpec(support=(_HALF_MIN, _HALF_MAX)),
        },
        constructor=_make_softplus_gaussian,
    ),
    "multivariate gaussian": DistributionSpec(
        name="multivariate gaussian",
        parameters={
            "locations": ParameterSpec(support=(-math.inf, math.inf)),
            "scales": ParameterSpec(
                support=(0.0, math.inf), activation=softplus,
                size_fn=lambda m: m * (m + 1) // 2,
            ),
        },
        constructor=_make_multivariate_gaussian,
        event=True,
    ),
    "gaussian mixture": DistributionSpec(
        name="gaussian mixture",
        parameters={
            "logits": ParameterSpec(support=(-math.inf, math.inf)),
            "mus": ParameterSpec(support=(-math.inf, math.inf)),
            "log_sigmas": ParameterSpec(support=(-3.0, 3.0)),
        },
        constructor=_make_gaussian_mixture,
        event=True,
    ),
    "log-normal": DistributionSpec(
        name="log-normal",
        parameters={
            "mean": ParameterSpec(support=(-math.inf, math.inf)),
            "variance": ParameterSpec(support=(0.0, math.inf),
                                      activation=softplus),
        },
        constructor=_make_log_normal,
    ),
    "exponentially_modified_gaussian": DistributionSpec(
        name="exponentially_modified_gaussian",
        parameters={
            "location": ParameterSpec(support=(-math.inf, math.inf)),
            "scale": ParameterSpec(support=(0.0, math.inf),
                                   activation=softplus),
            "rate": ParameterSpec(support=(0.0, math.inf),
                                  activation=softplus),
        },
        constructor=_make_emg,
    ),
    "gamma": DistributionSpec(
        name="gamma",
        parameters={
            "concentration": ParameterSpec(support=(0.0, math.inf),
                                           activation=softplus),
            "rate": ParameterSpec(support=(0.0, math.inf),
                                  activation=softplus),
        },
        constructor=_make_gamma,
    ),
    "categorical": DistributionSpec(
        name="categorical",
        parameters={"logits": ParameterSpec(support=(-math.inf, math.inf))},
        constructor=_make_categorical,
    ),
    "bernoulli": DistributionSpec(
        name="bernoulli",
        parameters={"logits": ParameterSpec(support=(-math.inf, math.inf))},
        constructor=_make_bernoulli,
    ),
    "poisson": DistributionSpec(
        name="poisson",
        parameters={"log_lambda": ParameterSpec(support=(-10.0, 10.0))},
        constructor=_make_poisson,
    ),
    "constrained poisson": DistributionSpec(
        name="constrained poisson",
        parameters={
            "lambda": ParameterSpec(support=(0.0, 1.0), activation=_softmax_last)
        },
        constructor=_make_constrained_poisson,
        uses_count_sum=True,
    ),
    "lomax": DistributionSpec(
        name="lomax",
        parameters={
            "log_concentration": ParameterSpec(support=(-10.0, 10.0)),
            "log_scale": ParameterSpec(support=(-10.0, 10.0)),
        },
        constructor=_make_lomax,
    ),
    "zero-inflated poisson": DistributionSpec(
        name="zero-inflated poisson",
        parameters={
            "pi": ParameterSpec(support=(0.0, 1.0), activation=torch.sigmoid),
            "log_lambda": ParameterSpec(support=(-10.0, 10.0)),
        },
        constructor=_make_zero_inflated_poisson,
    ),
    "negative binomial": DistributionSpec(
        name="negative binomial",
        parameters={
            "p": ParameterSpec(support=(0.0, 1.0), activation=torch.sigmoid),
            "log_r": ParameterSpec(support=(-10.0, 10.0)),
        },
        constructor=_make_negative_binomial,
    ),
    "zero-inflated negative binomial": DistributionSpec(
        name="zero-inflated negative binomial",
        parameters={
            "pi": ParameterSpec(support=(0.0, 1.0), activation=torch.sigmoid),
            "p": ParameterSpec(support=(0.0, 1.0), activation=torch.sigmoid),
            "log_r": ParameterSpec(support=(-10.0, 10.0)),
        },
        constructor=_make_zero_inflated_negative_binomial,
    ),
}

DISTRIBUTIONS["modified gaussian"] = dataclasses.replace(
    DISTRIBUTIONS["softplus gaussian"], name="modified gaussian"
)

# "parameters" pins a prior/posterior parameter to a constant instead of a
# learned dense head.
LATENT_DISTRIBUTIONS: dict[str, dict[str, Any]] = {
    "gaussian": {
        "prior": {"name": "gaussian", "parameters": {"mu": 0.0, "log_sigma": 0.0}},
        "posterior": {"name": "gaussian", "parameters": {}},
    },
    "unit-variance gaussian": {
        "prior": {"name": "gaussian", "parameters": {"mu": 0.0, "log_sigma": 0.0}},
        "posterior": {"name": "gaussian", "parameters": {"log_sigma": 0.0}},
    },
}

GAUSSIAN_MIXTURE_DISTRIBUTIONS: dict[str, dict[str, str]] = {
    "gaussian mixture": {
        "z prior": "softplus gaussian",
        "z posterior": "softplus gaussian",
    },
    "full-covariance gaussian mixture": {
        "z prior": "multivariate gaussian",
        "z posterior": "multivariate gaussian",
    },
    "legacy gaussian mixture": {
        "z prior": "modified gaussian",
        "z posterior": "modified gaussian",
    },
}

def parse_distribution(distribution: str, model_type: str | None = None) -> str:
    """Resolve a (possibly alias-formatted) name against the right registry."""
    distribution = normalise_string(distribution)
    if model_type is None:
        kind, registry = "reconstruction", DISTRIBUTIONS
    elif model_type == "VAE":
        kind, registry = "latent", LATENT_DISTRIBUTIONS
    elif model_type == "GMVAE":
        kind, registry = "latent", GAUSSIAN_MIXTURE_DISTRIBUTIONS
    else:
        raise ValueError("Model type not found.")
    for name in registry:
        if normalise_string(name) == distribution:
            return name
    raise ValueError(
        "{} distribution `{}` not supported{}.".format(
            kind.capitalize(),
            distribution,
            f" for {model_type}" if model_type else "",
        )
    )
