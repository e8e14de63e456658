"""Model identity: hyperparameter-addressed directory names, run IDs and the
model-version vocabulary (the port's copy of ``scvae_tpu/models/naming.py``;
the names and directories are the same strings, so the two packages find
each other's runs).  The directory scheme is
``<type>/<latent…>/<reconstruction…>[/run_<id>][/best|/early_stopping]``.
"""

from __future__ import annotations

import os
import random
import re
import string
import time

from scvae_tpu_torch.utils.strings import normalise_string

MODEL_VERSIONS = ["end_of_training", "best_model", "early_stopping"]

_MODEL_VERSION_ALIASES = {
    "end_of_training": ["eot", "end", "finish", "finished", "end_of_training"],
    "best_model": ["best", "bm", "optimal", "optimal_parameters", "best_model"],
    "early_stopping": ["es", "early", "stop", "stopped", "early_stopping"],
}


def _proper_string(original: str, translation: dict[str, list[str]]) -> str:
    """Map an alias in ``translation``'s values to its canonical key."""
    normalised = normalise_string(original)
    for proper, related in translation.items():
        if normalised in related:
            return proper
    return original


def parse_model_versions(versions) -> list[str]:
    """Resolve aliases to canonical version names (``"all"`` or ``None``
    gives every version)."""
    if isinstance(versions, str):
        versions = [versions]
    if versions == ["all"] or versions is None:
        return list(MODEL_VERSIONS)
    parsed = []
    for version in versions:
        canonical = _proper_string(version, _MODEL_VERSION_ALIASES)
        if canonical not in MODEL_VERSIONS:
            raise ValueError(f"Model version `{version}` not found.")
        parsed.append(canonical)
    return parsed


def generate_run_id() -> str:
    """UTC timestamp and four random letters."""
    timestamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    letters = "".join(random.choices(string.ascii_lowercase, k=4))
    return f"{timestamp}_{letters}"


def check_run_id(run_id) -> str:
    run_id = str(run_id)
    if not re.fullmatch(r"[\w\-]+", run_id):
        raise ValueError(
            "`run_id` can only contain letters, numbers, underscores and "
            "dashes."
        )
    return run_id


def model_name(
    model_type: str,
    *,
    latent_distribution: str,
    number_of_latent_clusters: int | None = None,
    parameterise_latent_posterior: bool = False,
    inference_architecture: str = "MLP",
    generative_architecture: str = "MLP",
    reconstruction_distribution: str,
    k_max: int = 0,
    use_count_sum_as_feature: bool = False,
    latent_size: int,
    hidden_sizes,
    number_of_monte_carlo_samples: int = 1,
    number_of_importance_samples: int = 1,
    analytical_kl_term: bool = False,
    minibatch_normalisation: bool = False,
    batch_correction: bool = False,
    dropout_parts=(),
    kl_weight: float = 1.0,
    number_of_warm_up_epochs: int = 0,
    prior_probabilities_method: str | None = None,
) -> str:
    """Hierarchical model name; the GMVAE adds its prior-probabilities
    method."""
    major_parts = [normalise_string(latent_distribution)]
    if "mixture" in latent_distribution and number_of_latent_clusters:
        major_parts.append(f"c_{number_of_latent_clusters}")
    if prior_probabilities_method and prior_probabilities_method != "uniform":
        major_parts.append(f"p_{normalise_string(prior_probabilities_method)}")
    if parameterise_latent_posterior:
        major_parts.append("parameterised")
    if inference_architecture != "MLP":
        major_parts.append(f"ia_{inference_architecture}")
    if generative_architecture != "MLP":
        major_parts.append(f"ga_{generative_architecture}")

    minor_parts = [normalise_string(reconstruction_distribution)]
    if k_max:
        minor_parts.append(f"k_{k_max}")
    if use_count_sum_as_feature:
        minor_parts.append("sum")
    minor_parts.append(f"l_{latent_size}")
    minor_parts.append("h_" + "_".join(map(str, hidden_sizes)))
    minor_parts.append(f"mc_{number_of_monte_carlo_samples}")
    minor_parts.append(f"iw_{number_of_importance_samples}")
    if analytical_kl_term:
        minor_parts.append("kl")
    if minibatch_normalisation:
        minor_parts.append("bn")
    if batch_correction:
        minor_parts.append("bc")
    if dropout_parts:
        minor_parts.append("dropout_" + "_".join(map(str, dropout_parts)))
    if kl_weight != 1:
        minor_parts.append(f"klw_{kl_weight}")
    if number_of_warm_up_epochs:
        minor_parts.append(f"wu_{number_of_warm_up_epochs}")

    return os.path.join(model_type, "-".join(major_parts), "-".join(minor_parts))


def log_directory(
    base: str,
    name: str,
    run_id: str | None = None,
    early_stopping: bool = False,
    best_model: bool = False,
) -> str:
    directory = os.path.join(base, name)
    if run_id:
        directory = os.path.join(directory, f"run_{check_run_id(run_id)}")
    if early_stopping and best_model:
        raise ValueError(
            "Early-stopping model and best model are mutually exclusive."
        )
    if early_stopping:
        directory = os.path.join(directory, "early_stopping")
    elif best_model:
        directory = os.path.join(directory, "best")
    return directory
