"""High-level GMVAE API: ``GaussianMixtureVariationalAutoencoder`` with the
reference's ``train`` surface (the ported part of
``scvae_tpu/models/gmvae_api.py``).

It overrides the VAE API's model hooks (``_init_state``, ``_loss_fn``,
``_eval_fn``) and trains through the same ``train``.  Not ported yet, each
raising ``NotImplementedError`` when asked for: the per-epoch cluster
accuracy (it needs labelled data sets), centroid logging (it needs a log
directory), ``evaluate`` and ``sample``.
"""

from __future__ import annotations

from typing import Any

import torch

from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import gmvae, step
from scvae_tpu_torch.models.api import (
    _CONFIG_KWARGS,
    _SAMPLE_KWARGS,
    VariationalAutoencoder,
    _place,
)
from scvae_tpu_torch.models.utilities import parse_numbers_of_samples

# The VAE's configuration arguments that the GMVAE takes too; it ignores the
# others, as the JAX package does.
_GMVAE_CONFIG_KWARGS = ("count_sum", "dropout_keep_probabilities",
                        "kl_weight", "learning_rate", "precision")


class GaussianMixtureVariationalAutoencoder(VariationalAutoencoder):
    """GMVAE with the reference's ``train`` (the evaluate and sample
    surfaces are not ported yet)."""

    type = "GMVAE"

    def __init__(
        self,
        feature_size: int,
        latent_size: int | None = None,
        hidden_sizes=None,
        reconstruction_distribution: str | None = None,
        number_of_reconstruction_classes: int | None = None,
        latent_distribution: str | None = None,
        number_of_latent_clusters: int | None = None,
        prior_probabilities_method: str | None = None,
        prior_probabilities=None,
        minibatch_normalisation: bool | None = None,
        batch_correction: bool | None = None,
        number_of_batches: int | None = None,
        number_of_warm_up_epochs: int | None = None,
        proportion_of_free_nats_for_y_kl_divergence: float | None = None,
        log_directory: str | None = None,
        **kwargs: Any,
    ):
        unknown = (set(kwargs) - set(_CONFIG_KWARGS) - set(_SAMPLE_KWARGS)
                   - {"mesh"})
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        if log_directory is not None:
            raise NotImplementedError(
                "checkpoints, log directories and centroid logging are not "
                "ported yet")
        if kwargs.get("mesh") is not None:
            raise NotImplementedError("device meshes are not ported yet")

        def default(value, *path):
            return get_default(*path) if value is None else value

        samples = {
            name: parse_numbers_of_samples(
                default(kwargs.get(name), "models", "number_of_samples"))
            for name in _SAMPLE_KWARGS
        }
        self.number_of_monte_carlo_samples = samples["number_of_monte_carlo_samples"]
        self.number_of_importance_samples = samples["number_of_importance_samples"]

        method = default(prior_probabilities_method, "models",
                         "prior_probabilities_method")
        if method == "infer":
            method = "custom"
        config_kwargs = {
            name: kwargs[name] for name in _GMVAE_CONFIG_KWARGS if name in kwargs
        }
        if "dropout_keep_probabilities" in config_kwargs:
            config_kwargs["dropout_keep_probabilities"] = tuple(
                config_kwargs["dropout_keep_probabilities"] or ())
        self.config = gmvae.GMVAEConfig(
            feature_size=feature_size,
            latent_size=default(latent_size, "models", "latent_size"),
            hidden_sizes=tuple(default(hidden_sizes, "models", "hidden_sizes")),
            reconstruction_distribution=default(
                reconstruction_distribution, "models",
                "reconstruction_distribution"),
            number_of_reconstruction_classes=default(
                number_of_reconstruction_classes, "models",
                "number_of_reconstruction_classes"),
            latent_distribution=(
                latent_distribution
                or get_default("models", "latent_distribution")[self.type]),
            number_of_latent_clusters=default(
                number_of_latent_clusters, "models", "number_of_classes"),
            prior_probabilities_method=method,
            prior_probabilities=(tuple(prior_probabilities)
                                 if prior_probabilities else None),
            proportion_of_free_nats_for_y_kl_divergence=default(
                proportion_of_free_nats_for_y_kl_divergence, "models",
                "proportion_of_free_nats_for_y_kl_divergence"),
            minibatch_normalisation=default(
                minibatch_normalisation, "models", "minibatch_normalisation"),
            batch_correction=default(batch_correction, "models",
                                     "batch_correction"),
            number_of_batches=number_of_batches or 1,
            number_of_warm_up_epochs=default(
                number_of_warm_up_epochs, "models", "number_of_warm_up_epochs"),
            **config_kwargs,
        )
        self.feature_size = feature_size
        self.latent_size = self.config.latent_size
        self.hidden_sizes = self.config.hidden_sizes

    @property
    def number_of_latent_clusters(self) -> int:
        return self.config.number_of_latent_clusters

    # -- model hooks -------------------------------------------------------

    def _init_state(self, generator: torch.Generator, optimizer,
                    device: torch.device) -> step.TrainState:
        return _place(*gmvae.init(self.config, generator), optimizer, device)

    def _loss_fn(self, n_iw: int, n_mc: int):
        config = self.config

        def loss(params, model_state, batch, generator, warm_up_weight):
            return gmvae.loss_fn(
                config, params, model_state, batch, generator,
                n_iw=n_iw, n_mc=n_mc, warm_up_weight=warm_up_weight,
            )

        return loss

    def _eval_fn(self, n_iw: int, n_mc: int):
        config = self.config

        def evaluate(params, model_state, batch, generator):
            metrics, _ = gmvae.elbo_terms(
                config, params, model_state, batch, generator,
                training=False, n_iw=n_iw, n_mc=n_mc,
            )
            return metrics

        return evaluate

    # -- train -------------------------------------------------------------

    def train(self, training_set, validation_set=None, *,
              track_accuracy: bool = True, **kwargs):
        """Train through the VAE API's ``train``.  The reference also tracks
        the per-epoch cluster accuracy against the labels of a labelled data
        set; that callback is not ported, so labelled data with
        ``track_accuracy`` raises."""
        labelled = any(getattr(data, "has_labels", False)
                       for data in (training_set, validation_set))
        if track_accuracy and labelled:
            raise NotImplementedError(
                "the per-epoch cluster accuracy is not ported yet; pass "
                "track_accuracy=False")
        return super().train(training_set, validation_set, **kwargs)

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError("GMVAE evaluation is not ported yet")

    def sample(self, *args, **kwargs):
        raise NotImplementedError("GMVAE sampling is not ported yet")
