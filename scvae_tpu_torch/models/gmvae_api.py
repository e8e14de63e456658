"""High-level GMVAE API: ``GaussianMixtureVariationalAutoencoder`` with the
reference's ``train``, ``evaluate`` and ``sample`` (the ported part of
``scvae_tpu/models/gmvae_api.py``).

It overrides the VAE API's model hooks (``_init_state``, ``_loss_fn``,
``_fused_evaluation``, ``_eval_fn``, ``_evaluation_outputs``,
``_prior_draws``) and runs through the same methods.  Training appends the
prior centroids to the run's ``centroids.json`` each epoch and, for
labelled data sets, the cluster accuracy of each set to its learning
curves (``accuracy``).  ``evaluate``
adds the y latent set and attaches the predicted cluster ids to every
output set, and for a labelled set the labels (and superset labels) that
the clusters map to by majority vote.  Like the JAX package's, this
constructor does not call ``validate_model_parameters``: a zero-inflated
base with classes trains.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.analyses.prediction import (
    labels_of_clusters,
    map_cluster_ids_to_label_ids,
)
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import checkpoints, gmvae, step
from scvae_tpu_torch.models.api import (
    _CONFIG_KWARGS,
    _SAMPLE_KWARGS,
    VariationalAutoencoder,
    _output_versions,
    _place,
    check_constructor_kwargs,
    mesh_and_device,
)
from scvae_tpu_torch.models.utilities import parse_numbers_of_samples

# The VAE's configuration arguments that the GMVAE takes too; it ignores the
# others, as the JAX package does.
_GMVAE_CONFIG_KWARGS = ("count_sum", "dropout_keep_probabilities",
                        "kl_weight", "learning_rate", "fused_likelihood",
                        "precision")


class GaussianMixtureVariationalAutoencoder(VariationalAutoencoder):
    """GMVAE with the reference's ``train``, ``evaluate`` and ``sample``."""

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
        check_constructor_kwargs(kwargs, _CONFIG_KWARGS)

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
        self.base_log_directory = default(log_directory, "models", "directory")
        self.mesh = kwargs.get("mesh")
        self.stopped_early = None

    @property
    def number_of_latent_clusters(self) -> int:
        return self.config.number_of_latent_clusters

    def _name_parts(self) -> dict[str, Any]:
        return dict(
            prior_probabilities_method=self.config.prior_probabilities_method,
            analytical_kl_term=False,
        )

    # -- model hooks -------------------------------------------------------

    def _init_state(self, generator: torch.Generator, optimizer,
                    device: torch.device) -> step.TrainState:
        return _place(*gmvae.init(self.config, generator), optimizer, device)

    def _loss_fn(self, n_iw: int, n_mc: int, genes=None):
        config = self.config

        def loss(params, model_state, batch, generator, warm_up_weight,
                 shard=None):
            return gmvae.loss_fn(
                config, params, model_state, batch, generator,
                n_iw=n_iw, n_mc=n_mc, warm_up_weight=warm_up_weight,
                shard=shard, genes=genes,
            )

        return loss

    def _fused_evaluation(self, device) -> bool:
        """The GMVAE's evaluation keeps the unfused path everywhere."""
        return False

    def _eval_fn(self, n_iw: int, n_mc: int, genes=None):
        config = self.config

        def evaluate(params, model_state, batch, generator, shard=None):
            metrics, _ = gmvae.elbo_terms(
                config, params, model_state, batch, generator,
                training=False, n_iw=n_iw, n_mc=n_mc, shard=shard,
                genes=genes,
            )
            return metrics

        return evaluate

    def _evaluation_outputs(self, params, model_state, batch, generator,
                            n_iw: int, n_mc: int,
                            shard=None) -> dict[str, torch.Tensor]:
        return gmvae.evaluation_outputs(self.config, params, model_state,
                                        batch, generator, n_iw=n_iw,
                                        n_mc=n_mc, shard=shard)

    def _prior_draws(self, params, sample_size: int,
                     generator: torch.Generator, device: torch.device):
        ys, z = gmvae.sample_prior(self.config, params, sample_size,
                                   generator)
        return z, ys

    def _latent_values_fn(self):
        config = self.config

        def latents(params, model_state, x):
            return gmvae.latent_means(config, params, model_state, x)

        return latents

    # -- per-epoch cluster accuracy ---------------------------------------

    def _make_accuracy_callback(self, data_sets: dict[str, Any],
                                device: torch.device):
        """An epoch callback that writes each labelled set's ``accuracy``
        into its epoch metrics (JAX ``gmvae_api.py:234-302``): argmax
        q(y|x) over the whole set, clusters mapped to labels by majority
        vote, excluded classes left out.  Each set is staged on ``device``
        once, here (JAX uploads it every epoch; the values are the same).
        The callback runs eagerly between epochs, on the train state the
        loop hands it (the epoch's snapshot with the deferred fetch), and
        draws no random numbers."""
        prepared = {}
        for kind, data_set in data_sets.items():
            if not getattr(data_set, "has_labels", False):
                continue
            values = data_set.preprocessed_values
            if values is None:
                values = data_set.values
            if scipy.sparse.issparse(values):
                values = values.toarray()
            label_ids, excluded = _label_ids(
                data_set.labels, data_set.class_name_to_class_id,
                data_set.excluded_classes)
            x = torch.from_numpy(
                np.ascontiguousarray(values, np.float32)).to(device)
            prepared[kind] = (x, label_ids, excluded)

        def callback(epoch, train_state, epoch_metrics):
            for kind, (x, label_ids, excluded) in prepared.items():
                ids = gmvae.cluster_ids(train_state.params,
                                        train_state.model_state,
                                        x).cpu().numpy()
                predicted = map_cluster_ids_to_label_ids(
                    label_ids, ids, excluded)
                keep = ~np.isin(label_ids, excluded)
                accuracy = (
                    float((predicted[keep] == label_ids[keep]).mean())
                    if keep.any()
                    else float("nan")
                )
                epoch_metrics.setdefault(kind, {})["accuracy"] = accuracy

        return callback

    # -- train -------------------------------------------------------------

    def train(self, training_set, validation_set=None, *,
              track_accuracy: bool = True, epoch_callback=None, **kwargs):
        """Train through the VAE API's ``train``, appending the prior
        centroids to the run's files each epoch and, with
        ``track_accuracy``, the cluster accuracy of each labelled set
        (reference ``:1299-1333``)."""
        # the mesh first: its device is the rank's, where the sets go
        kwargs["mesh"], device = mesh_and_device(
            kwargs.get("mesh") or self.mesh, kwargs.pop("devices", None),
            kwargs.pop("number_of_devices", None),
            kwargs.pop("model_parallelism", None), kwargs.get("device"))
        accuracy_callback = None
        if track_accuracy and any(getattr(data, "has_labels", False)
                                  for data in (training_set, validation_set)):
            accuracy_callback = self._make_accuracy_callback(
                {"training": training_set, "validation": validation_set},
                device)
        user_callback = epoch_callback

        def callback(epoch, train_state, epoch_metrics):
            if accuracy_callback is not None:
                accuracy_callback(epoch, train_state, epoch_metrics)
            checkpoints.append_centroids(
                self._active_log_directory,
                gmvae.prior_centroids(self.config, train_state.params))
            if user_callback is not None:
                user_callback(epoch, train_state, epoch_metrics)

        return super().train(training_set, validation_set,
                             epoch_callback=callback, **kwargs)

    # -- evaluate ----------------------------------------------------------

    def evaluate(
        self,
        evaluation_set,
        minibatch_size: int | None = None,
        run_id: str | None = None,
        use_early_stopping_model: bool = False,
        use_best_model: bool = False,
        output_versions: str | list[str] = "all",
        evaluation_subset_indices=None,
        seed: int = 0,
        verbose: bool = True,
        mesh=None,
        devices=None,
        number_of_devices: int | None = None,
        model_parallelism: int | None = None,
        device: torch.device | str | None = None,
    ):
        """As the VAE's ``evaluate``; ``latent`` gives a {"z": …, "y": …}
        pair of sets (the latent means marginalised over y, and q(y|x)),
        and every output set carries the predicted cluster ids and, for a
        labelled set, the labels and superset labels its clusters map to
        by majority vote (JAX ``gmvae_api.py:485-520``)."""
        output_versions = _output_versions(output_versions)
        mesh, device = mesh_and_device(
            mesh if mesh is not None else self.mesh, devices,
            number_of_devices, model_parallelism, device)
        evaluation_set = self._data_set(evaluation_set)
        rows, stddevs, metrics = self._evaluation_pass(
            evaluation_set, minibatch_size, run_id, use_early_stopping_model,
            use_best_model, evaluation_subset_indices, seed, device, mesh,
            ("lower_bound", "reconstruction_error", "kl_divergence",
             "kl_divergence_z", "kl_divergence_y"),
            ("p_x_mean", "q_z_mean", "y_probs", "cluster_ids"))
        if verbose:
            print("Evaluation: ELBO {lower_bound:.6g}  ENRE "
                  "{reconstruction_error:.6g}  KL_z {kl_divergence_z:.6g}  "
                  "KL_y {kl_divergence_y:.6g}".format(**metrics))
        self._last_evaluation_metrics = metrics
        cluster_ids = rows["cluster_ids"].astype(np.int32)
        predicted_labels = None
        if evaluation_set.has_labels:
            predicted_labels = labels_of_clusters(
                evaluation_set.labels, evaluation_set.class_name_to_class_id,
                evaluation_set.class_id_to_class_name,
                evaluation_set.excluded_classes, cluster_ids)
        predicted_superset_labels = None
        if evaluation_set.has_superset_labels:
            predicted_superset_labels = labels_of_clusters(
                evaluation_set.superset_labels,
                evaluation_set.superset_class_name_to_superset_class_id,
                evaluation_set.superset_class_id_to_superset_class_name,
                evaluation_set.excluded_superset_classes, cluster_ids)

        def with_clusters(data_set):
            data_set.update_predictions(
                predicted_cluster_ids=cluster_ids,
                predicted_labels=predicted_labels,
                predicted_superset_labels=predicted_superset_labels,
            )
            return data_set

        output_sets: list[Any] = []
        if "transformed" in output_versions:
            output_sets.append(with_clusters(evaluation_set))
        if "reconstructed" in output_versions:
            output_sets.append(with_clusters(self._reconstructed_set(
                evaluation_set, rows["p_x_mean"], stddevs)))
        if "latent" in output_versions:
            output_sets.append({
                "z": with_clusters(self._latent_set(
                    evaluation_set, rows["q_z_mean"], "z",
                    [f"latent variable {i + 1}"
                     for i in range(self.config.latent_size)])),
                "y": with_clusters(self._latent_set(
                    evaluation_set, rows["y_probs"], "y",
                    [f"cluster {k + 1}"
                     for k in range(self.config.n_clusters)])),
            })
        return output_sets[0] if len(output_sets) == 1 else tuple(output_sets)


def _label_ids(labels, to_id, excluded_names):
    """``labels`` as class ids, and the ids of those ``excluded_names``
    that are classes of the set."""
    label_ids = np.array([to_id[name] for name in labels])
    excluded = [to_id[name] for name in (excluded_names or [])
                if name in to_id]
    return label_ids, excluded
