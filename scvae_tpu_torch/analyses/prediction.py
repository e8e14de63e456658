"""Label prediction: clustering methods and the majority-vote mapping of
clusters to labels (the port of ``scvae_tpu/analyses/prediction.py``).

Methods: ``"k-means"`` (``analyses/kmeans.py`` on a device: k-means with
10 initialisations up to 10,000 training examples, mini-batch k-means with
batches of 100 and 3 initialisations above, as the JAX package's
scikit-learn calls) and ``"model"`` (a GMVAE's own cluster ids and
labels).  ``PredictionSpecifications`` names a prediction in the analyses'
file names.  Where the JAX package's k-means is unseeded, ``seed`` seeds
the port's draws (None: a fresh generator).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from scvae_tpu_torch.analyses.kmeans import KMeans, MiniBatchKMeans
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.utils.strings import normalise_string, proper_string

PREDICTION_METHODS: dict[str, dict] = {}

MAXIMUM_SAMPLE_SIZE_FOR_NORMAL_KMEANS = 10000


def _register_prediction_method(name: str):
    def decorator(function: Callable):
        aliases = {normalise_string(name)}
        aliases.add(normalise_string(name).replace("_", ""))
        PREDICTION_METHODS[name] = {"aliases": aliases, "function": function}
        return function

    return decorator


def map_cluster_ids_to_label_ids(
    label_ids: np.ndarray,
    cluster_ids: np.ndarray,
    excluded_class_ids=(),
) -> np.ndarray:
    """Majority-vote label per cluster, ignoring excluded classes
    (reference ``prediction.py:134-146``).  A tie goes to the smallest label
    id, as ``scipy.stats.mode`` gives it; a cluster with no label left keeps
    0."""
    label_ids = np.asarray(label_ids)
    cluster_ids = np.asarray(cluster_ids)
    predicted = np.zeros_like(cluster_ids)
    for unique_cluster_id in np.unique(cluster_ids):
        indices = cluster_ids == unique_cluster_id
        index_labels = label_ids[indices]
        for excluded in excluded_class_ids:
            index_labels = index_labels[index_labels != excluded]
        if len(index_labels) == 0:
            continue
        values, inverse = np.unique(index_labels, return_inverse=True)
        predicted[indices] = values[np.argmax(np.bincount(inverse))]
    return predicted


class PredictionSpecifications:
    """Prediction-method spec with a normalised name for artifact paths
    (reference ``prediction.py:149-183``)."""

    def __init__(self, method, number_of_clusters=None, training_set_kind=None):
        names = {
            name: spec["aliases"] for name, spec in PREDICTION_METHODS.items()
        }
        method = proper_string(method, names)
        if method not in PREDICTION_METHODS:
            raise ValueError(f"Prediction method `{method}` not found.")
        if number_of_clusters is None:
            raise TypeError("Number of clusters not set.")
        self.method = method
        self.number_of_clusters = number_of_clusters
        self.training_set_kind = (
            normalise_string(training_set_kind) if training_set_kind else None
        )

    @property
    def name(self) -> str:
        parts = [self.method, self.number_of_clusters]
        if self.training_set_kind and self.training_set_kind != "training":
            parts.append(self.training_set_kind)
        return "_".join(
            normalise_string(str(p)).replace("_", "") for p in parts
        )


@_register_prediction_method("k-means")
def _predict_using_kmeans(training_set, evaluation_set, number_of_clusters,
                          seed=None, device=None):
    if (
        training_set.number_of_examples
        <= MAXIMUM_SAMPLE_SIZE_FOR_NORMAL_KMEANS
    ):
        model = KMeans(number_of_clusters, seed=seed, device=device)
    else:
        model = MiniBatchKMeans(number_of_clusters, seed=seed, device=device)
    model.fit(training_set.values)
    cluster_ids = model.predict(evaluation_set.values)
    return cluster_ids, None, None


@_register_prediction_method("model")
def _predict_using_model(training_set, evaluation_set, number_of_clusters,
                         seed=None, device=None):
    return (
        evaluation_set.predicted_cluster_ids,
        evaluation_set.predicted_labels,
        evaluation_set.predicted_superset_labels,
    )


def labels_of_clusters(labels, to_id, to_name, excluded_names,
                       cluster_ids) -> np.ndarray:
    """The class name each example's cluster maps to by majority vote over
    ``labels`` (names; ``to_id`` and ``to_name`` map names to class ids and
    back), ``excluded_names`` left out of the vote."""
    label_ids = np.array([to_id[name] for name in labels])
    excluded_ids = [to_id[name] for name in (excluded_names or [])
                    if name in to_id]
    predicted_ids = map_cluster_ids_to_label_ids(
        label_ids, np.asarray(cluster_ids), excluded_ids)
    return np.array([to_name[i] for i in predicted_ids])


def predict_labels(
    training_set,
    evaluation_set,
    specifications: PredictionSpecifications | None = None,
    method: str | None = None,
    number_of_clusters: int | None = None,
    seed=None,
    device=None,
):
    """Cluster the evaluation set on ``device`` (CUDA unless ``"cpu"``) and
    map the clusters to labels by majority vote (reference
    ``prediction.py:33-131``): (cluster ids, predicted labels, predicted
    superset labels)."""
    if specifications is None:
        if method is None:
            method = get_default("evaluation", "prediction_method") or "k-means"
        specifications = PredictionSpecifications(
            method=method,
            number_of_clusters=number_of_clusters,
            training_set_kind=training_set.kind,
        )

    predict = PREDICTION_METHODS[specifications.method]["function"]
    cluster_ids, predicted_labels, predicted_superset_labels = predict(
        training_set=training_set,
        evaluation_set=evaluation_set,
        number_of_clusters=specifications.number_of_clusters,
        seed=seed,
        device=device,
    )

    if cluster_ids is not None:
        if predicted_labels is None and evaluation_set.has_labels:
            predicted_labels = labels_of_clusters(
                evaluation_set.labels, evaluation_set.class_name_to_class_id,
                evaluation_set.class_id_to_class_name,
                evaluation_set.excluded_classes, cluster_ids)
        if (
            predicted_superset_labels is None
            and evaluation_set.has_superset_labels
        ):
            predicted_superset_labels = labels_of_clusters(
                evaluation_set.superset_labels,
                evaluation_set.superset_class_name_to_superset_class_id,
                evaluation_set.superset_class_id_to_superset_class_name,
                evaluation_set.excluded_superset_classes, cluster_ids)

    return cluster_ids, predicted_labels, predicted_superset_labels
