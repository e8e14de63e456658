"""A minimal in-memory data set (the part of ``scvae_tpu/data/dataset.py``
that training and evaluation need): a count matrix, dense or CSR, with cells
as rows, and the fields the evaluation's output sets carry (the standard
deviations of a reconstruction, example and feature names, kind, version
and predicted cluster ids).  Loading, preprocessing, labels, splitting and
caching are not ported yet."""

from __future__ import annotations

import numpy as np
import scipy.sparse

# The seed of the evaluation subset (the reference's, through the JAX
# package's ``scvae_tpu/data/utilities.py``).
EVALUATION_SUBSET_SEED = 80


class DataSet:
    def __init__(self, values, name: str = "in-memory", *,
                 total_standard_deviations=None,
                 explained_standard_deviations=None, example_names=None,
                 feature_names=None, kind: str = "full",
                 version: str = "original"):
        if not scipy.sparse.issparse(values):
            values = np.asarray(values)
        if values.ndim != 2:
            raise ValueError(f"values must be (cells, genes), got {values.shape}")
        self.name = name
        self.values = values
        # per-cell total counts (N, 1), the constrained likelihoods' N
        self.count_sum = np.asarray(values.sum(axis=1)).reshape(-1, 1)
        self.total_standard_deviations = total_standard_deviations
        self.explained_standard_deviations = explained_standard_deviations
        self.example_names = example_names
        self.feature_names = feature_names
        self.kind = kind
        self.version = version
        self.predicted_cluster_ids = None

    @property
    def number_of_examples(self) -> int:
        return int(self.values.shape[0])

    @property
    def number_of_features(self) -> int:
        return int(self.values.shape[1])

    def update_predictions(self, predicted_cluster_ids=None) -> None:
        """Attach a model's predicted cluster ids (N,)."""
        if predicted_cluster_ids is not None:
            self.predicted_cluster_ids = np.asarray(predicted_cluster_ids)


def indices_for_evaluation_subset(
    evaluation_set: DataSet,
    total_maximum_number_of_examples: int = 25,
) -> np.ndarray:
    """The sorted, seeded subset of at most 25 examples whose reconstruction
    standard deviations an evaluation keeps (the unlabelled case of the JAX
    package's ``indices_for_evaluation_subset``; the port's data sets carry
    no labels yet)."""
    random_state = np.random.RandomState(EVALUATION_SUBSET_SEED)
    subset = random_state.permutation(evaluation_set.number_of_examples)
    return np.sort(subset[:total_maximum_number_of_examples])
