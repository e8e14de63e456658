"""Label prediction: the majority-vote mapping of clusters to labels (the
ported part of ``scvae_tpu/analyses/prediction.py``; its clustering methods
and prediction specifications are not ported yet)."""

from __future__ import annotations

import numpy as np


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
