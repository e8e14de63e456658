"""Clustering metrics: ARI, AMI, accuracy (supervised) and the silhouette
(unsupervised, sampled above 20,000 examples): the port of
``scvae_tpu/analyses/metrics/clustering.py`` with the same registry,
class exclusion and sampling cap.

The JAX package calls scikit-learn; these are scikit-learn 1.9.0's
definitions computed with PyTorch on a device (CUDA unless ``"cpu"``):

* ARI from the pair confusion matrix of the contingency table of the two
  label sets (``torch.unique`` codes, one ``bincount``), in int64;
* AMI with arithmetic averaging: the mutual information, the entropies and
  the expected mutual information (``lgamma`` over the table's margins) in
  float64;
* the silhouette over chunks of rows of the Euclidean distance matrix in
  float64 (‖x‖² − 2xyᵀ + ‖y‖², clipped at 0, the diagonal 0, as
  scikit-learn computes it), so that no n × n matrix is held at once.

Labels may be strings: they are coded on the host first.  Where the JAX
package samples without a seed (the silhouette above 20,000 examples), the
port takes ``seed`` (None: a fresh generator), and draws the sample as
scikit-learn does from ``numpy.random.RandomState(seed)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scvae_tpu_torch.utils.device import (
    float64_tensor,
    random_state,
    resolve_device,
)

CLUSTERING_METRICS: dict[str, dict] = {}

MAXIMUM_NUMBER_OF_EXAMPLES_BEFORE_SAMPLING_SILHOUETTE_SCORE = 20_000
# Bytes of one chunk of silhouette distances (rows × examples, float64).
SILHOUETTE_CHUNK_BYTES = 1 << 28
_EPS = float(np.finfo(np.float64).eps)


def _register_clustering_metric(name: str, kind: str):
    def decorator(function):
        CLUSTERING_METRICS[name] = {"kind": kind, "function": function}
        return function

    return decorator


def _exclude_classes_from_label_set(*label_sets, excluded_classes=None):
    if excluded_classes is None:
        excluded_classes = []
    labels = np.asarray(label_sets[0])
    others = [np.asarray(s) for s in label_sets[1:]]
    for excluded in excluded_classes:
        included = labels != excluded
        labels = labels[included]
        others = [s[included] for s in others]
    if others:
        return [labels] + others
    return labels


def _codes(labels, device) -> torch.Tensor:
    """Labels as int64 codes 0 … k − 1 on ``device``, in sorted order."""
    labels = np.asarray(labels)
    if labels.dtype.kind not in "iub":
        labels = np.unique(labels, return_inverse=True)[1].reshape(-1)
    values = torch.from_numpy(labels.astype(np.int64)).to(device)
    return torch.unique(values, return_inverse=True)[1]


def _contingency(labels, predicted_labels, device) -> torch.Tensor:
    """The (classes, clusters) int64 contingency table."""
    true = _codes(labels, device)
    predicted = _codes(predicted_labels, device)
    n_true = int(true.max()) + 1 if true.numel() else 0
    n_predicted = int(predicted.max()) + 1 if predicted.numel() else 0
    return torch.bincount(true * n_predicted + predicted,
                          minlength=n_true * n_predicted).reshape(
                              n_true, n_predicted)


def _adjusted_rand_index(labels, predicted_labels, device) -> float:
    n = len(labels)
    table = _contingency(labels, predicted_labels, device)
    n_c, n_k = table.sum(1), table.sum(0)
    sum_squares = (table * table).sum()
    totals = torch.stack([sum_squares, (table * n_k[None, :]).sum(),
                          (table * n_c[:, None]).sum()]).tolist()
    sum_squares, rows, columns = totals
    tp = sum_squares - n
    fp = rows - sum_squares
    fn = columns - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn)
                                         + (tp + fp) * (fp + tn))


def _entropy(counts: torch.Tensor) -> float:
    counts = counts[counts > 0].double()
    if counts.numel() <= 1:
        return 0.0
    total = counts.sum()
    return float(-((counts / total) * (torch.log(counts) - torch.log(total)))
                 .sum())


def _mutual_information(table: torch.Tensor) -> float:
    rows, columns = table.sum(1), table.sum(0)
    if rows.numel() == 1 or columns.numel() == 1:
        return 0.0
    nzx, nzy = torch.nonzero(table, as_tuple=True)
    nz_val = table[nzx, nzy].double()
    total = float(table.sum())
    contingency_nm = nz_val / total
    outer = (rows[nzx] * columns[nzy]).double()
    log_outer = (-torch.log(outer) + math.log(float(rows.sum()))
                 + math.log(float(columns.sum())))
    mi = (contingency_nm * (torch.log(nz_val) - math.log(total))
          + contingency_nm * log_outer)
    mi = torch.where(mi.abs() < _EPS, torch.zeros_like(mi), mi)
    return max(float(mi.sum()), 0.0)


def _expected_mutual_information(table: torch.Tensor, n: int) -> float:
    """scikit-learn's ``expected_mutual_information``: the sum over every
    cell (i, j) and every n_ij from max(1, a_i + b_j − N) to
    min(a_i, b_j), one class row at a time."""
    a, b = table.sum(1), table.sum(0)
    if a.numel() == 1 or b.numel() == 1:
        return 0.0
    device = table.device
    a64, b64 = a.double(), b.double()
    n64 = float(n)
    lg = torch.lgamma
    gln_b = lg(b64 + 1)
    gln_nb = lg(n64 - b64 + 1)
    log_b = torch.log(b64)
    gln_n = math.lgamma(n64 + 1)
    emi = torch.zeros((), dtype=torch.float64, device=device)
    for i, a_i in enumerate(a.tolist()):
        nij = torch.arange(1, a_i + 1, dtype=torch.float64, device=device)
        start = torch.clamp(a_i - n + b, min=1)[:, None]
        end = torch.minimum(b, torch.full_like(b, a_i))[:, None]
        valid = (nij[None, :] >= start) & (nij[None, :] <= end)
        term1 = nij / n64
        term2 = (math.log(n64) + torch.log(nij))[None, :] \
            - math.log(a_i) - log_b[:, None]
        gln = (math.lgamma(a_i + 1) + gln_b[:, None]
               + math.lgamma(n64 - a_i + 1) + gln_nb[:, None]
               - (lg(nij + 1) + gln_n)[None, :]
               - lg(a_i - nij + 1)[None, :]
               - lg(torch.clamp(b64[:, None] - nij[None, :] + 1, min=1))
               - lg(torch.clamp(n64 - a_i - b64[:, None] + nij[None, :] + 1,
                                min=1)))
        terms = term1[None, :] * term2 * torch.exp(gln)
        emi = emi + torch.where(valid, terms, torch.zeros_like(terms)).sum()
    return float(emi)


def _adjusted_mutual_information(labels, predicted_labels, device) -> float:
    n = len(labels)
    table = _contingency(labels, predicted_labels, device)
    n_classes, n_clusters = table.shape
    if n_classes == n_clusters == 1 or n_classes == n_clusters == 0:
        return 1.0
    if n_classes == 1 or n_clusters == 1:
        return 0.0
    mi = _mutual_information(table)
    emi = _expected_mutual_information(table, n)
    normaliser = float(np.mean([_entropy(table.sum(1)),
                                _entropy(table.sum(0))]))
    denominator = normaliser - emi
    denominator = (min(denominator, -_EPS) if denominator < 0
                   else max(denominator, _EPS))
    numerator = mi - emi
    numerator = (min(numerator, -_EPS) if numerator < 0
                 else max(numerator, _EPS))
    return float(numerator / denominator)


@_register_clustering_metric(name="adjusted Rand index", kind="supervised")
def adjusted_rand_index(labels, predicted_labels, excluded_classes=None,
                        device=None):
    labels, predicted_labels = _exclude_classes_from_label_set(
        labels, predicted_labels, excluded_classes=excluded_classes
    )
    return _adjusted_rand_index(labels, predicted_labels,
                                resolve_device(device))


@_register_clustering_metric(
    name="adjusted mutual information", kind="supervised"
)
def adjusted_mutual_information(labels, predicted_labels,
                                excluded_classes=None, device=None):
    labels, predicted_labels = _exclude_classes_from_label_set(
        labels, predicted_labels, excluded_classes=excluded_classes
    )
    return _adjusted_mutual_information(labels, predicted_labels,
                                        resolve_device(device))


def _silhouette(values: torch.Tensor, codes: torch.Tensor) -> float:
    """Mean silhouette of float64 ``values`` under label ``codes`` (0 … k −
    1), from chunks of rows of the distance matrix."""
    n = values.shape[0]
    one_hot = torch.nn.functional.one_hot(codes).double()
    frequencies = one_hot.sum(0)
    squared_norms = (values * values).sum(1)
    chunk = max(1, SILHOUETTE_CHUNK_BYTES // (8 * n))
    intra, inter = [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        rows = torch.arange(start, stop, device=values.device)
        distances = (-2.0 * values[start:stop] @ values.T
                     + squared_norms[start:stop, None]
                     + squared_norms[None, :])
        distances.clamp_(min=0.0)
        distances[rows - start, rows] = 0.0
        distances.sqrt_()
        cluster_distances = distances @ one_hot
        own = codes[start:stop]
        index = torch.arange(stop - start, device=values.device)
        intra.append(cluster_distances[index, own])
        cluster_distances[index, own] = torch.inf
        inter.append((cluster_distances / frequencies).min(1).values)
    intra_distances = torch.cat(intra) / (frequencies[codes] - 1)
    inter_distances = torch.cat(inter)
    samples = ((inter_distances - intra_distances)
               / torch.maximum(intra_distances, inter_distances))
    return float(torch.nan_to_num(samples).mean())


@_register_clustering_metric(name="silhouette score", kind="unsupervised")
def silhouette_score(values, predicted_labels, seed=None, device=None):
    """scikit-learn's ``silhouette_score`` with the Euclidean metric; NaN
    for fewer than 2 or more than n − 1 classes; above 20,000 examples, on
    the first 20,000 of ``RandomState(seed).permutation(n)``."""
    predicted_labels = np.asarray(predicted_labels)
    n_classes = np.unique(predicted_labels).shape[0]
    n_examples = values.shape[0]
    if n_classes < 2 or n_classes > n_examples - 1:
        return np.nan
    device = resolve_device(device)
    sample_size = MAXIMUM_NUMBER_OF_EXAMPLES_BEFORE_SAMPLING_SILHOUETTE_SCORE
    if n_examples > sample_size:
        indices = random_state(seed).permutation(n_examples)[:sample_size]
        values = values[indices]
        predicted_labels = predicted_labels[indices]
        if not 1 < np.unique(predicted_labels).shape[0] < len(indices):
            raise ValueError("the silhouette's sample holds fewer than 2 "
                             "classes")
    return _silhouette(float64_tensor(values, device),
                       _codes(predicted_labels, device))


def accuracy(labels, predicted_labels, excluded_classes=None):
    labels, predicted_labels = _exclude_classes_from_label_set(
        labels, predicted_labels, excluded_classes=excluded_classes
    )
    return float(np.mean(predicted_labels == labels))


def compute_clustering_metrics(evaluation_set, seed=None,
                               device=None) -> dict[str, dict]:
    """Every registered metric over clusters, labels and superset labels,
    plus the accuracies, in the JAX package's dict (reference
    ``clustering.py:27-89``); ``seed`` for the silhouette's sample."""
    device = resolve_device(device)
    values = {
        metric: {
            "clusters": None,
            "clusters; superset": None,
            "labels": None,
            "labels; superset": None,
        }
        for metric in CLUSTERING_METRICS
    }

    for metric_name, attributes in CLUSTERING_METRICS.items():
        metric_values = values[metric_name]
        function = attributes["function"]
        if attributes["kind"] == "supervised":
            if evaluation_set.has_labels:
                if evaluation_set.has_predicted_cluster_ids:
                    metric_values["clusters"] = function(
                        evaluation_set.labels,
                        evaluation_set.predicted_cluster_ids,
                        evaluation_set.excluded_classes, device=device,
                    )
                if evaluation_set.has_predicted_labels:
                    metric_values["labels"] = function(
                        evaluation_set.labels,
                        evaluation_set.predicted_labels,
                        evaluation_set.excluded_classes, device=device,
                    )
            if evaluation_set.has_superset_labels:
                if evaluation_set.has_predicted_cluster_ids:
                    metric_values["clusters; superset"] = function(
                        evaluation_set.superset_labels,
                        evaluation_set.predicted_cluster_ids,
                        evaluation_set.excluded_superset_classes,
                        device=device,
                    )
                if evaluation_set.has_predicted_superset_labels:
                    metric_values["labels; superset"] = function(
                        evaluation_set.superset_labels,
                        evaluation_set.predicted_superset_labels,
                        evaluation_set.excluded_superset_classes,
                        device=device,
                    )
        else:  # unsupervised
            for key, present, predicted in (
                ("clusters", evaluation_set.has_predicted_cluster_ids,
                 evaluation_set.predicted_cluster_ids),
                ("labels", evaluation_set.has_predicted_labels,
                 evaluation_set.predicted_labels),
                ("labels; superset",
                 evaluation_set.has_predicted_superset_labels,
                 evaluation_set.predicted_superset_labels),
            ):
                if present:
                    metric_values[key] = function(
                        evaluation_set.values, predicted, seed=seed,
                        device=device)

    accuracies = {"accuracy": None, "superset_accuracy": None}
    if evaluation_set.has_labels and evaluation_set.has_predicted_labels:
        accuracies["accuracy"] = accuracy(
            evaluation_set.labels,
            evaluation_set.predicted_labels,
            evaluation_set.excluded_classes,
        )
    if (
        evaluation_set.has_superset_labels
        and evaluation_set.has_predicted_superset_labels
    ):
        accuracies["superset_accuracy"] = accuracy(
            evaluation_set.superset_labels,
            evaluation_set.predicted_superset_labels,
            evaluation_set.excluded_superset_classes,
        )
    values["accuracies"] = accuracies
    return values
