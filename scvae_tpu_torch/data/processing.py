"""Preprocessing: feature mapping/selection, example filtering, composable
preprocessors, and seeded train/validation/test splitting.

The port's copy of ``scvae_tpu/data/processing.py`` (the counterpart of
``scvae/data/processing.py``) with the same fixed RNG seeds (42 for
splitting, 90 for random filtering) so splits are reproducible against the
reference.  The JAX package normalises and binarises with
``sklearn.preprocessing``; here ``_normalise`` and ``_binarise`` compute the
same values with numpy and scipy, in the same formats (a sparse matrix
normalises over columns into CSC, as scikit-learn returns it).
"""

from __future__ import annotations

from functools import reduce
from typing import Any, Callable, Sequence

import numpy as np
import scipy.sparse

from scvae_tpu_torch.data.sparse import SparseRowMatrix
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.utils.strings import normalise_string

SPLITTING_SEED = 42  # reference processing.py:356
RANDOM_FILTER_SEED = 90  # reference processing.py:259

PREPROCESSORS: dict[str, Callable] = {}


def _register_preprocessor(name: str):
    def decorator(function):
        PREPROCESSORS[name] = function
        return function

    return decorator


@_register_preprocessor("log")
def _log(values):
    return values.log1p() if scipy.sparse.issparse(values) else np.log1p(values)


@_register_preprocessor("exp")
def _exp(values):
    return values.expm1() if scipy.sparse.issparse(values) else np.expm1(values)


def _float_dtype(dtype) -> np.dtype:
    """float32 and float64 stay; any other dtype becomes float64 (what
    scikit-learn's ``normalize`` accepts)."""
    dtype = np.dtype(dtype)
    return dtype if dtype in (np.float32, np.float64) else np.dtype(np.float64)


@_register_preprocessor("normalise")
def _normalise(values):
    """Each column divided by its l2 norm (``sklearn.preprocessing.normalize(
    values, norm="l2", axis=0)``).  Dense: the norms in the values' float
    dtype, near-zero norms (under ten machine epsilons) taken as 1.
    Sparse: the squares of the stored values summed in float64 per column,
    empty columns left alone, the result CSC."""
    if scipy.sparse.issparse(values):
        csc = scipy.sparse.csc_matrix(values, dtype=_float_dtype(values.dtype),
                                      copy=True)
        data = csc.data
        squares = np.zeros(csc.shape[1], np.float64)
        columns = np.repeat(np.arange(csc.shape[1]), np.diff(csc.indptr))
        np.add.at(squares, columns, (data * data).astype(np.float64))
        norms = np.sqrt(squares)
        stored = norms[columns]
        keep = stored != 0.0
        data[keep] = (data[keep] / stored[keep]).astype(data.dtype)
        return csc
    x = np.array(values, dtype=_float_dtype(np.asarray(values).dtype))
    norms = np.sqrt(np.einsum("ij,ij->i", x.T, x.T))
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    x /= norms[None, :]
    return x


@_register_preprocessor("binarise")
def _binarise(values):
    """1 where a value exceeds 0.5, else 0, in the values' dtype and format
    (``sklearn.preprocessing.binarize(values, threshold=0.5)``; a sparse
    matrix drops its zeros)."""
    threshold = 0.5
    if scipy.sparse.issparse(values):
        values = values.copy()
        above = values.data > threshold
        values.data[above] = 1
        values.data[~above] = 0
        values.eliminate_zeros()
        return values
    values = np.array(values, copy=True)
    above = values > threshold
    values[above] = 1
    values[~above] = 0
    return values


@_register_preprocessor("bernoulli_sample")
def _bernoulli_sample(values):
    if scipy.sparse.issparse(values):
        values = values.copy()
        values.data = np.random.binomial(1, values.data).astype(values.dtype)
    else:
        values = np.random.binomial(1, values).astype(values.dtype)
    return values


def build_preprocessor(
    preprocessing_methods: Sequence[str] | None, noisy: bool = False
) -> Callable:
    """Compose registered preprocessors left to right
    (reference ``processing.py:305-333``).  With ``noisy``, ``binarise``
    becomes a fresh Bernoulli sample per call (per-epoch noise)."""
    preprocessors = []
    for method in preprocessing_methods or []:
        if noisy and method == "binarise":
            method = "bernoulli_sample"
        fn = PREPROCESSORS.get(method)
        if fn is None:
            raise ValueError(f"Preprocessing method `{method}` not found.")
        preprocessors.append(fn)
    if not preprocessors:
        preprocessors.append(lambda x: x)

    def preprocess(values):
        return reduce(lambda v, p: p(v), preprocessors, values)

    return preprocess


def map_features(values, feature_ids, feature_mapping):
    """Aggregate feature columns by ID → named-feature groups (gene-ID
    aggregation; reference ``processing.py:33-92``)."""
    values = scipy.sparse.csc_matrix(values)
    n_examples, _ = values.shape

    feature_name_from_id = {
        v: k for k, vs in feature_mapping.items() for v in vs
    }
    n_unknown = 0
    for fid in feature_ids:
        if fid not in feature_name_from_id:
            feature_name_from_id[fid] = fid
            n_unknown += 1

    # Column index per output feature name, in first-seen order.
    name_to_index: dict[Any, int] = {}
    column_targets = np.empty(len(feature_ids), np.int64)
    for i, fid in enumerate(feature_ids):
        name = feature_name_from_id[fid]
        if name not in name_to_index:
            name_to_index[name] = len(name_to_index)
        column_targets[i] = name_to_index[name]

    n_features = len(name_to_index)
    # Sparse aggregation: S[i, j] = 1 where column i maps to feature j.
    selector = scipy.sparse.csr_matrix(
        (
            np.ones(len(feature_ids), values.dtype),
            (np.arange(len(feature_ids)), column_targets),
        ),
        shape=(len(feature_ids), n_features),
    )
    aggregated = values @ selector
    feature_names = np.array(list(name_to_index.keys()))
    return SparseRowMatrix(aggregated), feature_names


def select_features(
    values_dictionary: dict[str, Any],
    feature_names: np.ndarray,
    method: str | None = None,
    parameters: Sequence | None = None,
):
    """Column selection (reference ``processing.py:95-166``)."""
    method = normalise_string(method or "")
    values = values_dictionary["original"]
    n_examples, n_features = values.shape

    if method == "remove_zeros":
        total = np.asarray(values.sum(axis=0)).squeeze()
        indices = total != 0
    elif method == "keep_variances_above":
        variances = np.asarray(values.var(axis=0)).squeeze()
        threshold = float(parameters[0]) if parameters else 0.5
        indices = variances > threshold
    elif method == "keep_highest_variances":
        variances = np.asarray(values.var(axis=0)).squeeze()
        order = np.argsort(variances)
        number_to_keep = int(parameters[0]) if parameters else int(n_examples / 2)
        indices = np.sort(order[-number_to_keep:])
    else:
        raise ValueError(f"Feature selection `{method}` not found.")

    if (indices.dtype == bool and indices.all()) or (
        indices.dtype != bool and len(indices) == n_features
    ):
        raise Exception(
            f"No features excluded using feature selection {method}."
        )

    selected = {
        version: (vals[:, indices] if vals is not None else None)
        for version, vals in values_dictionary.items()
    }
    return selected, feature_names[indices]


def filter_examples(
    values_dictionary: dict[str, Any],
    example_names: np.ndarray,
    method: str | None = None,
    parameters: Sequence | None = None,
    labels: np.ndarray | None = None,
    excluded_classes: Sequence | None = None,
    superset_labels: np.ndarray | None = None,
    excluded_superset_classes: Sequence | None = None,
    batch_indices: np.ndarray | None = None,
    count_sum: np.ndarray | None = None,
):
    """Row selection (reference ``processing.py:169-302``)."""
    method = normalise_string(method or "")

    if superset_labels is not None:
        filter_labels = superset_labels.copy()
        filter_excluded = excluded_superset_classes
    elif labels is not None:
        filter_labels = labels.copy()
        filter_excluded = excluded_classes
    else:
        filter_labels = None
        filter_excluded = None

    values = values_dictionary["original"]
    n_examples, _ = values.shape
    filter_indices = np.arange(n_examples)

    if method == "macosko":
        nnz = np.asarray((values != 0).sum(axis=1)).squeeze()
        filter_indices = np.nonzero(nnz > 900)[0]
    elif method == "inverse_macosko":
        nnz = np.asarray((values != 0).sum(axis=1)).squeeze()
        filter_indices = np.nonzero(nnz <= 900)[0]
    elif method in ("keep", "remove", "excluded_classes"):
        if filter_labels is None:
            raise ValueError(
                "Cannot filter examples based on labels, "
                "since data set is unlabelled."
            )
        class_names = np.unique(filter_labels)
        if method == "excluded_classes":
            method = "remove"
            parameters = filter_excluded
        if method == "keep":
            keep_indices: set[int] = set()
            for parameter in parameters or []:
                for class_name in class_names:
                    if normalise_string(str(class_name)) == normalise_string(
                        str(parameter)
                    ):
                        keep_indices.update(
                            filter_indices[filter_labels == class_name]
                        )
            filter_indices = filter_indices[sorted(keep_indices)]
        else:  # remove
            for parameter in parameters or []:
                for class_name in class_names:
                    if normalise_string(str(class_name)) == normalise_string(
                        str(parameter)
                    ):
                        mask = filter_labels != class_name
                        filter_labels = filter_labels[mask]
                        filter_indices = filter_indices[mask]
    elif method == "remove_count_sum_above":
        threshold = int(parameters[0])
        filter_indices = filter_indices[count_sum.reshape(-1) <= threshold]
    elif method == "random":
        n_samples = min(int(parameters[0]), n_examples)
        random_state = np.random.RandomState(RANDOM_FILTER_SEED)
        filter_indices = random_state.permutation(n_examples)[:n_samples]
    else:
        raise ValueError(f"Example filter `{method}` not found.")

    if method and len(filter_indices) == n_examples:
        raise Exception(
            f"No examples filtered out using example filter `{method}`."
        )

    filtered_values = {
        version: (vals[filter_indices, :] if vals is not None else None)
        for version, vals in values_dictionary.items()
    }
    filtered_example_names = example_names[filter_indices]
    filtered_labels = labels[filter_indices] if labels is not None else None
    filtered_batch = (
        batch_indices[filter_indices] if batch_indices is not None else None
    )
    return filtered_values, filtered_example_names, filtered_labels, filtered_batch


def split_data_set(
    data_dictionary: dict[str, Any],
    method: str | None = None,
    fraction: float | None = None,
) -> dict[str, Any]:
    """Train/validation/test split with the reference's seeded RNG
    (``processing.py:336-486``)."""
    if method is None:
        method = get_default("data", "splitting_method")
    if fraction is None:
        fraction = get_default("data", "splitting_fraction")

    if method == "default":
        method = "indices" if "split indices" in data_dictionary else "random"
    method = normalise_string(method)

    n = data_dictionary["values"].shape[0]
    random_state = np.random.RandomState(SPLITTING_SEED)

    if method in ("random", "sequential"):
        n_training_validation = int(fraction * n)
        n_training = int(fraction * n_training_validation)
        indices = (
            random_state.permutation(n) if method == "random" else np.arange(n)
        )
        training_indices = indices[:n_training]
        validation_indices = indices[n_training:n_training_validation]
        test_indices = indices[n_training_validation:]
    elif method == "indices":
        split_indices = data_dictionary["split indices"]
        training_indices = split_indices["training"]
        test_indices = split_indices["test"]
        if "validation" in split_indices:
            validation_indices = split_indices["validation"]
        else:
            n_training_validation = training_indices.stop
            n_all = test_indices.stop
            n_training = n_training_validation - (n_all - n_training_validation)
            training_indices = slice(n_training)
            validation_indices = slice(n_training, n_training_validation)
    elif method == "macosko":
        values = data_dictionary["values"]
        nnz = np.asarray((values != 0).sum(axis=1)).squeeze()
        training_indices = np.nonzero(nnz > 900)[0]
        rest = np.nonzero(nnz <= 900)[0]
        random_state.shuffle(rest)
        n_validation = int((1 - fraction) * len(rest))
        validation_indices = rest[:n_validation]
        test_indices = rest[n_validation:]
    else:
        raise ValueError(f"Splitting method `{method}` not found.")

    def take(array, idx):
        if array is None:
            return None
        return array[idx]

    split: dict[str, Any] = {
        "feature names": data_dictionary["feature names"],
        "class names": data_dictionary.get("class names"),
    }
    for kind, idx in (
        ("training set", training_indices),
        ("validation set", validation_indices),
        ("test set", test_indices),
    ):
        split[kind] = {
            "values": data_dictionary["values"][idx],
            "preprocessed values": take(
                data_dictionary.get("preprocessed values"), idx
            ),
            "binarised values": take(
                data_dictionary.get("binarised values"), idx
            ),
            "labels": take(data_dictionary.get("labels"), idx),
            "example names": data_dictionary["example names"][idx],
            "batch indices": take(data_dictionary.get("batch indices"), idx),
        }
    return split
