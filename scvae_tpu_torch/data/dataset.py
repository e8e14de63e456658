"""The ``DataSet`` container: values, labels, metadata, and the
acquire → load → preprocess → split pipeline with HDF5 caching.

The port's copy of ``scvae_tpu/data/dataset.py`` (the counterpart of the
reference's ``scvae/data/data_set.py:50``) with the same signature and
public surface (``load``, ``split``, ``binarise``, ``clear``, ``update``,
``update_predictions``, ``reset_predictions`` plus derived attributes like
``count_sum`` / ``normalised_count_sum`` / superset labels / class
probabilities) and the same cache files, so each package reads the
other's.  A matrix already in memory becomes a data set with
``DataSet("in-memory", values=…)``.  Reference data semantics preserved:

* ``count_sum`` per cell and ``normalised_count_sum = count_sum / max``
  (``data_set.py:534-537``)
* excluded classes default ``["No class"]`` (``data_set.py:45``)
* label → superset mapping incl. ``"infer"`` (``data_set.py:1336-1359``)
* fixed split seeds (42/90/80, via :mod:`scvae_tpu_torch.data.processing`).

Caching is best-effort as in the JAX package: an ``OSError`` while writing
a cache file is ignored.  Without ``h5py`` the cache raises
``ImportError``, as the JAX package's does.
"""

from __future__ import annotations

import os
import re
from typing import Any, Sequence

import numpy as np
import scipy.sparse

from scvae_tpu_torch.data import internal_io, loading, parsing, processing
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.utils.strings import normalise_string

DEFAULT_EXCLUDED_CLASSES = ["No class"]

DEFAULT_TERMS = {
    "example": "example",
    "feature": "feature",
    "class": "class",
    "type": "value",
    "item": "item",
}


def _map_labels_to_superset_labels(labels, label_superset):
    if not label_superset:
        return None
    if label_superset == "infer":
        superset_labels = [
            re.match("^( ?[A-Za-z])+", str(label)).group() for label in labels
        ]
        return np.array(superset_labels)
    reverse = {v: k for k, vs in label_superset.items() for v in vs}
    return np.array([reverse[label] for label in labels])


class DataSet:
    """Data set container (see module docstring)."""

    def __init__(
        self,
        input_file_or_name: str,
        data_format: str | None = None,
        title: str | None = None,
        specifications: dict[str, Any] | None = None,
        values=None,
        total_standard_deviations=None,
        explained_standard_deviations=None,
        preprocessed_values=None,
        binarised_values=None,
        labels=None,
        class_names=None,
        example_names=None,
        feature_names=None,
        batch_indices=None,
        batch_names=None,
        map_features: bool | None = None,
        feature_selection: Sequence | None = None,
        example_filter: Sequence | None = None,
        preprocessing_methods: Sequence[str] | None = None,
        binarise_values: bool | None = None,
        noisy_preprocessing_methods: Sequence[str] | None = None,
        kind: str = "full",
        version: str = "original",
        directory: str | None = None,
    ):
        super().__init__()

        # --- identity and specification -----------------------------------
        self.name = normalise_string(input_file_or_name)
        self.title = title or input_file_or_name
        if specifications is None:
            try:
                resolved_title, specifications = parsing.parse_input(
                    input_file_or_name
                )
                self.title = title or resolved_title
            except (KeyError, FileNotFoundError):
                specifications = {}
        self.specifications = dict(specifications)

        if data_format == "infer":
            # "infer" means: use the specification's format, or fall back
            # to the file extension captured by parse_input.
            data_format = None
        self.data_format = (
            data_format
            or self.specifications.get("format")
            or get_default("data", "format")
        )
        self.terms = {**DEFAULT_TERMS, **self.specifications.get("terms", {})}
        self.example_type = self.specifications.get("example type", "unknown")
        self.feature_dimensions = self.specifications.get("feature dimensions")
        self.label_superset = self.specifications.get("label superset")
        self.sorted_class_names = self.specifications.get(
            "sorted class names", []
        )
        self.sorted_superset_class_names = self.specifications.get(
            "sorted superset class names", []
        )
        self.excluded_classes = list(
            self.specifications.get("excluded classes", [])
        )
        self.excluded_superset_classes = list(
            self.specifications.get("excluded superset classes", [])
        )

        if directory is None:
            directory = get_default("data", "directory")
        self.directory = directory

        # --- preprocessing options ----------------------------------------
        if map_features is None:
            map_features = get_default("data", "map_features")
        self.map_features = map_features

        feature_selection = (
            list(feature_selection)
            if feature_selection
            else get_default("data", "feature_selection")
        )
        self.feature_selection = feature_selection
        self.feature_selection_method = (
            feature_selection[0] if feature_selection else None
        )
        self.feature_selection_parameters = (
            feature_selection[1:] if len(feature_selection) > 1 else None
        )

        example_filter = (
            list(example_filter)
            if example_filter
            else get_default("data", "example_filter")
        )
        self.example_filter = example_filter
        self.example_filter_method = example_filter[0] if example_filter else None
        self.example_filter_parameters = (
            example_filter[1:] if len(example_filter) > 1 else None
        )

        if preprocessing_methods is None:
            preprocessing_methods = self.specifications.get(
                "preprocessing methods"
            ) or get_default("data", "preprocessing_methods")
        self.preprocessing_methods = list(preprocessing_methods)

        if noisy_preprocessing_methods is None:
            noisy_preprocessing_methods = get_default(
                "data", "noisy_preprocessing_methods"
            )
        self.noisy_preprocessing_methods = list(noisy_preprocessing_methods)

        if binarise_values is None:
            binarise_values = self.data_format == "mnist_binarised"
        self.binarise_values = binarise_values

        self.kind = kind
        self.version = version

        # --- data attributes ----------------------------------------------
        self.values = None
        self.count_sum = None
        self.normalised_count_sum = None
        self.total_standard_deviations = total_standard_deviations
        self.explained_standard_deviations = explained_standard_deviations
        self.preprocessed_values = None
        self.binarised_values = None
        self.labels = None
        self.example_names = None
        self.feature_names = None
        self.batch_indices = None
        self.batch_names = batch_names
        self.number_of_batches = None
        self.class_names = None
        self.number_of_examples = None
        self.number_of_features = None
        self.number_of_classes = None
        self.class_id_to_class_name = {}
        self.class_name_to_class_id = {}
        self.superset_labels = None
        self.superset_class_names = None
        self.number_of_superset_classes = None
        self.superset_class_id_to_superset_class_name = {}
        self.superset_class_name_to_superset_class_id = {}
        self.number_of_excluded_classes = 0
        self.number_of_excluded_superset_classes = 0
        self.feature_mapping = self.specifications.get("feature mapping")
        self.split_indices = self.specifications.get("split indices")
        self.prediction_specifications = None
        self.predicted_cluster_ids = None
        self.predicted_labels = None
        self.predicted_class_names = None
        self.number_of_predicted_classes = None
        self.predicted_superset_labels = None
        self.predicted_superset_class_names = None
        self.number_of_predicted_superset_classes = None

        self.update(
            values=values,
            preprocessed_values=preprocessed_values,
            binarised_values=binarised_values,
            labels=labels,
            class_names=class_names,
            example_names=example_names,
            feature_names=feature_names,
            batch_indices=batch_indices,
        )

    # ------------------------------------------------------------------
    # Derived properties (reference data_set.py:423-520)
    # ------------------------------------------------------------------

    @property
    def number_of_values(self):
        return self.number_of_examples * self.number_of_features

    @property
    def class_probabilities(self):
        class_probabilities = {name: 0 for name in self.class_names}
        total = 0
        for label in self.labels:
            if label in (self.excluded_classes or []):
                continue
            class_probabilities[label] += 1
            total += 1
        zero_names = [n for n, c in class_probabilities.items() if c == 0]
        class_probabilities = {
            n: c / total for n, c in class_probabilities.items()
        }
        for n in zero_names:
            class_probabilities.pop(n)
        return class_probabilities

    @property
    def has_values(self):
        return self.values is not None

    @property
    def has_preprocessed_values(self):
        return self.preprocessed_values is not None

    @property
    def has_binarised_values(self):
        return self.binarised_values is not None

    @property
    def has_labels(self):
        return self.labels is not None

    @property
    def has_superset_labels(self):
        return self.superset_labels is not None

    @property
    def has_batches(self):
        return self.batch_indices is not None

    @property
    def has_predictions(self):
        return self.has_predicted_labels or self.has_predicted_cluster_ids

    @property
    def has_predicted_labels(self):
        return self.predicted_labels is not None

    @property
    def has_predicted_superset_labels(self):
        return self.predicted_superset_labels is not None

    @property
    def has_predicted_cluster_ids(self):
        return self.predicted_cluster_ids is not None

    @property
    def default_feature_parameters(self):
        if not self.feature_selection_method:
            return None
        method = normalise_string(self.feature_selection_method)
        if method == "keep_variances_above":
            return [0.5]
        if method == "keep_highest_variances" and self.number_of_features:
            return [int(self.number_of_features / 2)]
        return None

    @property
    def default_splitting_method(self):
        return "indices" if self.split_indices else "random"

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------

    def update(
        self,
        values=None,
        total_standard_deviations=None,
        explained_standard_deviations=None,
        preprocessed_values=None,
        binarised_values=None,
        labels=None,
        class_names=None,
        example_names=None,
        feature_names=None,
        batch_indices=None,
        batch_names=None,
    ):
        if values is not None:
            self.values = values
            count_sum = np.asarray(values.sum(axis=1)).reshape(-1, 1)
            self.count_sum = count_sum
            with np.errstate(invalid="ignore"):
                max_count_sum = (
                    float(np.nanmax(count_sum)) if count_sum.size else 1.0
                )
                if not np.isfinite(max_count_sum) or max_count_sum <= 0:
                    max_count_sum = 1.0
                self.normalised_count_sum = count_sum / max_count_sum
            n_examples, n_features = values.shape
            if example_names is not None:
                example_names = np.asarray(example_names)
                if example_names.ndim > 1:
                    raise ValueError(
                        "The list of example names is multi-dimensional: "
                        f"{example_names.shape}."
                    )
                if n_examples != example_names.shape[0]:
                    raise ValueError(
                        f"The number of examples ({n_examples}) in the value "
                        "matrix is not the same as the number of example "
                        f"names ({example_names.shape[0]})."
                    )
                self.example_names = example_names
            if feature_names is not None:
                feature_names = np.asarray(feature_names)
                if feature_names.ndim > 1:
                    raise ValueError(
                        "The list of feature names is multi-dimensional: "
                        f"{feature_names.shape}."
                    )
                if n_features != feature_names.shape[0]:
                    raise ValueError(
                        f"The number of features in the value matrix "
                        f"({n_features}) is not the same as the number of "
                        f"feature names ({feature_names.shape[0]})."
                    )
                self.feature_names = feature_names
            self.number_of_examples = n_examples
            self.number_of_features = n_features
        else:
            if example_names is not None:
                self.example_names = np.asarray(example_names)
            if feature_names is not None:
                self.feature_names = np.asarray(feature_names)

        if labels is not None:
            labels = np.asarray(labels)
            if np.issubdtype(labels.dtype, np.floating):
                labels_int = labels.astype(int)
                if (labels == labels_int).all():
                    labels = labels_int
            self.labels = labels
            if class_names is not None:
                self.class_names = list(class_names)
            else:
                self.class_names = np.unique(self.labels).tolist()
            self.class_id_to_class_name = dict(enumerate(self.class_names))
            self.class_name_to_class_id = {
                name: i for i, name in enumerate(self.class_names)
            }
            if not self.excluded_classes:
                for excluded in DEFAULT_EXCLUDED_CLASSES:
                    if excluded in self.class_names:
                        self.excluded_classes.append(excluded)
            self.number_of_classes = len(self.class_names)
            self.number_of_excluded_classes = len(self.excluded_classes or [])

            if self.label_superset:
                self.superset_labels = _map_labels_to_superset_labels(
                    self.labels, self.label_superset
                )
                self.superset_class_names = np.unique(
                    self.superset_labels
                ).tolist()
                self.superset_class_id_to_superset_class_name = dict(
                    enumerate(self.superset_class_names)
                )
                self.superset_class_name_to_superset_class_id = {
                    name: i
                    for i, name in enumerate(self.superset_class_names)
                }
                if not self.excluded_superset_classes:
                    for excluded in DEFAULT_EXCLUDED_CLASSES:
                        if excluded in self.superset_class_names:
                            self.excluded_superset_classes.append(excluded)
                self.number_of_superset_classes = len(
                    self.superset_class_names
                )
                self.number_of_excluded_superset_classes = len(
                    self.excluded_superset_classes or []
                )

        if total_standard_deviations is not None:
            self.total_standard_deviations = total_standard_deviations
        if explained_standard_deviations is not None:
            self.explained_standard_deviations = explained_standard_deviations
        if preprocessed_values is not None:
            self.preprocessed_values = preprocessed_values
        if binarised_values is not None:
            self.binarised_values = binarised_values
        if batch_indices is not None:
            batch_indices = np.asarray(batch_indices).reshape(-1, 1)
            self.batch_indices = batch_indices
            self.number_of_batches = len(np.unique(batch_indices))
        if batch_names is not None:
            self.batch_names = batch_names

    def update_predictions(
        self,
        prediction_specifications=None,
        predicted_cluster_ids=None,
        predicted_labels=None,
        predicted_class_names=None,
        predicted_superset_labels=None,
        predicted_superset_class_names=None,
    ):
        """Attach model/clustering predictions (reference
        ``data_set.py:682-732``)."""
        if prediction_specifications is not None:
            self.prediction_specifications = prediction_specifications
        if predicted_cluster_ids is not None:
            self.predicted_cluster_ids = np.asarray(predicted_cluster_ids)
        if predicted_labels is not None:
            self.predicted_labels = np.asarray(predicted_labels)
            if predicted_class_names is not None:
                self.predicted_class_names = list(predicted_class_names)
            else:
                self.predicted_class_names = np.unique(
                    self.predicted_labels
                ).tolist()
            self.number_of_predicted_classes = len(self.predicted_class_names)
        if predicted_superset_labels is not None:
            self.predicted_superset_labels = np.asarray(
                predicted_superset_labels
            )
            if predicted_superset_class_names is not None:
                self.predicted_superset_class_names = list(
                    predicted_superset_class_names
                )
            else:
                self.predicted_superset_class_names = np.unique(
                    self.predicted_superset_labels
                ).tolist()
            self.number_of_predicted_superset_classes = len(
                self.predicted_superset_class_names
            )

    def reset_predictions(self):
        self.prediction_specifications = None
        self.predicted_cluster_ids = None
        self.predicted_labels = None
        self.predicted_class_names = None
        self.number_of_predicted_classes = None
        self.predicted_superset_labels = None
        self.predicted_superset_class_names = None
        self.number_of_predicted_superset_classes = None

    # ------------------------------------------------------------------
    # Pipeline: load → preprocess → split
    # ------------------------------------------------------------------

    def _cache_directory(self) -> str:
        return os.path.join(self.directory, self.name)

    def _original_cache_path(self) -> str:
        return os.path.join(self._cache_directory(), "original.h5")

    def _preprocessed_cache_path(self) -> str:
        """Property-addressable preprocessed-cache filename
        (reference ``data_set.py:1266-1318``)."""
        parts = []
        if self.map_features:
            parts.append("mapped_features")
        if self.feature_selection_method:
            fs = normalise_string(self.feature_selection_method)
            params = (
                self.feature_selection_parameters
                or self.default_feature_parameters
                or []
            )
            if params:
                fs += "_" + "_".join(map(str, params))
            parts.append(fs)
        if self.example_filter_method:
            ef = normalise_string(self.example_filter_method)
            if self.example_filter_parameters:
                ef += "_" + "_".join(
                    normalise_string(str(p))
                    for p in self.example_filter_parameters
                )
            parts.append(ef)
        if self.preprocessing_methods:
            parts.append("-".join(map(normalise_string, self.preprocessing_methods)))
        name = "preprocessed" + ("-" + "-".join(parts) if parts else "")
        return os.path.join(self._cache_directory(), name + ".h5")

    def load(self) -> "DataSet":
        """Acquire, load, cache, and preprocess the full data set
        (reference ``data_set.py:749-982``)."""
        preprocessed_path = self._preprocessed_cache_path()
        if os.path.exists(preprocessed_path):
            data_dictionary = internal_io.load_data_dictionary(preprocessed_path)
            self._apply_data_dictionary(data_dictionary)
            return self

        original_path = self._original_cache_path()
        if os.path.exists(original_path):
            data_dictionary = internal_io.load_data_dictionary(original_path)
        else:
            urls = self.specifications.get("URLs")
            if urls is not None:
                paths = loading.acquire_data_set(
                    self.title, urls, self._cache_directory()
                )
            elif "values" in self.specifications:
                paths = {
                    "values": {"full": self.specifications["values"]},
                }
                if self.specifications.get("labels"):
                    paths["labels"] = {"full": self.specifications["labels"]}
                if self.specifications.get("feature mapping") and isinstance(
                    self.specifications["feature mapping"], str
                ):
                    paths["feature mapping"] = {
                        "full": self.specifications["feature mapping"]
                    }
            else:
                paths = {}
            data_dictionary = loading.load_original_data_set(
                paths, self.data_format
            )
            try:
                internal_io.save_data_dictionary(
                    data_dictionary, original_path
                )
            except OSError:
                pass  # caching is best-effort

        data_dictionary = self._preprocess_data_dictionary(data_dictionary)
        if data_dictionary.pop("__preprocessing_applied__", False):
            try:
                internal_io.save_data_dictionary(
                    data_dictionary, preprocessed_path
                )
            except OSError:
                pass
        self._apply_data_dictionary(data_dictionary)
        return self

    def _preprocess_data_dictionary(self, data_dictionary):
        """Map features → select features → filter examples → preprocess
        values (reference ``data_set.py:817-982``)."""
        values = data_dictionary["values"]
        example_names = np.asarray(data_dictionary["example names"])
        feature_names = np.asarray(data_dictionary["feature names"])
        labels = data_dictionary.get("labels")
        batch_indices = data_dictionary.get("batch indices")
        feature_mapping = data_dictionary.get("feature mapping") or (
            self.feature_mapping
        )
        applied = False

        if self.map_features and feature_mapping:
            feature_ids = feature_names
            values, feature_names = processing.map_features(
                values, feature_ids, feature_mapping
            )
            applied = True

        values_dictionary = {"original": values}

        if self.feature_selection_method:
            params = (
                self.feature_selection_parameters
                or self.default_feature_parameters
            )
            values_dictionary, feature_names = processing.select_features(
                values_dictionary,
                feature_names,
                method=self.feature_selection_method,
                parameters=params,
            )
            applied = True

        if self.example_filter_method:
            superset_labels = (
                _map_labels_to_superset_labels(labels, self.label_superset)
                if (labels is not None and self.label_superset)
                else None
            )
            count_sum = np.asarray(
                values_dictionary["original"].sum(axis=1)
            ).reshape(-1)
            (
                values_dictionary,
                example_names,
                labels,
                batch_indices,
            ) = processing.filter_examples(
                values_dictionary,
                example_names,
                method=self.example_filter_method,
                parameters=self.example_filter_parameters,
                labels=labels,
                excluded_classes=self.excluded_classes,
                superset_labels=superset_labels,
                excluded_superset_classes=self.excluded_superset_classes,
                batch_indices=batch_indices,
                count_sum=count_sum,
            )
            applied = True

        values = values_dictionary["original"]
        preprocessed_values = None
        if self.preprocessing_methods:
            preprocess = processing.build_preprocessor(
                self.preprocessing_methods
            )
            preprocessed_values = preprocess(values.copy())
            applied = True

        out = dict(data_dictionary)
        out.update(
            {
                "values": values,
                "preprocessed values": preprocessed_values,
                "labels": labels,
                "example names": example_names,
                "feature names": feature_names,
                "batch indices": batch_indices,
                "__preprocessing_applied__": applied,
            }
        )
        return out

    def _apply_data_dictionary(self, data_dictionary):
        if data_dictionary.get("feature mapping") is not None:
            self.feature_mapping = data_dictionary["feature mapping"]
        if data_dictionary.get("split indices") is not None:
            self.split_indices = data_dictionary["split indices"]
        self.update(
            values=data_dictionary.get("values"),
            preprocessed_values=data_dictionary.get("preprocessed values"),
            binarised_values=data_dictionary.get("binarised values"),
            labels=data_dictionary.get("labels"),
            example_names=data_dictionary.get("example names"),
            feature_names=data_dictionary.get("feature names"),
            batch_indices=data_dictionary.get("batch indices"),
        )
        if self.binarise_values and self.binarised_values is None:
            self.binarise()

    def binarise(self):
        """Binarised copy of the (preprocessed) values
        (reference ``data_set.py:984-1048``)."""
        if self.values is None:
            raise RuntimeError("Data set not loaded.")
        source = (
            self.preprocessed_values
            if self.preprocessed_values is not None
            else self.values
        )
        binarise = processing.build_preprocessor(["binarise"])
        self.binarised_values = binarise(source.copy())

    def split(
        self, method: str | None = None, fraction: float | None = None
    ) -> tuple["DataSet", "DataSet", "DataSet"]:
        """Split into training/validation/test ``DataSet`` views
        (reference ``data_set.py:1050-1243``)."""
        if self.values is None:
            self.load()
        if method is None or method == "default":
            method = (
                self.specifications.get("splitting method")
                or self.default_splitting_method
            )
        if fraction is None:
            fraction = get_default("data", "splitting_fraction")

        data_dictionary = {
            "values": self.values,
            "preprocessed values": self.preprocessed_values,
            "binarised values": self.binarised_values,
            "labels": self.labels,
            "example names": self.example_names,
            "feature names": self.feature_names,
            "batch indices": self.batch_indices,
            "class names": self.class_names,
        }
        if self.split_indices:
            data_dictionary["split indices"] = self.split_indices
        split = processing.split_data_set(
            data_dictionary, method=method, fraction=fraction
        )

        subsets = []
        for kind in ("training", "validation", "test"):
            piece = split[f"{kind} set"]
            subset = DataSet(
                self.name,
                title=self.title,
                specifications=self.specifications,
                data_format=self.data_format,
                directory=self.directory,
                values=piece["values"],
                preprocessed_values=piece["preprocessed values"],
                binarised_values=piece["binarised values"],
                labels=piece["labels"],
                class_names=self.class_names,
                example_names=piece["example names"],
                feature_names=split["feature names"],
                batch_indices=piece["batch indices"],
                map_features=self.map_features,
                feature_selection=self.feature_selection,
                example_filter=self.example_filter,
                preprocessing_methods=self.preprocessing_methods,
                noisy_preprocessing_methods=self.noisy_preprocessing_methods,
                binarise_values=self.binarise_values,
                kind=kind,
                version=self.version,
            )
            subsets.append(subset)
        return tuple(subsets)

    def clear(self):
        """Release the value matrices (reference ``data_set.py:1245-1264``)."""
        self.values = None
        self.count_sum = None
        self.normalised_count_sum = None
        self.preprocessed_values = None
        self.binarised_values = None
        self.total_standard_deviations = None
        self.explained_standard_deviations = None

    def __repr__(self):
        return (
            f"DataSet(name={self.name!r}, kind={self.kind!r}, "
            f"version={self.version!r}, "
            f"examples={self.number_of_examples}, "
            f"features={self.number_of_features})"
        )
