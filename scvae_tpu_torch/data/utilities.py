"""Data-layer utilities: run-directory naming, the stratified evaluation
subset, and TSV export.

The port's copy of ``scvae_tpu/data/utilities.py`` (the counterpart of
``scvae/data/utilities.py``) with the same fixed seed (80) for the
evaluation subset so subset choices match the reference.  ``save_values``
imports ``pandas`` when it is called.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import scipy.sparse

from scvae_tpu_torch.utils.strings import normalise_string

EVALUATION_SUBSET_SEED = 80  # reference data/utilities.py:157


def build_directory_path(
    base_directory: str,
    data_set,
    splitting_method: str | None = None,
    splitting_fraction: float | None = None,
    preprocessing: bool = True,
) -> str:
    """Hierarchical cache/run directory mirroring the reference's
    property-addressable scheme (``data/utilities.py:68-142``):
    ``<base>/<data set>/<preprocessing…>/<split…>``."""
    pieces = [base_directory, normalise_string(data_set.name)]

    if preprocessing:
        preprocessing_parts = []
        if getattr(data_set, "map_features", False):
            preprocessing_parts.append("mapped_features")
        if getattr(data_set, "feature_selection", None):
            fs = [normalise_string(str(p)) for p in data_set.feature_selection]
            preprocessing_parts.append("-".join(fs))
        if getattr(data_set, "example_filter", None):
            ef = [normalise_string(str(p)) for p in data_set.example_filter]
            preprocessing_parts.append("-".join(ef))
        if getattr(data_set, "preprocessing_methods", None):
            preprocessing_parts.append(
                "-".join(map(normalise_string, data_set.preprocessing_methods))
            )
        if preprocessing_parts:
            pieces.append("-".join(preprocessing_parts))
        else:
            pieces.append("no_preprocessing")

    if splitting_method:
        if splitting_method == "default":
            splitting_method = getattr(
                data_set, "default_splitting_method", splitting_method
            )
        split_part = normalise_string(splitting_method)
        if splitting_method != "indices" and splitting_fraction is not None:
            split_part += "_{}".format(splitting_fraction)
        pieces.append("split-" + split_part)

    return os.path.join(*pieces)


def indices_for_evaluation_subset(
    evaluation_set,
    maximum_number_of_examples_per_class: int = 3,
    total_maximum_number_of_examples: int = 25,
) -> np.ndarray:
    """Stratified subset (≤3/class, ≤25 total; seeded) used for
    reconstruction-stddev evaluation (reference ``data/utilities.py:145-181``)."""
    random_state = np.random.RandomState(EVALUATION_SUBSET_SEED)

    if getattr(evaluation_set, "has_labels", False):
        if getattr(evaluation_set, "label_superset", None) is not None:
            class_names = evaluation_set.superset_class_names
            labels = evaluation_set.superset_labels
        else:
            class_names = evaluation_set.class_names
            labels = evaluation_set.labels
        subset = set()
        for class_name in class_names:
            class_label_indices = np.argwhere(labels == class_name).flatten()
            random_state.shuffle(class_label_indices)
            subset.update(
                class_label_indices[:maximum_number_of_examples_per_class]
            )
        subset = np.array(sorted(subset))
    else:
        n = evaluation_set.number_of_examples
        subset = random_state.permutation(n)[
            :total_maximum_number_of_examples
        ]
        subset = np.sort(subset)

    if len(subset) > total_maximum_number_of_examples:
        subset = random_state.permutation(np.asarray(list(subset)))[
            :total_maximum_number_of_examples
        ]
        subset = np.sort(subset)

    return np.asarray(subset)


def save_values(
    values,
    name: str,
    row_names: Sequence | None = None,
    column_names: Sequence | None = None,
    directory: str | None = None,
) -> str:
    """TSV export (reference ``data/utilities.py:184-197``)."""
    import pandas as pd

    directory = directory or "."
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, normalise_string(name) + ".tsv.gz")
    if scipy.sparse.issparse(values):
        values = np.asarray(values.todense())
    frame = pd.DataFrame(values, index=row_names, columns=column_names)
    frame.to_csv(
        path,
        sep="\t",
        index=row_names is not None,
        header=column_names is not None,
        compression="gzip",
    )
    return path
