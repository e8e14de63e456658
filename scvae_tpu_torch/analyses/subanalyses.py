"""Reusable sub-analyses: the ported part of
``scvae_tpu/analyses/subanalyses.py`` (the reference's
``scvae/analyses/subanalyses.py``), the prediction export.  The figure
sub-analyses are not ported yet."""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from scvae_tpu_torch.data.utilities import save_values


def analyse_predictions(
    evaluation_set,
    analyses_directory: str = ".",
    export_options=None,
) -> list[str]:
    """Prediction exports: cluster-id / predicted-label TSVs
    (reference ``subanalyses.py:1145-1198``)."""
    os.makedirs(analyses_directory, exist_ok=True)
    saved = []
    columns: dict[str, Any] = {}
    if evaluation_set.has_predicted_cluster_ids:
        columns["cluster_id"] = np.asarray(
            evaluation_set.predicted_cluster_ids
        ).reshape(-1)
    if evaluation_set.has_predicted_labels:
        columns["predicted_label"] = np.asarray(
            evaluation_set.predicted_labels
        )
    if evaluation_set.has_predicted_superset_labels:
        columns["predicted_superset_label"] = np.asarray(
            evaluation_set.predicted_superset_labels
        )
    if not columns:
        return saved
    matrix = np.column_stack([columns[k].astype(str) for k in columns])
    path = save_values(
        matrix,
        name=f"predictions-{evaluation_set.kind}",
        row_names=evaluation_set.example_names,
        column_names=list(columns),
        directory=analyses_directory,
    )
    saved.append(path)
    return saved
