"""Reusable sub-analyses: distributions, matrices, decompositions,
centroid probabilities, predictions (the port of
``scvae_tpu/analyses/subanalyses.py``, the reference's
``scvae/analyses/subanalyses.py``), with the same entry points.  The
decompositions and distances run on a device (CUDA unless ``"cpu"``); the
figures are drawn on the host by ``figures.py``, which needs matplotlib.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

from scvae_tpu_torch.analyses.decomposition import decompose
from scvae_tpu_torch.data.utilities import save_values
from scvae_tpu_torch.utils.device import float64_tensor, resolve_device
from scvae_tpu_torch.utils.strings import normalise_string


def import_figures(analysis: str):
    """The figures module, imported where an analysis draws; without
    matplotlib or seaborn an ``ImportError`` that names the analysis."""
    try:
        from scvae_tpu_torch.analyses import figures
    except ImportError as error:
        raise ImportError(
            f"the {analysis} analysis draws figures, which need matplotlib "
            f"and seaborn: {error}") from error
    return figures


def analyse_distributions(
    data_set,
    cutoffs: Sequence[int] = (10,),
    analysis_level: str = "normal",
    export_options=None,
    analyses_directory: str = ".",
) -> list[str]:
    """Count histograms, class histograms, count-sum distribution
    (reference ``subanalyses.py:50-291``)."""
    figures = import_figures("distributions")
    os.makedirs(analyses_directory, exist_ok=True)
    saved = []
    if data_set.has_values:
        for cutoff in cutoffs:
            saved.append(
                figures.plot_cutoff_count_histogram(
                    data_set.values,
                    cutoff=cutoff,
                    name=f"count_histogram-cutoff_{cutoff}-{data_set.kind}",
                    directory=analyses_directory,
                )
            )
        saved.append(
            figures.plot_histogram(
                np.asarray(data_set.count_sum),
                name=f"count_sum-{data_set.kind}",
                directory=analyses_directory,
                label="total counts per cell",
            )
        )
    if data_set.has_labels:
        saved.append(
            figures.plot_class_histogram(
                data_set.labels,
                class_names=data_set.class_names,
                name=f"class_histogram-{data_set.kind}",
                directory=analyses_directory,
            )
        )
        if data_set.has_superset_labels:
            saved.append(
                figures.plot_class_histogram(
                    data_set.superset_labels,
                    class_names=data_set.superset_class_names,
                    name=f"superset_class_histogram-{data_set.kind}",
                    directory=analyses_directory,
                )
            )
    return saved


def pairwise_distances(values, device=None) -> np.ndarray:
    """The Euclidean distances between the rows of ``values`` (float64,
    by ``torch.cdist`` on ``device``), the diagonal 0 as scikit-learn's
    ``pairwise_distances`` of a set to itself gives it."""
    dense = float64_tensor(values, resolve_device(device))
    return torch.cdist(dense, dense).fill_diagonal_(0.0).cpu().numpy()


def analyse_matrices(
    data_set,
    plot_distances: bool = False,
    name: list[str] | None = None,
    analyses_directory: str = ".",
    device=None,
) -> list[str]:
    """Value (and pairwise-distance) heat maps sorted by labels
    (reference ``subanalyses.py:294-468``); the Euclidean distances of the
    first 1,000 examples by ``torch.cdist`` in float64 on ``device``."""
    figures = import_figures("distances" if plot_distances else "heat_maps")
    os.makedirs(analyses_directory, exist_ok=True)
    saved = []
    suffix = "-".join(name) if name else data_set.kind
    n_plot = min(data_set.number_of_examples, 1000)
    values = data_set.values[:n_plot]
    labels = data_set.labels[:n_plot] if data_set.has_labels else None
    saved.append(
        figures.plot_heat_map(
            values,
            labels=labels,
            name=f"heat_map-{suffix}",
            directory=analyses_directory,
        )
    )
    if plot_distances:
        distances = pairwise_distances(values, device)
        saved.append(
            figures.plot_heat_map(
                distances,
                labels=labels,
                name=f"distances-{suffix}",
                directory=analyses_directory,
                x_label="example",
                y_label="example",
                z_label="distance",
            )
        )
    return saved


def analyse_decompositions(
    data_sets,
    other_data_sets: Sequence | None = None,
    centroids: dict | None = None,
    colouring_data_set=None,
    decomposition_methods: Sequence[str] | None = None,
    number_of_components: int = 2,
    title: str = "data set",
    specifier=None,
    analysis_level: str = "normal",
    export_options=None,
    analyses_directory: str = ".",
    device=None,
) -> list[str]:
    """Scatter grid over data sets × decomposition methods with optional
    centroid projection and TSV export (reference ``subanalyses.py:471-1066``);
    the decompositions on ``device``."""
    figures = import_figures("decompositions")
    if not isinstance(data_sets, (list, tuple)):
        data_sets = [data_sets]
    if decomposition_methods is None:
        decomposition_methods = ["PCA"]
    os.makedirs(analyses_directory, exist_ok=True)
    saved = []
    for data_set in data_sets:
        if not data_set.has_values:
            continue
        colour_set = colouring_data_set or data_set
        # Centroids live in z-space: only project them onto decompositions
        # of z-space values (reference subanalyses.py:514).
        set_centroids = (
            centroids if getattr(data_set, "version", None) == "z" else None
        )
        for method in decomposition_methods:
            try:
                if set_centroids and method == "PCA":
                    decomposed, centroids_decomposed = decompose(
                        data_set.values,
                        centroids=set_centroids,
                        method=method,
                        number_of_components=number_of_components,
                        device=device,
                    )
                else:
                    decomposed = decompose(
                        data_set.values,
                        method=method,
                        number_of_components=number_of_components,
                        device=device,
                    )
                    centroids_decomposed = None
            except Exception as error:
                print(f"Decomposition {method} failed: {error}")
                continue
            plot_name = "{}-{}-{}".format(
                normalise_string(method), data_set.kind, data_set.version
            )
            saved.append(
                figures.plot_values(
                    decomposed,
                    colour_coding=(
                        colour_set.labels if colour_set.has_labels else None
                    ),
                    centroids=(
                        centroids_decomposed.get("prior")
                        if isinstance(centroids_decomposed, dict)
                        and "prior" in centroids_decomposed
                        else centroids_decomposed
                    ),
                    name=plot_name,
                    directory=analyses_directory,
                    axis_labels=(
                        f"{method} component 1",
                        f"{method} component 2",
                    ),
                )
            )
            if export_options and "decomposition" in export_options:
                save_values(
                    decomposed,
                    name=plot_name,
                    row_names=data_set.example_names,
                    directory=analyses_directory,
                )
    return saved


def analyse_centroid_probabilities(
    centroids: dict,
    name: str | None = None,
    analysis_level: str = "normal",
    export_options=None,
    analyses_directory: str = ".",
) -> list[str]:
    """Mixture-probability evolution/bar plots (reference
    ``subanalyses.py:1068-1142``)."""
    figures = import_figures("centroid probabilities")
    os.makedirs(analyses_directory, exist_ok=True)
    saved = []
    snapshots: dict[str, np.ndarray] = {}
    for distribution, dist_centroids in (centroids or {}).items():
        if not dist_centroids:
            continue
        probabilities = dist_centroids.get("probabilities")
        if probabilities is None:
            continue
        probabilities = np.asarray(probabilities)
        if probabilities.ndim == 1:
            snapshots[distribution] = probabilities
            continue
        snapshots[distribution] = probabilities[-1]
        plot_name = "centroid_probabilities-{}{}".format(
            distribution, f"-{name}" if name else ""
        )
        saved.append(
            figures.plot_centroid_probabilities_evolution(
                probabilities,
                name=plot_name,
                directory=analyses_directory,
            )
        )
    if snapshots:
        # Posterior-vs-prior bar chart of the (final) mixture probabilities
        # (reference subanalyses.py:1068-1142 via plot_probabilities).
        parts = [k for k in ("posterior", "prior") if k in snapshots]
        plot_name = "probabilities-" + "-".join(parts)
        if name:
            plot_name = f"{name}-{plot_name}"
        saved.append(
            figures.plot_probabilities(
                snapshots.get("posterior"),
                snapshots.get("prior"),
                name=plot_name,
                directory=analyses_directory,
            )
        )
    return saved


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
