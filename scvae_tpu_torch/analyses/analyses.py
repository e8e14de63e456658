"""Analysis orchestrators (the port of ``scvae_tpu/analyses/analyses.py``,
the reference's ``scvae/analyses/analyses.py``): the analysis groups
(``simple`` ⊂ ``standard`` ⊂ ``all``), data-set analyses, model analyses
(learning curves from the run's curves), intermediate per-epoch latent
plots, and result analyses with the metric and prediction logs and pickles
that cross-analysis reads (``<kind>-metrics.log`` / ``.pkl.gz``,
``<kind>-prediction-<name>.log`` / ``.pkl.gz``), in the JAX package's
layout and file names.

Statistics, metrics, decompositions (PCA, SVD, ICA, t-SNE) and distances
run on a device (CUDA unless ``device="cpu"``); figures are drawn on the
host by ``figures.py``, imported only where an analysis draws: without
matplotlib such an analysis raises ``ImportError`` naming it, while the
metrics, predictions and latent values need none.  One difference from the
JAX package: there the latent values' TSV is written only with the
"latent_space" figures; here "latent_values" writes it too.
"""

from __future__ import annotations

import gzip
import os
import pickle
import time
from typing import Any, Sequence

import numpy as np
import scipy.sparse

from scvae_tpu_torch.analyses import metrics, subanalyses
from scvae_tpu_torch.analyses.decomposition import decompose
from scvae_tpu_torch.analyses.subanalyses import import_figures
from scvae_tpu_torch.data.utilities import save_values
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import checkpoints
from scvae_tpu_torch.utils.device import resolve_device
from scvae_tpu_torch.utils.strings import (
    capitalise_string,
    format_time,
    normalise_string,
)

ANALYSIS_GROUPS: dict[str, list[str]] = {
    "simple": [
        "metrics",
        "images",
        "learning_curves",
        "latent_values",
        "predictions",
    ],
    "standard": [
        "profile_comparisons",
        "distributions",
        "decompositions",
        "latent_space",
    ],
    "all": [
        "heat_maps",
        "distances",
        "feature_value_standard_deviations",
        "latent_distributions",
        "latent_correlations",
        "latent_features",
        "kl_heat_maps",
        "accuracies",
    ],
}
ANALYSIS_GROUPS["standard"] = (
    ANALYSIS_GROUPS["simple"] + ANALYSIS_GROUPS["standard"]
)
ANALYSIS_GROUPS["all"] = ANALYSIS_GROUPS["standard"] + ANALYSIS_GROUPS["all"]

def _resolve_included(included_analyses) -> list[str]:
    if included_analyses is None:
        included_analyses = get_default("analyses", "included_analyses")
    if isinstance(included_analyses, str):
        included_analyses = [included_analyses]
    resolved: list[str] = []
    for item in included_analyses:
        if item in ANALYSIS_GROUPS:
            resolved.extend(ANALYSIS_GROUPS[item])
        elif item in ANALYSIS_GROUPS["all"]:
            resolved.append(item)
        else:
            # Unknown kinds raise instead of silently no-opping.
            raise ValueError(
                f"Unknown analysis {item!r}; expected a group "
                f"({'/'.join(ANALYSIS_GROUPS)}) or one of: "
                + ", ".join(ANALYSIS_GROUPS["all"])
            )
    return resolved


def _subdirectory(base: str, *parts: str) -> str:
    path = os.path.join(base, *parts)
    os.makedirs(path, exist_ok=True)
    return path


def _model_analyses_path(
    base: str,
    model_name: str,
    run_id: str | None = None,
    subdirectories: Sequence[str] = (),
) -> str:
    """``<base>/<model name (hierarchical)>[/run_<id>]/<subdirs…>``
    (reference ``analyses.py:1609-1630``)."""
    path = os.path.join(base, model_name)
    if run_id:
        path = os.path.join(path, f"run_{run_id}")
    return _subdirectory(path, *subdirectories)


# --------------------------------------------------------------------------
# Data analyses (reference analyses.py:60-301)
# --------------------------------------------------------------------------


def analyse_data(
    data_sets: Sequence,
    decomposition_methods: Sequence[str] | None = None,
    highlight_feature_indices=None,
    included_analyses=None,
    analysis_level: str | None = None,
    export_options=None,
    analyses_directory: str | None = None,
    device=None,
) -> dict[str, Any]:
    """Summary statistics, class/count histograms, and decomposition
    scatters for one or more data subsets; statistics, decompositions and
    distances on ``device``."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    if decomposition_methods is None:
        decomposition_methods = [
            get_default("analyses", "decomposition_method")
        ]
    included = _resolve_included(included_analyses)
    device = resolve_device(device)
    if not isinstance(data_sets, (list, tuple)):
        data_sets = [data_sets]

    directory = _subdirectory(analyses_directory, "data")
    results: dict[str, Any] = {"statistics": [], "figures": []}

    if "metrics" in included:
        stats = [
            metrics.summary_statistics(
                ds.values, name=f"{ds.kind} set", tolerance=0.5, device=device
            )
            for ds in data_sets
            if ds.has_values
        ]
        results["statistics"] = stats
        table = metrics.format_summary_statistics(stats)
        print(table)
        with open(os.path.join(directory, "statistics.log"), "w") as f:
            f.write(table + "\n")

    for data_set in data_sets:
        if not data_set.has_values:
            continue
        set_directory = _subdirectory(directory, data_set.kind)

        if "distributions" in included:
            figures = import_figures("distributions")
            results["figures"].append(
                figures.plot_cutoff_count_histogram(
                    data_set.values,
                    name=f"count_histogram-{data_set.kind}",
                    directory=set_directory,
                )
            )
            if data_set.has_labels:
                results["figures"].append(
                    figures.plot_class_histogram(
                        data_set.labels,
                        class_names=data_set.class_names,
                        name=f"class_histogram-{data_set.kind}",
                        directory=set_directory,
                    )
                )
            results["figures"].append(
                figures.plot_histogram(
                    np.asarray(data_set.count_sum),
                    name=f"count_sum-{data_set.kind}",
                    directory=set_directory,
                    label="total counts per cell",
                )
            )

        if "distributions" in included and data_set.example_type == "images":
            results["figures"].append(
                figures.combine_images_from_data_set(
                    data_set,
                    name=f"image_examples-{data_set.kind}",
                    directory=set_directory,
                )
            )

        if "decompositions" in included:
            figures = import_figures("decompositions")
            for method in decomposition_methods:
                if method.lower() in ("none",):
                    continue
                try:
                    decomposed = decompose(
                        data_set.values, method=method, number_of_components=2,
                        device=device,
                    )
                except Exception as error:  # t-SNE on tiny sets etc.
                    print(f"Decomposition {method} failed: {error}")
                    continue
                results["figures"].append(
                    figures.plot_values(
                        decomposed,
                        colour_coding=(
                            data_set.labels if data_set.has_labels else None
                        ),
                        name=f"{normalise_string(method)}-{data_set.kind}",
                        directory=set_directory,
                        axis_labels=(
                            f"{method} component 1",
                            f"{method} component 2",
                        ),
                    )
                )
                if export_options and "decomposition" in export_options:
                    save_values(
                        decomposed,
                        name=f"{normalise_string(method)}-{data_set.kind}",
                        row_names=data_set.example_names,
                        directory=set_directory,
                    )

        if "heat_maps" in included:
            results["figures"].extend(
                subanalyses.analyse_matrices(
                    data_set,
                    name=[data_set.kind],
                    analyses_directory=set_directory,
                    device=device,
                )
            )

        if "distances" in included:
            results["figures"].extend(
                subanalyses.analyse_matrices(
                    data_set,
                    plot_distances=True,
                    name=[data_set.kind],
                    analyses_directory=set_directory,
                    device=device,
                )
            )

        if "feature_value_standard_deviations" in included:
            # Sorted series + distribution of per-gene standard deviations
            # (reference analyses.py:224-301).
            figures = import_figures("feature_value_standard_deviations")
            std_directory = _subdirectory(
                set_directory, "feature_value_standard_deviations"
            )
            values = data_set.values
            if scipy.sparse.issparse(values):
                mean = np.asarray(values.mean(axis=0)).squeeze()
                mean_sq = np.asarray(
                    values.multiply(values).mean(axis=0)
                ).squeeze()
                stds = np.sqrt(np.maximum(mean_sq - mean**2, 0.0))
            else:
                stds = np.asarray(values).std(axis=0).squeeze()
            results["figures"].append(
                figures.plot_series(
                    stds,
                    x_label="genes",
                    y_label="value standard deviations",
                    sort=True,
                    scale="log",
                    name=(
                        "feature_value_standard_deviations-"
                        f"{data_set.kind}"
                    ),
                    directory=std_directory,
                )
            )
            results["figures"].append(
                figures.plot_histogram(
                    stds,
                    name=(
                        "feature_value_standard_deviations_histogram-"
                        f"{data_set.kind}"
                    ),
                    directory=std_directory,
                    label="gene value standard deviations",
                )
            )

    return results


# --------------------------------------------------------------------------
# Model analyses (reference analyses.py:304-569)
# --------------------------------------------------------------------------


def analyse_model(
    model,
    run_id: str | None = None,
    included_analyses=None,
    analysis_level: str | None = None,
    export_options=None,
    analyses_directory: str | None = None,
    device=None,
) -> dict[str, Any]:
    """Learning-curve (and KL/accuracy evolution) plots from the run's
    persisted curves; the centroid means' PCA on ``device``."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    included = _resolve_included(included_analyses)
    number_of_epochs_trained = model.number_of_epochs_trained(run_id=run_id)
    directory = _model_analyses_path(
        analyses_directory,
        model.name,
        run_id,
        [f"e_{number_of_epochs_trained}"],
    )
    results: dict[str, Any] = {"figures": []}

    checkpoints.wait_for_pending_writes()
    curves = checkpoints.load_learning_curves(
        model.log_directory(run_id=run_id)
    )
    if curves and "learning_curves" in included:
        figures = import_figures("learning_curves")
        results["figures"].append(
            figures.plot_learning_curves(
                curves, model_type=model.type, directory=directory
            )
        )
        # Separate per-loss-set overlays (reference analyses.py:373-392).
        loss_sets: list = [["lower_bound", "reconstruction_error"]]
        if model.type == "GMVAE":
            loss_sets.append("kl_divergence_z")
            loss_sets.append("kl_divergence_y")
        else:
            loss_sets.append("kl_divergence")
        for loss_set in loss_sets:
            results["figures"].append(
                figures.plot_separate_learning_curves(
                    curves, loss=loss_set, directory=directory
                )
            )
        for kind, kind_curves in curves.items():
            if "accuracy" in kind_curves and "accuracies" in included:
                figures = import_figures("accuracies")
                results["figures"].append(
                    figures.plot_accuracy_evolution(
                        {kind: kind_curves["accuracy"]},
                        name=f"accuracy_evolution-{kind}",
                        directory=directory,
                    )
                )
    results["learning_curves"] = curves

    # KL-divergence evolution heat map: per-latent-dimension KL over epochs
    # (reference analyses.py:446-471 via ``load_kl_divergences``; here the
    # vectors come from the run's array-series store).
    if "kl_heat_maps" in included and "VAE" in model.type:
        log_dir = model.log_directory(run_id=run_id)
        kl_neurons = None
        for kind in ("validation", "training"):
            kl_neurons = checkpoints.load_array_series(
                log_dir, f"kl_divergence_neurons-{kind}"
            )
            if kl_neurons is not None:
                break
        if kl_neurons is not None and kl_neurons.ndim == 2:
            figures = import_figures("kl_heat_maps")
            results["figures"].append(
                figures.plot_kl_divergence_evolution(
                    np.sort(kl_neurons, axis=1),
                    directory=directory,
                )
            )
            results["kl_divergences"] = kl_neurons

    # GMVAE centroid evolution (probabilities + PCA-projected mean paths +
    # generalised-variance evolution; reference analyses.py:473-569)
    centroid_history = checkpoints.load_centroids(
        model.log_directory(run_id=run_id)
    )
    wants_centroids = (
        "learning_curves" in included or "latent_distributions" in included
    )
    if centroid_history is not None and wants_centroids:
        figures = import_figures("centroid evolution")
        centroids_directory = _subdirectory(directory, "centroids_evolution")
        results["figures"].append(
            figures.plot_centroid_probabilities_evolution(
                centroid_history["probabilities"],
                directory=centroids_directory,
            )
        )
        results["figures"].append(
            figures.plot_centroid_means_evolution(
                centroid_history["means"],
                directory=centroids_directory,
                device=device,
            )
        )
        covariances = centroid_history.get("covariance_matrices")
        if covariances is not None and np.asarray(covariances).ndim == 4:
            results["figures"].append(
                figures.plot_centroid_covariance_evolution(
                    covariances,
                    directory=centroids_directory,
                )
            )
    results["centroids"] = centroid_history
    return results


# --------------------------------------------------------------------------
# Intermediate analyses (reference analyses.py:572-747)
# --------------------------------------------------------------------------


def analyse_intermediate_results(
    epoch: int,
    learning_curves: dict | None = None,
    epoch_start=None,
    model_type: str = "VAE",
    latent_values=None,
    data_set=None,
    centroids: dict | None = None,
    model_name: str = "model",
    run_id: str | None = None,
    analyses_directory: str | None = None,
    device=None,
) -> list[str]:
    """Latent scatter (+ centroids) and curves at a training epoch; the PCA
    on ``device``."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    figures = import_figures("intermediate")
    directory = _model_analyses_path(
        analyses_directory,
        model_name,
        run_id,
        ["intermediate", f"epoch_{epoch + 1}"],
    )
    saved = []
    if learning_curves:
        saved.append(
            figures.plot_learning_curves(
                learning_curves, model_type=model_type, directory=directory
            )
        )
    if latent_values is not None:
        values = np.asarray(latent_values)
        if values.shape[1] == 2:
            decomposed = values
            centroids_decomposed = centroids
            labels = ("latent dimension 1", "latent dimension 2")
        else:
            if centroids:
                decomposed, centroids_decomposed = decompose(
                    values, centroids=centroids, method="PCA",
                    number_of_components=2, device=device,
                )
            else:
                decomposed = decompose(
                    values, method="PCA", number_of_components=2,
                    device=device,
                )
                centroids_decomposed = None
            labels = ("PC 1", "PC 2")
        # the labels of the rows analysed: the training callback hands over
        # the first 2,000 rows' latent values (the JAX package colours them
        # with every row's labels and fails on a larger labelled set)
        saved.append(
            figures.plot_values(
                decomposed,
                colour_coding=(
                    data_set.labels[:values.shape[0]]
                    if data_set is not None and data_set.has_labels
                    else None
                ),
                centroids=centroids_decomposed,
                name="latent_space",
                directory=directory,
                axis_labels=labels,
            )
        )
    return saved


# --------------------------------------------------------------------------
# Result analyses (reference analyses.py:750-1607)
# --------------------------------------------------------------------------


def _write_pickle(path: str, value: Any) -> None:
    with gzip.open(path, "w") as f:
        pickle.dump(value, f)



def analyse_results(
    evaluation_set,
    reconstructed_evaluation_set,
    latent_evaluation_sets: dict | None,
    model,
    run_id: str | None = None,
    decomposition_methods: Sequence[str] | None = None,
    evaluation_subset_indices=None,
    highlight_feature_indices=None,
    best_model: bool = False,
    early_stopping: bool = False,
    included_analyses=None,
    analysis_level: str | None = None,
    export_options=None,
    analyses_directory: str | None = None,
    seed=None,
    device=None,
) -> dict[str, Any]:
    """Metrics logs + pickles, reconstruction statistics, latent scatters,
    profile comparisons, heat maps; ``seed`` for the silhouette's sample
    above 20,000 examples; metrics, decompositions and distances on
    ``device``."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    if analysis_level is None:
        analysis_level = get_default("analyses", "analysis_level")
    if decomposition_methods is None:
        decomposition_methods = [
            get_default("analyses", "decomposition_method")
        ]
    included = _resolve_included(included_analyses)
    device = resolve_device(device)

    version = "end_of_training"
    if best_model:
        version = "best_model"
    elif early_stopping:
        version = "early_stopping"
    number_of_epochs_trained = model.number_of_epochs_trained(
        run_id=run_id, early_stopping=early_stopping, best_model=best_model
    )
    # Version directory encodes epochs + version + evaluation sample counts
    # (reference analyses.py:805-817), so re-evaluations after further
    # training land in distinct directories and cross-analysis can pick the
    # longest-trained variant per version.
    evaluation_directory_parts = [f"e_{number_of_epochs_trained}"]
    if version != "end_of_training":
        evaluation_directory_parts.append(version)
    evaluation_directory_parts.append(
        "mc_{}".format(model.number_of_monte_carlo_samples["evaluation"])
    )
    evaluation_directory_parts.append(
        "iw_{}".format(model.number_of_importance_samples["evaluation"])
    )
    subdirectories = ["-".join(evaluation_directory_parts)]
    if evaluation_set.kind != "test":
        subdirectories.append(evaluation_set.kind)
    directory = _model_analyses_path(
        analyses_directory, model.name, run_id, subdirectories
    )

    results: dict[str, Any] = {"figures": [], "directory": directory}

    if "metrics" in included:
        results.update(_metric_files(
            evaluation_set, reconstructed_evaluation_set, model,
            number_of_epochs_trained, directory, seed, device))

    # Latest GMVAE prior/posterior centroid snapshot for latent-space
    # projections (reference loads these from event files,
    # analyses.py:1388-1400).
    centroids = None
    if "gaussian mixture" in model.latent_distribution_name:
        centroid_history = checkpoints.load_centroids(
            model.log_directory(run_id=run_id)
        )
        if centroid_history is not None:
            centroids = {
                "prior": {
                    key: np.asarray(value[-1])
                    for key, value in centroid_history.items()
                }
            }

    # latent space scatters
    if (
        "latent_space" in included
        and latent_evaluation_sets
        and "z" in latent_evaluation_sets
    ):
        figures = import_figures("latent_space")
        latent_set = latent_evaluation_sets["z"]
        values = np.asarray(latent_set.values)
        centroids_decomposed = centroids
        if values.shape[1] == 2:
            decomposed = values
            axis_labels = ("z1", "z2")
        else:
            if centroids:
                decomposed, centroids_decomposed = decompose(
                    values, centroids=centroids, method="PCA",
                    number_of_components=2, device=device,
                )
            else:
                decomposed = decompose(
                    values, method="PCA", number_of_components=2,
                    device=device,
                )
            axis_labels = ("PC 1", "PC 2")
        for colour_values, suffix, title in (
            (
                latent_set.labels if latent_set.has_labels else None,
                "labels",
                "class",
            ),
            (
                latent_set.predicted_cluster_ids
                if latent_set.has_predicted_cluster_ids
                else None,
                "clusters",
                "cluster",
            ),
        ):
            if colour_values is not None:
                results["figures"].append(
                    figures.plot_values(
                        decomposed,
                        colour_coding=colour_values,
                        colour_coding_title=title,
                        centroids=(
                            centroids_decomposed.get("prior")
                            if isinstance(centroids_decomposed, dict)
                            else None
                        ),
                        name=f"latent_space-{suffix}",
                        directory=directory,
                        axis_labels=axis_labels,
                    )
                )
        # decomposition grid over every latent set × method (reference
        # analyses.py:1405-1416 via subanalyses.analyse_decompositions)
        results["figures"].extend(
            subanalyses.analyse_decompositions(
                list(latent_evaluation_sets.values()),
                centroids=centroids,
                colouring_data_set=evaluation_set,
                decomposition_methods=decomposition_methods,
                export_options=export_options,
                analyses_directory=_subdirectory(directory, "latent_space"),
                device=device,
            )
        )
        if centroids:
            results["figures"].extend(
                subanalyses.analyse_centroid_probabilities(
                    centroids,
                    analyses_directory=_subdirectory(
                        directory, "latent_space"
                    ),
                )
            )

    # the latent values' TSV, with or without the latent-space figures
    if latent_evaluation_sets and "z" in latent_evaluation_sets and (
        (export_options and "latent" in export_options)
        or "latent_values" in included
    ):
        latent_set = latent_evaluation_sets["z"]
        results["figures"].append(save_values(
            np.asarray(latent_set.values),
            name=f"latent_values-{latent_set.kind}",
            row_names=latent_set.example_names,
            column_names=latent_set.feature_names,
            directory=directory,
        ))

    # profile comparisons on the evaluation subset
    if (
        "profile_comparisons" in included
        and reconstructed_evaluation_set is not None
        and evaluation_subset_indices is not None
    ):
        figures = import_figures("profile_comparisons")
        profile_directory = _subdirectory(directory, "profile_comparisons")
        obs = evaluation_set.values
        rec = reconstructed_evaluation_set.values
        total_std = reconstructed_evaluation_set.total_standard_deviations
        explained_std = (
            reconstructed_evaluation_set.explained_standard_deviations
        )
        for i in np.asarray(evaluation_subset_indices)[:8]:
            results["figures"].append(
                figures.plot_profile_comparison(
                    obs[int(i)],
                    rec[int(i)],
                    expected_total_standard_deviations=(
                        total_std[int(i)] if total_std is not None else None
                    ),
                    expected_explained_standard_deviations=(
                        explained_std[int(i)]
                        if explained_std is not None
                        else None
                    ),
                    name="profile_comparison-{}".format(
                        normalise_string(str(evaluation_set.example_names[int(i)]))
                    ),
                    directory=profile_directory,
                )
            )

    # reconstruction sprite sheets for image data (reference
    # analyses.py:1060-1090)
    if (
        "images" in included
        and reconstructed_evaluation_set is not None
        and reconstructed_evaluation_set.example_type == "images"
    ):
        figures = import_figures("images")
        results["figures"].append(
            figures.combine_images_from_data_set(
                reconstructed_evaluation_set,
                name=f"image_examples-reconstructed-{evaluation_set.kind}",
                directory=directory,
            )
        )

    # distribution histograms of the reconstructions (reference
    # analyses.py:1225-1234)
    if (
        "distributions" in included
        and reconstructed_evaluation_set is not None
        and reconstructed_evaluation_set.has_values
    ):
        results["figures"].extend(
            subanalyses.analyse_distributions(
                reconstructed_evaluation_set,
                analysis_level=analysis_level,
                export_options=export_options,
                analyses_directory=_subdirectory(directory, "distributions"),
            )
        )

    # decomposition grids of the reconstructed (and, at the extensive
    # level, original) value sets (reference analyses.py:1236-1283)
    if (
        "decompositions" in included
        and reconstructed_evaluation_set is not None
        and reconstructed_evaluation_set.has_values
    ):
        decomposition_sets = [reconstructed_evaluation_set]
        if analysis_level == "extensive":
            decomposition_sets.append(evaluation_set)
        results["figures"].extend(
            subanalyses.analyse_decompositions(
                decomposition_sets,
                colouring_data_set=evaluation_set,
                decomposition_methods=decomposition_methods,
                analysis_level=analysis_level,
                export_options=export_options,
                analyses_directory=_subdirectory(directory, "decompositions"),
                device=device,
            )
        )

    # value heat maps of reconstructed + latent sets (reference
    # analyses.py:1285-1351)
    if "heat_maps" in included:
        heat_map_sets = [evaluation_set]
        if (
            reconstructed_evaluation_set is not None
            and reconstructed_evaluation_set.has_values
        ):
            heat_map_sets.append(reconstructed_evaluation_set)
        if latent_evaluation_sets and "z" in latent_evaluation_sets:
            heat_map_sets.append(latent_evaluation_sets["z"])
        for heat_map_set in heat_map_sets:
            results["figures"].extend(
                subanalyses.analyse_matrices(
                    heat_map_set,
                    name=[heat_map_set.kind, heat_map_set.version],
                    analyses_directory=_subdirectory(directory, "heat_maps"),
                    device=device,
                )
            )

    # pairwise-distance heat maps (reference analyses.py:1353-1365)
    if "distances" in included:
        distance_sets = []
        if (
            reconstructed_evaluation_set is not None
            and reconstructed_evaluation_set.has_values
        ):
            distance_sets.append(reconstructed_evaluation_set)
        if latent_evaluation_sets and "z" in latent_evaluation_sets:
            distance_sets.append(latent_evaluation_sets["z"])
        for distance_set in distance_sets:
            results["figures"].extend(
                subanalyses.analyse_matrices(
                    distance_set,
                    plot_distances=True,
                    name=[distance_set.kind, distance_set.version],
                    analyses_directory=_subdirectory(directory, "distances"),
                    device=device,
                )
            )

    # prediction TSV exports (reference analyses.py:1367-1370)
    if "predictions" in included and (
        evaluation_set.has_predicted_cluster_ids
        or evaluation_set.has_predicted_labels
        or evaluation_set.has_predicted_superset_labels
    ):
        results["figures"].extend(
            subanalyses.analyse_predictions(
                evaluation_set, analyses_directory=directory
            )
        )

    if "latent_correlations" in included and latent_evaluation_sets:
        latent_set = latent_evaluation_sets.get("z")
        if latent_set is not None and latent_set.values.shape[1] > 1:
            figures = import_figures("latent_correlations")
            correlations_directory = _subdirectory(
                directory, "latent_correlations"
            )
            corr = metrics.correlation_matrix(latent_set.values,
                                              axis="features", device=device)
            results["figures"].append(
                figures.plot_heat_map(
                    corr,
                    name="latent_correlations",
                    directory=correlations_directory,
                    x_label="latent dimension",
                    y_label="latent dimension",
                    z_label="correlation",
                    center=0.0,
                )
            )
            # most-correlated latent pairs (reference analyses.py:1453-1480)
            pairs = metrics.most_correlated_feature_pairs(corr, n_limit=5)
            values = np.asarray(latent_set.values)
            for pair in pairs:
                results["figures"].append(
                    figures.plot_values(
                        values[:, list(pair)],
                        colour_coding=(
                            latent_set.labels
                            if latent_set.has_labels
                            else None
                        ),
                        name="latent_correlations-pair_{}_{}".format(*pair),
                        directory=correlations_directory,
                        axis_labels=(f"z{pair[0] + 1}", f"z{pair[1] + 1}"),
                    )
                )
            # latent scatter matrix (reference plot_variable_correlations)
            if values.shape[1] <= 10:
                results["figures"].append(
                    figures.plot_variable_correlations(
                        values,
                        variable_names=latent_set.feature_names,
                        colour_coding=(
                            latent_set.labels
                            if latent_set.has_labels
                            else None
                        ),
                        name="latent_scatter_matrix",
                        directory=correlations_directory,
                    )
                )
            # per-dimension label correlations (reference
            # analyses.py:1500-1525)
            if latent_set.has_labels:
                for dim in range(min(values.shape[1], 10)):
                    results["figures"].append(
                        figures.plot_variable_label_correlations(
                            values[:, dim],
                            latent_set.labels,
                            variable_name=f"z{dim + 1}",
                            name=(
                                "latent_correlations-labels-"
                                f"latent_dimension_{dim}"
                            ),
                            directory=correlations_directory,
                        )
                    )

    # latent features: the two highest-KL latent dimensions plotted against
    # each other (+ labels against the first; reference analyses.py:1527-1607)
    if (
        "latent_features" in included
        and latent_evaluation_sets
        and "z" in latent_evaluation_sets
    ):
        figures = import_figures("latent_features")
        latent_set = latent_evaluation_sets["z"]
        values = np.asarray(latent_set.values)
        features_directory = _subdirectory(directory, "latent_features")
        kl_neurons = None
        for kind in ("validation", "training"):
            kl_neurons = checkpoints.load_array_series(
                model.log_directory(run_id=run_id),
                f"kl_divergence_neurons-{kind}",
            )
            if kl_neurons is not None:
                break
        if kl_neurons is not None and kl_neurons.shape[-1] == values.shape[1]:
            ranking = np.argsort(kl_neurons[-1])[::-1]
        else:
            ranking = np.argsort(values.var(axis=0))[::-1]
        if values.shape[1] >= 2:
            factor_1, factor_2 = int(ranking[0]), int(ranking[1])
            results["figures"].append(
                figures.plot_values(
                    values[:, [factor_1, factor_2]],
                    colour_coding=(
                        latent_set.labels if latent_set.has_labels else None
                    ),
                    name="latent_features-pair",
                    directory=features_directory,
                    axis_labels=(f"z{factor_1 + 1}", f"z{factor_2 + 1}"),
                )
            )
            if latent_set.has_labels:
                results["figures"].append(
                    figures.plot_variable_label_correlations(
                        values[:, factor_1],
                        latent_set.labels,
                        variable_name=f"z{factor_1 + 1}",
                        name="latent_factor-labels",
                        directory=features_directory,
                    )
                )

    return results


def _metric_files(evaluation_set, reconstructed_evaluation_set, model,
                  number_of_epochs_trained, directory, seed,
                  device) -> dict[str, Any]:
    """``<kind>-metrics.log`` / ``.pkl.gz`` and, with prediction
    specifications, ``<kind>-prediction-<name>.log`` / ``.pkl.gz``
    (reference ``analyses.py:529-647``)."""
    evaluation_metrics = getattr(model, "_last_evaluation_metrics", {})
    statistics = [
        metrics.summary_statistics(
            ds.values, name=ds.version, tolerance=0.5, device=device
        )
        for ds in (evaluation_set, reconstructed_evaluation_set)
        if ds is not None and ds.has_values
    ]
    clustering_metric_values = metrics.compute_clustering_metrics(
        evaluation_set, seed=seed, device=device
    )

    now = time.time()
    metrics_name = f"{evaluation_set.kind}-metrics"
    string_parts = [
        f"Timestamp: {format_time(now)}",
        f"Number of epochs trained: {number_of_epochs_trained}",
        "\nEvaluation:",
    ]
    for key, label in (
        ("lower_bound", "ELBO"),
        ("reconstruction_error", "ENRE"),
        ("kl_divergence", "KL"),
        ("kl_divergence_z", "KL_z"),
        ("kl_divergence_y", "KL_y"),
    ):
        if key in evaluation_metrics:
            string_parts.append(
                "    {}: {:.5g}.".format(label, evaluation_metrics[key])
            )
    accuracies = clustering_metric_values.get("accuracies", {})
    if accuracies.get("accuracy") is not None:
        string_parts.append(
            "    Accuracy: {:6.2f} %.".format(100 * accuracies["accuracy"])
        )
    if accuracies.get("superset_accuracy") is not None:
        string_parts.append(
            "    Accuracy (superset): {:6.2f} %.".format(
                100 * accuracies["superset_accuracy"]
            )
        )
    string_parts.append("\n" + metrics.format_summary_statistics(statistics))
    metrics_string = "\n".join(string_parts) + "\n"
    with open(os.path.join(directory, metrics_name + ".log"), "w") as f:
        f.write(metrics_string)
    print(metrics_string)

    # evaluation curves in the reference pickle shape: name → list
    _write_pickle(os.path.join(directory, metrics_name + ".pkl.gz"), {
        "timestamp": now,
        "number of epochs trained": number_of_epochs_trained,
        "evaluation": {
            key: [value] for key, value in evaluation_metrics.items()
        },
        "accuracy": (
            [accuracies["accuracy"]]
            if accuracies.get("accuracy") is not None
            else None
        ),
        "superset_accuracy": (
            [accuracies["superset_accuracy"]]
            if accuracies.get("superset_accuracy") is not None
            else None
        ),
        "statistics": statistics,
    })

    if evaluation_set.prediction_specifications:
        spec = evaluation_set.prediction_specifications
        prediction_name = "{}-prediction-{}".format(
            evaluation_set.kind, spec.name
        )
        _write_pickle(os.path.join(directory, prediction_name + ".pkl.gz"), {
            "timestamp": now,
            "number of epochs trained": number_of_epochs_trained,
            "prediction method": spec.method,
            "number of classes": spec.number_of_clusters,
            "training set": spec.training_set_kind,
            "clustering metric values": clustering_metric_values,
        })
        prediction_lines = [
            f"Timestamp: {format_time(now)}",
            f"Number of epochs trained: {number_of_epochs_trained}",
            f"Prediction method: {spec.method}",
            f"Number of classes: {spec.number_of_clusters}",
            "\nClustering metrics:",
        ]
        for metric_name, metric_set in clustering_metric_values.items():
            if metric_name == "accuracies":
                continue
            for set_name, value in metric_set.items():
                if value is not None:
                    prediction_lines.append(
                        "    {} ({}): {:.5g}.".format(
                            capitalise_string(metric_name), set_name, value,
                        )
                    )
        with open(
            os.path.join(directory, prediction_name + ".log"), "w"
        ) as f:
            f.write("\n".join(prediction_lines) + "\n")
    return {"statistics": statistics,
            "clustering_metrics": clustering_metric_values}
