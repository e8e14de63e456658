"""Analysis orchestrators: the ported part of
``scvae_tpu/analyses/analyses.py`` (the reference's
``scvae/analyses/analyses.py``).

The analysis groups (``simple`` ⊂ ``standard`` ⊂ ``all``) and the analyses
that compute: the summary statistics of data sets (``analyse_data``'s
"metrics"), and of a model's results the metric and prediction logs and
pickles that cross-analysis reads (``<kind>-metrics.log`` / ``.pkl.gz``,
``<kind>-prediction-<name>.log`` / ``.pkl.gz``, in the JAX package's
layout), the prediction TSV ("predictions") and the latent values' TSV
("latent_values"), on a device (CUDA unless ``device="cpu"``).

Every other analysis draws figures, which are not ported yet: including
one raises ``NotImplementedError`` naming it.  The library's default
("standard") includes such analyses.  One difference from the JAX package:
there the latent values' TSV is written only with the "latent_space"
figures; here "latent_values" writes it.
"""

from __future__ import annotations

import gzip
import os
import pickle
import time
from typing import Any, Sequence

import numpy as np

from scvae_tpu_torch.analyses import metrics, subanalyses
from scvae_tpu_torch.data.utilities import save_values
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import checkpoints
from scvae_tpu_torch.utils.device import resolve_device
from scvae_tpu_torch.utils.strings import capitalise_string, format_time

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

# The figure analyses each orchestrator runs in the JAX package.
_DATA_FIGURES = ("distributions", "decompositions", "heat_maps", "distances",
                 "feature_value_standard_deviations")
_MODEL_FIGURES = ("learning_curves", "accuracies", "kl_heat_maps",
                  "latent_distributions")
_RESULT_FIGURES = ("latent_space", "profile_comparisons", "images",
                   "distributions", "decompositions", "heat_maps",
                   "distances", "latent_correlations", "latent_features")


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


def _refuse_figures(included: list[str], figures: Sequence[str],
                    where: str) -> None:
    refused = [analysis for analysis in figures if analysis in included]
    if refused:
        raise NotImplementedError(
            f"{where}: the figure analyses {', '.join(refused)} are not "
            "ported yet (the ported ones: metrics, predictions, "
            "latent_values)")


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
    """Summary statistics of one or more data sets, into
    ``<analyses_directory>/data/statistics.log``."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    included = _resolve_included(included_analyses)
    _refuse_figures(included, _DATA_FIGURES, "analyse_data")
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
        if data_set.has_values:
            _subdirectory(directory, data_set.kind)
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
) -> dict[str, Any]:
    """The run's learning curves and centroids; every analysis of this
    function draws figures, and those are not ported yet."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    included = _resolve_included(included_analyses)
    _refuse_figures(included, _MODEL_FIGURES, "analyse_model")
    number_of_epochs_trained = model.number_of_epochs_trained(run_id=run_id)
    _model_analyses_path(analyses_directory, model.name, run_id,
                         [f"e_{number_of_epochs_trained}"])
    log_directory = model.log_directory(run_id=run_id)
    return {
        "figures": [],
        "learning_curves": model.learning_curves(run_id=run_id),
        "centroids": checkpoints.load_centroids(log_directory),
    }


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
    """Metric logs and pickles, the prediction TSV and the latent values'
    TSV of a model version's evaluation; ``seed`` for the silhouette's
    sample above 20,000 examples."""
    if analyses_directory is None:
        analyses_directory = get_default("analyses", "directory")
    included = _resolve_included(included_analyses)
    _refuse_figures(included, _RESULT_FIGURES, "analyse_results")
    device = resolve_device(device)

    version = "end_of_training"
    if best_model:
        version = "best_model"
    elif early_stopping:
        version = "early_stopping"
    number_of_epochs_trained = model.number_of_epochs_trained(
        run_id=run_id, early_stopping=early_stopping, best_model=best_model
    )
    # epochs, version and evaluation sample counts (reference
    # analyses.py:805-817), so that cross-analysis can pick the
    # longest-trained variant per version
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
