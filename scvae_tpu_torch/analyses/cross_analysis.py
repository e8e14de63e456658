"""Cross-model comparison (the port's copy of
``scvae_tpu/analyses/cross_analysis.py``, the reference's
``scvae/analyses/cross_analysis.py``): aggregate the metric and prediction
pickles of many runs into comparison tables, a summary log and
cross-model figures.

Walks an analyses directory tree for ``test-metrics*.pkl.gz`` /
``test-prediction*.pkl.gz`` (the files :func:`analyse_results` writes),
filters by include/exclude strings (reference ``cross_analysis.py:1872``),
groups by **data set → model → run → version** (``:1290-1383``), and per
data set produces:

* a per-run/per-version metric report (summary log, ``:1531-1869``),
* a comparison table — one row per (model, clustering method, runs
  group, version), metric values as mean ± sd over named runs, shared
  columns factored into a common-fields footer (``:640-800``),
* an ELBO-vs-clustering-metric Pearson-correlation table + scatter
  (``:487-532``),
* an ELBO heat map over network architectures (hidden sizes × latent
  size) on the most common model configuration (``:575-638``),
* per-metric model plots (ELBO/ENRE/KL_z/KL_y) grouped by model type ×
  likelihood (``:1125-1169``, ``figures/cross_model.py:91-223``),
* metric-vs-clustering scatter plots per evaluation-set kind
  (standard/superset/unsupervised) grouped by likelihood × prediction
  method, with **other-method baselines** (k-means, Seurat, scVI, factor
  analysis, …) drawn as lines/bands (``:1171-1283``,
  ``figures/cross_model.py:226-456``; baseline scan ``:1385-1529``).

Everything here is numpy, pandas and files on the host; no device takes
part.  pandas is imported where a cross-analysis runs, as the data
loaders import it, so the package imports without it.  The figures go
through ``figures.py`` (matplotlib, imported when a cross-analysis runs,
with an ``ImportError`` that names the analysis when it is missing).

Model specifications are parsed **structurally** from the
hyperparameter-addressed directory layout of
:mod:`scvae_tpu_torch.models.naming` and formatted into the reference's
abbreviated titles (``VAE(G)``, ``GMVAE(5)``, ``NB``/``ZINB``/``PCNB(10)``,
``100×100×10``), where the reference regex-parses model titles.

Deviations from the reference, as in the JAX package:

* the architecture heat map picks the (type, likelihood, other) group
  with the largest architecture grid instead of hard-coding
  VAE(G)/NB/BN (the reference's choice reproduces one figure of the
  paper);
* model-metric plots fall back to default-run models when no multi-run
  models exist (the reference renders empty axes in that case);
* a machine-readable ``comparison.csv`` with one row per run is written
  next to the log.
"""

from __future__ import annotations

import gzip
import os
import pickle
import re
import statistics
from itertools import product
from string import ascii_uppercase
from typing import Any

import numpy as np

from scvae_tpu_torch.analyses.subanalyses import import_figures
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.utils.strings import capitalise_string, normalise_string

METRICS_BASENAME = "test-metrics"
PREDICTION_BASENAME = "test-prediction"
ZIPPED_PICKLE_EXTENSION = ".pkl.gz"
LOG_EXTENSION = ".log"

_MODEL_TYPES = ("VAE", "GMVAE")

# Comparison-table column vocabulary (reference cross_analysis.py:52-88).
SORTED_COMPARISON_TABLE_COLUMN_NAMES = [
    "ID",
    "type",
    "likelihood",
    "sizes",
    "other",
    "clustering method",
    "runs",
    "version",
    "epochs",
    "ELBO",
    "adjusted Rand index",
    "adjusted mutual information",
    "silhouette score",
]

ABBREVIATIONS = {
    "ID": "#",
    "type": "T",
    "likelihood": "L",
    "sizes": "S",
    "other": "O",
    "clustering method": "CM",
    "runs": "R",
    "version": "V",
    "epochs": "E",
    "end of training": "EOT",
    "optimal parameters": "OP",
    "early stopping": "ES",
    "adjusted Rand index": "ARI",
    "adjusted mutual information": "AMI",
    "silhouette score": "SS",
    "superset": "sup",
}

CLUSTERING_METRICS = {
    "adjusted Rand index": {"kind": "supervised", "symbol": r"$R_\mathrm{adj}$"},
    "adjusted mutual information": {"kind": "supervised", "symbol": "AMI"},
    "silhouette score": {"kind": "unsupervised", "symbol": "$s$"},
}

OPTIMISED_METRIC_SYMBOLS = {
    "ELBO": r"$\mathcal{L}$",
    "ENRE": r"$\log p(x|z)$",
    "KL_z": r"KL$_z(q||p)$",
    "KL_y": r"KL$_y(q||p)$",
}

MODEL_TYPE_ORDER = ["VAE", "GMVAE", "FA"]
LIKELIHOOD_DISTRIBUTION_ORDER = ["P", "NB", "ZIP", "ZINB", "PCP", "PCNB", "CP"]

# Distribution-name abbreviations used in model/likelihood titles
# (the reference's DISTRIBUTION_REPLACEMENTS regex tables,
# cross_analysis.py:203-236, as a direct lookup).
_DISTRIBUTION_ABBREVIATIONS = {
    "gaussian": "G",
    "softplus_gaussian": "SG",
    "modified_gaussian": "MG",
    "multivariate_gaussian": "MVG",
    "gaussian_mixture": "GM",
    "full_covariance_gaussian_mixture": "FCGM",
    "legacy_gaussian_mixture": "LGM",
    "unit_variance_gaussian": "UG",
    "log_normal": "LN",
    "exponentially_modified_gaussian": "EMG",
    "gamma": "Ga",
    "categorical": "Cat",
    "bernoulli": "B",
    "poisson": "P",
    "constrained_poisson": "CP",
    "lomax": "L",
    "pareto": "Pa",
    "zero_inflated_poisson": "ZIP",
    "negative_binomial": "NB",
    "zero_inflated_negative_binomial": "ZINB",
}

# Version-directory vocabulary.  analyse_results writes
# ``e_<n>[-early_stopping|-best_model]-mc_<n>-iw_<n>`` directories
# (analyses.py); plain version names are accepted for hand-built trees.
_VERSION_TITLES = {
    "end_of_training": "end of training",
    "early_stopping": "early stopping",
    "best_model": "optimal parameters",
    "best": "optimal parameters",
}
_VERSION_RANKINGS = {
    "end of training": 0,
    "EOT": 0,
    "early stopping": 1,
    "ES": 1,
    "optimal parameters": 2,
    "OP": 2,
}

# Non-scVAE baseline methods whose prediction pickles may sit in
# ``<data set directory>/<method>/`` (reference cross_analysis.py:126-136,
# 1385-1529).
OTHER_METHOD_NAMES = {
    "k-means": ["k_means", "kmeans"],
    "Seurat": ["seurat"],
    "scVI": ["scvi"],
    "scvis": ["scvis"],
    "Factor Analysis": ["factor_analysis", "fa"],
}


# --------------------------------------------------------------------------
# Headings (string-returning so the same text feeds stdout and the log)
# --------------------------------------------------------------------------


def _title_string(text: str) -> str:
    bar = "=" * len(text)
    return f"{bar}\n{text}\n{bar}\n"


def _subtitle_string(text: str) -> str:
    return f"{text}\n{'-' * len(text)}\n"


def _heading_string(text: str) -> str:
    return f"{text}\n{'~' * len(text)}\n"


# --------------------------------------------------------------------------
# Directory scanning
# --------------------------------------------------------------------------


def _match_string(name, included_strings=None, excluded_strings=None) -> bool:
    """Reference ``cross_analysis.py:1872-1890``."""
    for s in included_strings or []:
        if s not in name:
            return False
    for s in excluded_strings or []:
        if s in name:
            return False
    return True


def _split_run_path(parts: list[str]) -> tuple[str, str, str, str]:
    """Split a run's relative path into (data set, model, run, version).

    The layout is ``<data set…>/<TYPE>/<major>/<minor>[/run_<id>]
    [/<version>]`` (reference ``cross_analysis.py:1290-1383`` splits at
    fixed depths; splitting at the model-type directory also accepts
    data-set paths of any depth)."""
    type_index = None
    for i, part in enumerate(parts):
        if part in _MODEL_TYPES:
            type_index = i
            break
    if type_index is None:
        # Hand-built tree without the TYPE level: treat the leading path as
        # the model, with no data-set level.
        type_index = 0
    data_set = os.sep.join(parts[:type_index])
    model_parts = parts[type_index:type_index + 3]
    rest = parts[type_index + 3:]
    run = "default"
    version = "end_of_training"
    for part in rest:
        if part.startswith("run_"):
            run = part[len("run_"):]
        else:
            version = part
    return data_set, os.sep.join(model_parts), run, version


def _metrics_sets_in_analyses_directory(
    analyses_directory: str,
    data_set_included_strings=None,
    data_set_excluded_strings=None,
    model_included_strings=None,
    model_excluded_strings=None,
) -> dict[str, dict[str, dict[str, dict[str, Any]]]]:
    """data set → model → run → version → {"metrics": …, "predictions": …}
    (reference ``cross_analysis.py:1290-1383``)."""
    metrics_filename = METRICS_BASENAME + ZIPPED_PICKLE_EXTENSION
    sets: dict[str, dict[str, dict[str, dict[str, Any]]]] = {}
    for root, _dirs, files in os.walk(analyses_directory):
        if metrics_filename not in files:
            continue
        rel = os.path.relpath(root, analyses_directory)
        parts = [] if rel == "." else rel.split(os.sep)
        if parts and parts[0] == "cross_analysis":
            continue
        data_set, model, run, version = _split_run_path(parts)
        if not _match_string(
            data_set, data_set_included_strings, data_set_excluded_strings
        ):
            continue
        if not _match_string(
            model, model_included_strings, model_excluded_strings
        ):
            continue
        with gzip.open(os.path.join(root, metrics_filename), "rb") as f:
            record: dict[str, Any] = {"metrics": pickle.load(f)}
        predictions = {}
        for filename in files:
            if filename.startswith(PREDICTION_BASENAME) and filename.endswith(
                ZIPPED_PICKLE_EXTENSION
            ):
                with gzip.open(os.path.join(root, filename), "rb") as f:
                    predictions[
                        filename[
                            len(PREDICTION_BASENAME):-len(
                                ZIPPED_PICKLE_EXTENSION
                            )
                        ].strip("-")
                    ] = pickle.load(f)
        if predictions:
            record["predictions"] = predictions
        sets.setdefault(data_set, {}).setdefault(model, {}).setdefault(
            run, {}
        )[version] = record
    return sets


# --------------------------------------------------------------------------
# Structured model-specification parsing + titles
# --------------------------------------------------------------------------


def _parse_model_specifications(model: str) -> dict[str, Any]:
    """Parse the hyperparameter-addressed model path
    ``<TYPE>/<major marker list>/<minor marker list>`` (inverse of
    :func:`scvae_tpu_torch.models.naming.model_name`)."""
    parts = model.split(os.sep)
    spec: dict[str, Any] = {
        "model type": parts[0] if parts else None,
        "latent distribution": None,
        "clusters": None,
        "prior method": None,
        "parameterised": False,
        "inference architecture": "MLP",
        "generative architecture": "MLP",
        "reconstruction distribution": None,
        "k_max": None,
        "count sum": False,
        "latent size": None,
        "hidden sizes": None,
        "analytical kl": False,
        "batch normalisation": False,
        "batch correction": False,
        "dropout": None,
        "kl weight": None,
        "warm up epochs": None,
        "mc train": 1,
        "iw train": 1,
    }
    if len(parts) > 1:
        tokens = parts[1].split("-")
        spec["latent distribution"] = tokens[0] or None
        for token in tokens[1:]:
            if re.fullmatch(r"c_\d+", token):
                spec["clusters"] = int(token[2:])
            elif token.startswith("p_"):
                spec["prior method"] = token[2:]
            elif token == "parameterised":
                spec["parameterised"] = True
            elif token.startswith("ia_"):
                spec["inference architecture"] = token[3:]
            elif token.startswith("ga_"):
                spec["generative architecture"] = token[3:]
    if len(parts) > 2:
        tokens = parts[2].split("-")
        spec["reconstruction distribution"] = tokens[0] or None
        for token in tokens[1:]:
            if re.fullmatch(r"k_\d+", token):
                spec["k_max"] = int(token[2:])
            elif token == "sum":
                spec["count sum"] = True
            elif re.fullmatch(r"l_\d+", token):
                spec["latent size"] = int(token[2:])
            elif re.fullmatch(r"h_[\d_]+", token):
                spec["hidden sizes"] = [int(h) for h in token[2:].split("_")]
            elif re.fullmatch(r"mc_\d+", token):
                spec["mc train"] = int(token[3:])
            elif re.fullmatch(r"iw_\d+", token):
                spec["iw train"] = int(token[3:])
            elif token == "kl":
                spec["analytical kl"] = True
            elif token == "bn":
                spec["batch normalisation"] = True
            elif token == "bc":
                spec["batch correction"] = True
            elif token.startswith("dropout_"):
                spec["dropout"] = token[len("dropout_"):].replace("_", ", ")
            elif token.startswith("klw_"):
                spec["kl weight"] = token[4:]
            elif token.startswith("wu_"):
                spec["warm up epochs"] = token[3:]
    return spec


def _abbreviate_distribution(name: str | None) -> str:
    if not name:
        return "?"
    return _DISTRIBUTION_ABBREVIATIONS.get(
        normalise_string(name), normalise_string(name)
    )


def _model_type_title(spec: dict[str, Any]) -> str:
    """``VAE(G)``, ``GMVAE(5)``, ``GMVAE(5; custom)``, ``VAE(G, g: LFM)``
    (reference MODEL_REPLACEMENTS, cross_analysis.py:188-202)."""
    model_type = spec.get("model type") or "?"
    details: list[str] = []
    if model_type == "GMVAE":
        if spec.get("clusters"):
            details.append(str(spec["clusters"]))
        if spec.get("prior method"):
            details.append(spec["prior method"])
        detail = "; ".join(details)
        return f"GMVAE({detail})" if detail else "GMVAE"
    details.append(_abbreviate_distribution(spec.get("latent distribution")))
    ia = spec.get("inference architecture", "MLP")
    ga = spec.get("generative architecture", "MLP")
    if ia != "MLP" or ga != "MLP":
        if ia == ga:
            details.append(ia)
        else:
            if ia != "MLP":
                details.append(f"i: {ia}")
            if ga != "MLP":
                details.append(f"g: {ga}")
    return "{}({})".format(model_type, ", ".join(details))


# A VAE with a linear factor-model generator IS factor analysis; alias it
# in method comparisons (reference FACTOR_ANALYSIS_MODEL_TYPE, :119-120).
FACTOR_ANALYSIS_MODEL_TYPE = "VAE(G, g: LFM)"
FACTOR_ANALYSIS_MODEL_TYPE_ALIAS = "FA"


def _likelihood_title(spec: dict[str, Any]) -> str:
    abbreviation = _abbreviate_distribution(
        spec.get("reconstruction distribution")
    )
    if spec.get("k_max"):
        return f"PC{abbreviation}({spec['k_max']})"
    return abbreviation


def _sizes_title(spec: dict[str, Any]) -> str:
    hidden = spec.get("hidden sizes") or []
    latent = spec.get("latent size")
    return "×".join([str(h) for h in hidden] + [str(latent)])


def _other_title(spec: dict[str, Any]) -> str:
    """Secondary model markers: ``BN``, ``CS``, ``BC``, ``PLP``, dropout,
    KLW, WU — the analytic-KL marker is dropped like the reference's
    ``-kl-`` replacement (MISCELLANEOUS_MODEL_REPLACEMENTS)."""
    parts = []
    if spec.get("batch normalisation"):
        parts.append("BN")
    if spec.get("count sum"):
        parts.append("CS")
    if spec.get("batch correction"):
        parts.append("BC")
    if spec.get("parameterised"):
        parts.append("PLP")
    if spec.get("dropout"):
        parts.append("dropout: {}".format(spec["dropout"]))
    if spec.get("kl weight"):
        parts.append("KLW: {}".format(spec["kl weight"]))
    if spec.get("warm up epochs"):
        parts.append("WU({})".format(spec["warm up epochs"]))
    if spec.get("mc train", 1) > 1:
        parts.append("{} MC".format(spec["mc train"]))
    if spec.get("iw train", 1) > 1:
        parts.append("{} IW".format(spec["iw train"]))
    return "; ".join(parts)


def _model_title(spec: dict[str, Any]) -> str:
    pieces = [
        _model_type_title(spec),
        _likelihood_title(spec),
        _sizes_title(spec),
    ]
    other = _other_title(spec)
    if other:
        pieces.append(other)
    return "; ".join(pieces)


def _clustering_method_title(method: str | None, classes) -> str:
    """``kM(5)`` for k-means over 5 clusters, ``M`` for the model's own
    clustering (reference CLUSTERING_METHOD_REPLACEMENTS)."""
    if not method or normalise_string(str(method)) == "model":
        return "M"
    method = str(method).replace("k-means", "kM").replace("kmeans", "kM")
    if classes:
        return f"{method}({classes})"
    return method


def _data_set_title(data_set: str) -> str:
    if not data_set:
        return "Data set"
    return data_set.replace(os.sep, "; ").replace("_", " ")


def _parse_version_directory(version: str) -> dict[str, Any]:
    """``e_30-best_model-mc_1-iw_1`` → {epochs, version title, samples}
    (reference ``cross_analysis.py:1566-1586``)."""
    epochs = None
    version_title = "end of training"
    samples = []
    for field in version.split("-"):
        if re.fullmatch(r"e_\d+", field):
            epochs = int(field[2:])
        elif re.fullmatch(r"(mc|iw)_\d+", field):
            kind, value = field.split("_")
            if int(value) > 1:
                samples.append(f"{value} {kind.upper()} samples")
        elif field in _VERSION_TITLES:
            version_title = _VERSION_TITLES[field]
    return {"epochs": epochs, "version": version_title, "samples": samples}


def _generate_model_ids():
    """Two-character run ids, skipping all-digit combinations
    (reference ``cross_analysis.py:1952-1964``)."""
    values = [str(d) for d in range(10)] + list(ascii_uppercase)
    for value1, value2 in product(values, values):
        model_id = value1 + value2
        if model_id.isdigit():
            continue
        yield model_id


def _best_variant(*variants, additional_other_option=None):
    """Prefer variants carrying the requested extra marker, then
    optimal-parameters > early-stopping > end-of-training, then longest
    trained (reference ``cross_analysis.py:1966-2006``)."""

    def sort_key(variant):
        other = variant.get("other") or ""
        other_set = set(other.split("; ")) if other else set()
        epochs = variant.get("epochs") or -1
        if isinstance(epochs, list):
            epochs = statistics.mean(e for e in epochs if e is not None)
        return [
            additional_other_option in other_set,
            _VERSION_RANKINGS.get(variant.get("version"), -1),
            epochs,
        ]

    return sorted(variants, key=sort_key)[-1]


# --------------------------------------------------------------------------
# Per-model metric aggregation over runs and versions
# --------------------------------------------------------------------------


def _parse_metrics_for_runs_and_versions_of_model(
    runs: dict[str, dict[str, Any]],
    prediction_included_strings=None,
    prediction_excluded_strings=None,
    epoch_cut_off=None,
) -> dict[str, Any]:
    """One summary-metrics set per (runs group, version, clustering
    method), metric values collected into lists over named runs, plus
    ELBO-vs-clustering correlation sets and the per-version log report
    (reference ``cross_analysis.py:1531-1869``)."""
    run_version_summary_metrics: dict[str, dict[str, Any]] = {
        "default": {},
        "multiple": {},
    }
    correlation_sets: dict[str, dict[str, list[float]]] = {}
    log_string_parts: list[str] = []
    flat_rows: list[dict[str, Any]] = []

    for run_name, versions in sorted(runs.items()):
        run_key = "default" if run_name == "default" else "multiple"
        if len(runs) > 1:
            run_title = (
                "default run" if run_name == "default" else f"run {run_name}"
            )
            log_string_parts.append(_heading_string(
                capitalise_string(run_title)
            ))

        version_epoch_summary_metrics: dict[str, dict[int, dict]] = {}

        for version_name, record in sorted(versions.items()):
            metrics_data = record.get("metrics", {})
            version_fields = _parse_version_directory(version_name)
            number_of_epochs = version_fields["epochs"]
            if number_of_epochs is None:
                number_of_epochs = metrics_data.get(
                    "number of epochs trained"
                )
            if (
                epoch_cut_off
                and number_of_epochs
                and number_of_epochs > epoch_cut_off
            ):
                continue

            summary_metrics: dict[str, Any] = {
                "epochs": number_of_epochs,
            }
            report_parts = []
            if metrics_data.get("timestamp"):
                report_parts.append(
                    "Timestamp: {}".format(metrics_data["timestamp"])
                )
            report_parts.append(f"Epochs trained: {number_of_epochs}")

            evaluation = metrics_data.get("evaluation", {}) or {}
            for loss in (
                "log_likelihood",
                "lower_bound",
                "reconstruction_error",
                "kl_divergence",
                "kl_divergence_z",
                "kl_divergence_y",
            ):
                values = evaluation.get(loss)
                if values:
                    report_parts.append(
                        "{}: {:-.6g}".format(loss, values[-1])
                    )

            def _last(key):
                values = evaluation.get(key)
                return values[-1] if values else None

            kl_z = _last("kl_divergence")
            if kl_z is None:
                kl_z = _last("kl_divergence_z")
            summary_metrics.update(
                {
                    "ELBO": _last("lower_bound"),
                    "ENRE": _last("reconstruction_error"),
                    "KL_z": kl_z,
                    "KL_y": _last("kl_divergence_y"),
                }
            )
            for accuracy_key in ("accuracy", "superset_accuracy"):
                values = metrics_data.get(accuracy_key)
                if values:
                    report_parts.append(
                        "{}: {:6.2f} %".format(accuracy_key, 100 * values[-1])
                    )

            # Predictions → clustering metric fields + correlation sets.
            for prediction in (record.get("predictions") or {}).values():
                method = prediction.get("prediction method") or "model"
                classes = prediction.get("number of classes")
                prediction_string = f"{method} ({classes} classes)"
                if not _match_string(
                    prediction_string,
                    prediction_included_strings,
                    prediction_excluded_strings,
                ):
                    continue
                clustering_values = prediction.get(
                    "clustering metric values", {}
                )
                if clustering_values:
                    report_parts.append(prediction_string + ":")
                for metric_name, set_metrics in clustering_values.items():
                    if metric_name not in CLUSTERING_METRICS:
                        continue
                    report_parts.append(
                        "    {}:".format(capitalise_string(metric_name))
                    )
                    for set_name, set_value in (set_metrics or {}).items():
                        if set_value is None:
                            continue
                        set_value = float(set_value)
                        report_parts.append(
                            "        {}: {:.6g}".format(set_name, set_value)
                        )
                        if not set_name.startswith("clusters"):
                            continue
                        metric_key = "; ".join(
                            ["clustering", prediction_string, metric_name]
                        )
                        if "superset" in set_name:
                            metric_key += " (superset)"
                        summary_metrics[metric_key] = set_value
                        if set_value == 0:
                            continue
                        correlation_set_name = "; ".join(
                            [prediction_string, metric_name, set_name]
                        )
                        correlation_set = correlation_sets.setdefault(
                            correlation_set_name,
                            {"ELBO": [], "clustering metric": []},
                        )
                        if summary_metrics["ELBO"] is not None:
                            correlation_set["ELBO"].append(
                                summary_metrics["ELBO"]
                            )
                            correlation_set["clustering metric"].append(
                                set_value
                            )

            version_title = "; ".join(
                [f"{number_of_epochs} epochs", version_fields["version"]]
                + version_fields["samples"]
            )
            if len(versions) > 1:
                log_string_parts.append(capitalise_string(version_title))
            log_string_parts.append("\n".join(report_parts) + "\n")

            flat_rows.append(
                {
                    "run": run_name,
                    "version": version_name,
                    **{
                        key: value
                        for key, value in summary_metrics.items()
                        if not key.startswith("clustering")
                    },
                }
            )
            for key, value in summary_metrics.items():
                if key.startswith("clustering"):
                    metric_name = key.split("; ")[-1]
                    column = ABBREVIATIONS.get(metric_name, metric_name)
                    if key.endswith("(superset)"):
                        column += " (superset)"
                    row = flat_rows[-1]
                    if column not in row or value > row[column]:
                        row[column] = value

            version_key = "; ".join(
                [version_fields["version"]] + version_fields["samples"]
            )
            version_epoch_summary_metrics.setdefault(version_key, {})[
                number_of_epochs or 0
            ] = summary_metrics

        # Longest-trained variant represents each version of this run.
        for version_key, by_epochs in version_epoch_summary_metrics.items():
            summary_metrics = by_epochs[max(by_epochs)]
            slot = run_version_summary_metrics[run_key].setdefault(
                version_key, {"runs": 0, "version": version_key}
            )
            slot["runs"] += 1
            for metric_key, metric_value in summary_metrics.items():
                if run_key == "default":
                    slot[metric_key] = metric_value
                else:
                    slot.setdefault(metric_key, [])
                    slot[metric_key].append(metric_value)

    # Reshape into one summary set per clustering method
    # (reference :1810-1860).
    summary_metrics_sets = []
    for run_key, version_summary_metrics in run_version_summary_metrics.items():
        for version_key, summary_metrics in version_summary_metrics.items():
            summary_metrics = dict(summary_metrics)
            if run_key == "default":
                summary_metrics["runs"] = "D"
            else:
                summary_metrics["runs"] = str(summary_metrics["runs"])

            clustering_fields = [
                name
                for name in summary_metrics
                if name.startswith("clustering")
            ]
            by_method: dict[str, dict[str, Any]] = {}
            for field_name in clustering_fields:
                value = summary_metrics.pop(field_name)
                _, prediction_string, metric_name = field_name.split(
                    "; ", maxsplit=2
                )
                by_method.setdefault(prediction_string, {})[
                    metric_name
                ] = value
            if by_method:
                for prediction_string, metric_values in by_method.items():
                    method_set = dict(summary_metrics)
                    method_set.update(metric_values)
                    method_set["clustering method"] = prediction_string
                    summary_metrics_sets.append(method_set)
            else:
                summary_metrics_sets.append(summary_metrics)

    return {
        "summary_metrics_sets": summary_metrics_sets,
        "correlation_sets": correlation_sets,
        "log_string_parts": log_string_parts,
        "flat_rows": flat_rows,
    }


# --------------------------------------------------------------------------
# Other-method baselines
# --------------------------------------------------------------------------


def _metrics_for_other_methods(
    data_set_directory: str,
    other_methods,
    prediction_included_strings=None,
    prediction_excluded_strings=None,
) -> dict[str, dict[str, dict[str, list[float]]]]:
    """Baseline metrics from ``<data set directory>/<method>/``
    prediction pickles: set kind (standard/superset/unsupervised) →
    method → metric → [values] (reference
    ``cross_analysis.py:1385-1529``)."""
    if other_methods is None:
        other_methods = []
    elif not isinstance(other_methods, (list, tuple)):
        other_methods = [other_methods]

    other_method_metrics: dict[str, dict[str, dict[str, list[float]]]] = {}
    for other_method in other_methods:
        method_title = None
        for proper_name, spellings in OTHER_METHOD_NAMES.items():
            if normalise_string(other_method) in spellings + [
                normalise_string(proper_name)
            ]:
                method_title = proper_name
                break
        if method_title is None:
            method_title = other_method
        method_directory = os.path.join(
            data_set_directory, normalise_string(method_title)
        )
        if not os.path.isdir(method_directory):
            continue
        for root, _dirs, files in os.walk(method_directory):
            for filename in files:
                if not (
                    filename.startswith(PREDICTION_BASENAME)
                    and filename.endswith(ZIPPED_PICKLE_EXTENSION)
                ):
                    continue
                if not _match_string(
                    filename,
                    prediction_included_strings,
                    prediction_excluded_strings,
                ):
                    continue
                with gzip.open(os.path.join(root, filename), "rb") as f:
                    prediction = pickle.load(f)
                method = prediction.get("prediction method")
                if method and normalise_string(str(method)) not in (
                    OTHER_METHOD_NAMES.get(method_title, [])
                    + [normalise_string(method_title)]
                ):
                    method = f"{method_title} + {method}"
                else:
                    method = method_title
                clustering_values = prediction.get(
                    "clustering metric values", {}
                )
                for metric_name, set_metrics in clustering_values.items():
                    kind = CLUSTERING_METRICS.get(metric_name, {}).get("kind")
                    for set_name, value in (set_metrics or {}).items():
                        if value is None or not set_name.startswith(
                            "clusters"
                        ):
                            continue
                        if kind == "supervised":
                            group = (
                                "superset"
                                if "superset" in set_name
                                else "standard"
                            )
                        elif kind == "unsupervised":
                            group = "unsupervised"
                        else:
                            continue
                        other_method_metrics.setdefault(group, {}).setdefault(
                            method, {}
                        ).setdefault(metric_name, []).append(float(value))
    return other_method_metrics


# --------------------------------------------------------------------------
# Comparison-table formatting
# --------------------------------------------------------------------------


def _format_field_value(value) -> str:
    if value is None:
        return ""
    if isinstance(value, str):
        return value
    if isinstance(value, float):
        return "{:-.6g}".format(value)
    if isinstance(value, (int, np.integer)):
        return "{:d}".format(int(value))
    if isinstance(value, list):
        values = [v for v in value if v is not None]
        if not values:
            return "---"
        array = np.asarray(values, dtype=np.float64)
        mean = array.mean()
        sd = array.std(ddof=1) if array.size > 1 else 0.0
        if all(isinstance(v, (int, np.integer)) for v in values):
            return "{:.0f}±{:.3g}".format(mean, sd)
        return "{:-.6g}±{:.3g}".format(mean, sd)
    raise TypeError(
        f"`{type(value)}` not supported in comparison table."
    )


def _comparison_table_column_sorter(name: str):
    names = SORTED_COMPARISON_TABLE_COLUMN_NAMES
    if name in names:
        return (names.index(name), name)
    for index, column_name in enumerate(names):
        if name.startswith(column_name):
            return (index, name)
    return (len(names), name)


def _mean_of(value) -> float:
    if isinstance(value, list):
        values = [v for v in value if v is not None]
        return float(np.mean(values)) if values else -np.inf
    if value is None:
        return -np.inf
    return float(value)


def _compose_comparison_table(
    summary_metrics_sets: dict[str, dict[str, Any]],
) -> tuple[str, str]:
    """Fixed-width comparison table + common-fields footer (reference
    ``cross_analysis.py:640-800``)."""
    field_names = set()
    for fields in summary_metrics_sets.values():
        field_names.update(fields)
    field_names = sorted(
        (n for n in field_names if n in SORTED_COMPARISON_TABLE_COLUMN_NAMES),
        key=_comparison_table_column_sorter,
    )

    formatted = {
        title: {
            name: _format_field_value(fields.get(name))
            for name in field_names
        }
        for title, fields in summary_metrics_sets.items()
    }

    # Factor out columns identical across all rows into a footer.
    common_fields = {}
    for name in list(field_names):
        values = {row[name] for row in formatted.values()}
        if len(values) == 1 and len(formatted) > 1:
            value = values.pop()
            for row in formatted.values():
                row.pop(name)
            field_names.remove(name)
            if value:
                common_fields[name] = value

    widths = {
        name: max(
            [len(row[name]) for row in formatted.values()]
            + [len(ABBREVIATIONS.get(name, name))]
        )
        for name in field_names
    }
    heading_cells = [
        "{:{}}".format(ABBREVIATIONS.get(name, name), widths[name])
        for name in field_names
    ]
    rows = ["  ".join(heading_cells)]
    rows.append("-" * len(rows[0]))
    order = sorted(
        summary_metrics_sets.items(),
        key=lambda item: _mean_of(item[1].get("ELBO")),
        reverse=True,
    )
    for title, _fields in order:
        rows.append(
            "  ".join(
                "{:{}}".format(formatted[title][name], widths[name])
                for name in field_names
            )
        )
    footer = "\n".join(
        "{}: {}".format(capitalise_string(name), value)
        for name, value in common_fields.items()
    )
    return "\n".join(rows), footer


# --------------------------------------------------------------------------
# Main entry point
# --------------------------------------------------------------------------


def cross_analyse(
    analyses_directory: str,
    data_set_included_strings=None,
    data_set_excluded_strings=None,
    model_included_strings=None,
    model_excluded_strings=None,
    prediction_included_strings=None,
    prediction_excluded_strings=None,
    additional_other_option=None,
    no_prediction_methods_for_gmvae_in_plots: bool = False,
    epoch_cut_off=None,
    other_methods=None,
    export_options=None,
    log_summary: bool | None = None,
    cross_analysis_directory: str | None = None,
) -> pd.DataFrame:
    """Aggregate all runs under ``analyses_directory`` into per-data-set
    comparison reports; writes the summary log, CSV, and cross-model
    figures into ``<analyses_directory>/cross_analysis/<filter name>``.
    Returns a flat per-(model, run, version) table."""
    import pandas as pd

    figures = import_figures("cross-analysis")

    if log_summary is None:
        log_summary = get_default("cross_analysis", "log_summary")

    # Filter-encoded output name (reference :316-345).
    name_parts = []
    for abbreviation, strings in (
        ("d", data_set_included_strings),
        ("D", data_set_excluded_strings),
        ("m", model_included_strings),
        ("M", model_excluded_strings),
        ("p", prediction_included_strings),
        ("P", prediction_excluded_strings),
    ):
        if strings:
            name_parts.append(
                "{}_{}".format(
                    abbreviation,
                    "_".join(str(s).replace(os.sep, "") for s in strings),
                )
            )
    if additional_other_option:
        name_parts.append(f"a_{additional_other_option}")
    if epoch_cut_off:
        name_parts.append(f"e_{epoch_cut_off}")
    cross_analysis_name = "-".join(name_parts) if name_parts else "all"
    if cross_analysis_directory is None:
        cross_analysis_directory = os.path.join(
            analyses_directory, "cross_analysis", cross_analysis_name
        )

    metrics_sets = _metrics_sets_in_analyses_directory(
        analyses_directory,
        data_set_included_strings,
        data_set_excluded_strings,
        model_included_strings,
        model_excluded_strings,
    )
    if not metrics_sets:
        print("No metrics found to cross-analyse.")
        return pd.DataFrame()

    log_string_parts: list[str] = []
    flat_rows: list[dict[str, Any]] = []
    figure_paths: list[str] = []
    model_ids = _generate_model_ids()

    for data_set, models in sorted(metrics_sets.items()):
        data_set_title = _data_set_title(data_set)
        log_string_parts.append(_title_string(data_set_title))

        summary_metrics_sets: dict[str, dict[str, Any]] = {}
        correlation_sets: dict[str, dict[str, list[float]]] = {}

        for model, runs in sorted(models.items()):
            spec = _parse_model_specifications(model)
            model_title = _model_title(spec)
            model_id = next(model_ids)
            log_string_parts.append(_subtitle_string(model_title))
            log_string_parts.append(f"ID: {model_id}\n")

            results = _parse_metrics_for_runs_and_versions_of_model(
                runs,
                prediction_included_strings=prediction_included_strings,
                prediction_excluded_strings=prediction_excluded_strings,
                epoch_cut_off=epoch_cut_off,
            )
            log_string_parts.extend(results["log_string_parts"])

            for row in results["flat_rows"]:
                flat_rows.append(
                    {
                        "model": os.path.join(data_set, model)
                        if data_set
                        else model,
                        "data set": data_set,
                        "ID": model_id,
                        "model type": spec["model type"],
                        "latent distribution": spec["latent distribution"],
                        "clusters": spec["clusters"],
                        "reconstruction distribution": spec[
                            "reconstruction distribution"
                        ],
                        "latent size": spec["latent size"],
                        **row,
                    }
                )

            for summary_set in results["summary_metrics_sets"]:
                summary_set = dict(summary_set)
                summary_set["ID"] = model_id
                summary_set["type"] = _model_type_title(spec)
                summary_set["likelihood"] = _likelihood_title(spec)
                summary_set["sizes"] = _sizes_title(spec)
                summary_set["other"] = _other_title(spec)
                summary_set["version"] = ABBREVIATIONS.get(
                    summary_set["version"].split("; ")[0],
                    summary_set["version"],
                )
                if "clustering method" in summary_set:
                    match = re.fullmatch(
                        r"(.+?) \((\d+) classes\)",
                        summary_set["clustering method"],
                    )
                    summary_set["clustering method"] = (
                        _clustering_method_title(*match.groups())
                        if match
                        else _clustering_method_title(
                            summary_set["clustering method"], None
                        )
                    )
                set_title = "; ".join(
                    [
                        model_title,
                        summary_set.get("clustering method", "---"),
                        summary_set["runs"],
                        summary_set["version"],
                    ]
                )
                summary_metrics_sets[set_title] = summary_set

            for set_name, set_metrics in results["correlation_sets"].items():
                merged = correlation_sets.setdefault(
                    set_name, {"ELBO": [], "clustering metric": []}
                )
                for key, values in set_metrics.items():
                    merged[key].extend(values)

        if not summary_metrics_sets:
            continue

        # --- Pearson correlation table + scatter (reference :487-532) ---
        correlation_rows = {}
        for set_name, set_metrics in correlation_sets.items():
            if len(set_metrics["ELBO"]) < 2:
                continue
            elbo = np.asarray(set_metrics["ELBO"], dtype=np.float64)
            metric = np.asarray(
                set_metrics["clustering metric"], dtype=np.float64
            )
            with np.errstate(all="ignore"):
                r = float(np.corrcoef(elbo, metric)[0, 1])
            if np.isfinite(r):
                correlation_rows[set_name] = {"r": r}
        if correlation_rows:
            correlation_table = pd.DataFrame(correlation_rows).T
            log_string_parts.append(_subtitle_string("Metric correlations"))
            log_string_parts.append(str(correlation_table) + "\n")
        if correlation_sets and any(
            s["ELBO"] for s in correlation_sets.values()
        ):
            figure_paths.append(
                figures.plot_correlations(
                    correlation_sets,
                    x_key="ELBO",
                    y_key="clustering metric",
                    x_label=OPTIMISED_METRIC_SYMBOLS["ELBO"],
                    y_label="",
                    name="correlations-" + (
                        data_set.replace(os.sep, "-") or "all"
                    ),
                    directory=cross_analysis_directory,
                )
            )

        # --- Other-method baselines (reference :536-546) ---
        set_other_method_metrics = None
        if other_methods:
            set_other_method_metrics = _metrics_for_other_methods(
                os.path.join(analyses_directory, data_set)
                if data_set
                else analyses_directory,
                other_methods,
                prediction_included_strings,
                prediction_excluded_strings,
            )

        # --- Architecture ELBO heat map (reference :575-638):
        # default-run end-of-training models grouped by (type, likelihood,
        # other); plot the group spanning the largest sizes grid. ---
        architecture_groups: dict[tuple, dict[str, dict[str, Any]]] = {}
        for fields in summary_metrics_sets.values():
            if fields.get("runs") != "D" or fields.get("ELBO") is None:
                continue
            sizes = fields.get("sizes") or ""
            if "×" not in sizes:
                continue
            hidden_sizes, latent_size = sizes.rsplit("×", maxsplit=1)
            group = architecture_groups.setdefault(
                (fields["type"], fields["likelihood"], fields["other"]), {}
            )
            cell = group.setdefault(latent_size, {})
            variant = {
                "version": fields.get("version"),
                "epochs": fields.get("epochs"),
                "ELBO": fields["ELBO"],
            }
            if hidden_sizes not in cell or _best_variant(
                variant, cell[hidden_sizes]
            ) is variant:
                cell[hidden_sizes] = variant
        best_group = None
        best_cells = 0
        for group in architecture_groups.values():
            cells = sum(len(column) for column in group.values())
            if cells > best_cells:
                best_cells = cells
                best_group = group
        if best_group is not None and best_cells > 1:
            frame = pd.DataFrame(
                {
                    latent: {
                        hidden: variant["ELBO"]
                        for hidden, variant in column.items()
                    }
                    for latent, column in best_group.items()
                }
            )
            frame = frame.reindex(
                columns=sorted(frame.columns, key=int),
                index=sorted(
                    frame.index,
                    key=lambda s: np.prod([int(x) for x in s.split("×")]),
                ),
            )
            if frame.size > 1:
                figure_paths.append(
                    figures.plot_elbo_heat_map(
                        frame,
                        x_label="Latent dimension",
                        y_label="Number of hidden units",
                        z_label=OPTIMISED_METRIC_SYMBOLS["ELBO"],
                        name="elbo_heat_map-" + (
                            data_set.replace(os.sep, "-") or "all"
                        ),
                        directory=cross_analysis_directory,
                    )
                )

        # --- Comparison table (reference :640-800) ---
        comparison_table, common_fields = _compose_comparison_table(
            summary_metrics_sets
        )
        log_string_parts.append(_subtitle_string("Comparison"))
        log_string_parts.append(comparison_table + "\n")
        if common_fields:
            log_string_parts.append(common_fields + "\n")

        if set_other_method_metrics:
            baseline_parts = ["Other methods:"]
            for group, methods in set_other_method_metrics.items():
                for method, metric_values in methods.items():
                    baseline_parts.append(f"    {method}:")
                    for metric_name, values in metric_values.items():
                        label = metric_name
                        if group == "superset":
                            label += " (superset)"
                        baseline_parts.append(
                            "        {}: {}".format(
                                label, _format_field_value(list(values))
                            )
                        )
            log_string_parts.append("\n".join(baseline_parts) + "\n")

        # --- Model-metric figures (reference :823-1283) ---
        figure_paths.extend(
            _plot_data_set_model_metrics(
                figures,
                data_set,
                summary_metrics_sets,
                set_other_method_metrics,
                additional_other_option=additional_other_option,
                no_prediction_methods_for_gmvae_in_plots=(
                    no_prediction_methods_for_gmvae_in_plots
                ),
                directory=cross_analysis_directory,
            )
        )

    # --- Flat per-run table: CSV + return value ---
    if not flat_rows:
        print("No runs within the filters/epoch cut-off.")
        return pd.DataFrame()
    table = pd.DataFrame(flat_rows).set_index("model")
    if "ELBO" in table.columns:
        table = table.sort_values("ELBO", ascending=False)
    os.makedirs(cross_analysis_directory, exist_ok=True)
    table.to_csv(os.path.join(cross_analysis_directory, "comparison.csv"))

    log_string = "\n".join(log_string_parts)
    print(log_string)
    if log_summary:
        log_path = os.path.join(
            cross_analysis_directory, cross_analysis_name + LOG_EXTENSION
        )
        with open(log_path, "w") as f:
            f.write(log_string + "\n")

    return table


def _plot_data_set_model_metrics(
    figures,
    data_set: str,
    summary_metrics_sets: dict[str, dict[str, Any]],
    set_other_method_metrics,
    additional_other_option=None,
    no_prediction_methods_for_gmvae_in_plots: bool = False,
    directory: str = ".",
) -> list[str]:
    """Per-metric model plots and metric-vs-clustering scatter plots for
    one data set (reference ``cross_analysis.py:851-1283``)."""
    data_set_tag = data_set.replace(os.sep, "-") or "all"
    paths: list[str] = []

    # Pick the most common architecture per model type among multi-run
    # models so plots compare like against like (reference :851-886);
    # fall back to all models (incl. default runs) when nothing survives.
    filter_fields: dict[str, dict[str, str]] = {}
    for fields in summary_metrics_sets.values():
        if not str(fields.get("runs", "")).isdigit():
            continue
        model_type = fields.get("type")
        if not model_type:
            continue
        for filter_name in ("sizes", "other"):
            filter_fields.setdefault(model_type, {}).setdefault(
                filter_name, []
            ).append(fields.get(filter_name) or "")
    for model_type, per_field in filter_fields.items():
        for filter_name, values in per_field.items():
            try:
                per_field[filter_name] = statistics.mode(values)
            except statistics.StatisticsError:
                per_field[filter_name] = values[0]

    def _selected(fields) -> bool:
        model_type = fields.get("type")
        if model_type in filter_fields:
            for filter_name, filter_value in filter_fields[
                model_type
            ].items():
                field_value = fields.get(filter_name) or ""
                if filter_name == "other" and additional_other_option:
                    field_parts = set(field_value.split("; ")) - {
                        additional_other_option
                    }
                    field_value = "; ".join(sorted(field_parts - {""}))
                    filter_value = "; ".join(
                        sorted(set(filter_value.split("; ")) - {""})
                    )
                if field_value != filter_value:
                    return False
            return not fields.get("runs") == "D"
        return False

    selected = [
        fields
        for fields in summary_metrics_sets.values()
        if _selected(fields)
    ]
    if not selected:
        selected = list(summary_metrics_sets.values())

    optimised_metric_names = ["ELBO", "ENRE", "KL_z"]
    if any(str(f.get("type", "")).startswith("GMVAE") for f in selected):
        optimised_metric_names.append("KL_y")

    # Best variant per (method, likelihood) — method = model type plus the
    # prediction method when it isn't the model's own clustering
    # (reference :920-1056).
    supervised_names = [
        n for n, d in CLUSTERING_METRICS.items() if d["kind"] == "supervised"
    ]
    unsupervised_names = [
        n
        for n, d in CLUSTERING_METRICS.items()
        if d["kind"] == "unsupervised"
    ]

    def _variant_of(fields) -> dict:
        return {
            "other": fields.get("other"),
            "version": fields.get("version"),
            "epochs": fields.get("epochs"),
        }

    def _has_value(value) -> bool:
        if isinstance(value, list):
            return any(v is not None for v in value)
        return value is not None

    winners: dict[tuple[str, str], dict] = {}
    for fields in selected:
        model_type = fields.get("type") or "?"
        if model_type == FACTOR_ANALYSIS_MODEL_TYPE:
            model_type = FACTOR_ANALYSIS_MODEL_TYPE_ALIAS
        clustering_method = fields.get("clustering method")
        method_parts = [model_type]
        if clustering_method and clustering_method not in ("M", "---"):
            method_parts.append(clustering_method.replace(", ", "-"))
        method = "-".join(method_parts)
        if (
            no_prediction_methods_for_gmvae_in_plots
            and model_type.startswith("GMVAE")
            and clustering_method
            and clustering_method != "M"
        ):
            continue
        likelihood = fields.get("likelihood") or "?"
        key = (method, likelihood)
        if key in winners:
            variant, previous = _variant_of(fields), _variant_of(
                winners[key]
            )
            if (
                _best_variant(
                    variant,
                    previous,
                    additional_other_option=additional_other_option,
                )
                is previous
            ):
                continue
        winners[key] = fields

    model_likelihood_metrics: dict[str, dict[str, dict]] = {}
    set_method_likelihood_metrics: dict[str, dict[str, dict[str, dict]]] = {
        "standard": {},
        "superset": {},
        "unsupervised": {},
    }
    for (method, likelihood), fields in winners.items():
        model_type = method.split("-")[0]
        optimised = {
            name: fields.get(name)
            for name in optimised_metric_names
            if _has_value(fields.get(name))
        }
        model_likelihood_metrics.setdefault(model_type, {})[
            likelihood
        ] = optimised
        for metric_name in supervised_names:
            value = fields.get(metric_name)
            if _has_value(value):
                entry = set_method_likelihood_metrics["standard"].setdefault(
                    method, {}
                ).setdefault(likelihood, dict(optimised))
                entry[metric_name] = value
            superset_value = fields.get(metric_name + " (superset)")
            if _has_value(superset_value):
                entry = set_method_likelihood_metrics["superset"].setdefault(
                    method, {}
                ).setdefault(likelihood, dict(optimised))
                entry[metric_name] = superset_value
        for metric_name in unsupervised_names:
            value = fields.get(metric_name)
            if _has_value(value):
                entry = set_method_likelihood_metrics[
                    "unsupervised"
                ].setdefault(method, {}).setdefault(
                    likelihood, dict(optimised)
                )
                entry[metric_name] = value

    if not model_likelihood_metrics:
        return paths

    likelihood_order = sorted(
        {
            likelihood
            for likelihoods in model_likelihood_metrics.values()
            for likelihood in likelihoods
        },
        key=lambda s: (
            LIKELIHOOD_DISTRIBUTION_ORDER.index(re.sub(r"\(.+\)", "", s))
            if re.sub(r"\(.+\)", "", s) in LIKELIHOOD_DISTRIBUTION_ORDER
            else len(LIKELIHOOD_DISTRIBUTION_ORDER),
            s,
        ),
    )

    def _type_order_key(s: str):
        base = re.sub(r"\(.+\)", "", re.sub(r"-.*", "", s))
        return (
            MODEL_TYPE_ORDER.index(base)
            if base in MODEL_TYPE_ORDER
            else len(MODEL_TYPE_ORDER),
            s,
        )

    model_order = sorted(model_likelihood_metrics, key=_type_order_key)

    # Optimised metrics per model type × likelihood.
    metrics_sets = [
        {"model": model, "likelihood": likelihood, **metric_values}
        for model, likelihoods in model_likelihood_metrics.items()
        for likelihood, metric_values in likelihoods.items()
    ]
    for metric_name in optimised_metric_names:
        if not any(metric_name in m for m in metrics_sets):
            continue
        paths.append(
            figures.plot_model_metrics(
                metrics_sets,
                key=metric_name,
                label=OPTIMISED_METRIC_SYMBOLS.get(metric_name, metric_name),
                primary_differentiator_key="model",
                primary_differentiator_order=model_order,
                secondary_differentiator_key="likelihood",
                secondary_differentiator_order=likelihood_order,
                name=f"model_metrics-{data_set_tag}-{metric_name}",
                directory=directory,
            )
        )

    # Optimised metric vs clustering metric per evaluation-set kind.
    for set_name, method_likelihood_metrics in (
        set_method_likelihood_metrics.items()
    ):
        if not method_likelihood_metrics:
            continue
        method_order = sorted(method_likelihood_metrics, key=_type_order_key)
        special_cases = {}
        for method in method_order:
            for other_method in method_order:
                if other_method != method and other_method.startswith(
                    method
                ):
                    special_cases[method] = {"errorbar_colour": "darken"}
        baseline_metrics = (
            set_other_method_metrics.get(set_name)
            if set_other_method_metrics
            else None
        )
        clustering_metric_names = (
            unsupervised_names if set_name == "unsupervised" else supervised_names
        )
        method_metrics_sets = [
            {"method": method, "likelihood": likelihood, **metric_values}
            for method, likelihoods in method_likelihood_metrics.items()
            for likelihood, metric_values in likelihoods.items()
        ]
        for optimised_name, clustering_name in product(
            optimised_metric_names, clustering_metric_names
        ):
            if not any(
                optimised_name in m and clustering_name in m
                for m in method_metrics_sets
            ):
                continue
            paths.append(
                figures.plot_model_metric_sets(
                    method_metrics_sets,
                    x_key=optimised_name,
                    y_key=clustering_name,
                    x_label=OPTIMISED_METRIC_SYMBOLS.get(
                        optimised_name, optimised_name
                    ),
                    y_label=CLUSTERING_METRICS[clustering_name]["symbol"],
                    primary_differentiator_key="likelihood",
                    primary_differentiator_order=likelihood_order,
                    secondary_differentiator_key="method",
                    secondary_differentiator_order=method_order,
                    special_cases=special_cases,
                    other_method_metrics=baseline_metrics,
                    name="model_metric_sets-{}-{}-{}-{}".format(
                        data_set_tag,
                        set_name,
                        ABBREVIATIONS.get(clustering_name, clustering_name),
                        optimised_name,
                    ),
                    directory=directory,
                )
            )
    return paths
