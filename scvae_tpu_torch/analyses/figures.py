"""Figures: learning curves, latent scatters with centroid ellipses,
histograms, heat maps, profile comparisons, and image sprite sheets (the
port's copy of ``scvae_tpu/analyses/figures.py``, the reference's
``scvae/analyses/figures/``).

The same functions, file names, DPI and seaborn style as the JAX
package's, drawn with matplotlib and seaborn on the Agg backend on the
host; from the same inputs they write the same PNG files.  The one
computation, the centroid means' PCA in ``plot_centroid_means_evolution``,
runs on ``device`` (CUDA unless ``"cpu"``).  Importing this module needs
matplotlib and seaborn; the orchestrators import it only where they draw.
Every function returns the saved path.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import matplotlib

matplotlib.use("Agg")

import matplotlib.patches  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse  # noqa: E402
import seaborn  # noqa: E402

from scvae_tpu_torch.utils.strings import normalise_string  # noqa: E402

FIGURE_DPI = 150
PUBLICATION_DPI = 350

seaborn.set(style="ticks", context="notebook")


def _save(figure, name: str, directory: str, *, for_publication: bool = False) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, normalise_string(name) + ".png")
    figure.savefig(
        path,
        dpi=PUBLICATION_DPI if for_publication else FIGURE_DPI,
        bbox_inches="tight",
    )
    plt.close(figure)
    return path


def _densify(values):
    if scipy.sparse.issparse(values):
        return np.asarray(values.todense())
    return np.asarray(values)


def _class_palette(class_names: Sequence) -> dict:
    colours = seaborn.color_palette("husl", len(class_names))
    return dict(zip(class_names, colours))


# --------------------------------------------------------------------------
# Learning curves (reference figures/learning_curves.py:31-485)
# --------------------------------------------------------------------------


def plot_learning_curves(
    curves: dict[str, dict[str, list[float]]],
    model_type: str = "VAE",
    name: str = "learning_curves",
    directory: str = ".",
) -> str:
    """Loss curves per subset: ELBO, reconstruction error, KL terms."""
    metric_names = sorted(
        {m for kind in curves.values() for m in kind.keys()}
    )
    # Plot the headline metrics, one panel per metric.
    panels = [
        m
        for m in (
            "lower_bound",
            "reconstruction_error",
            "kl_divergence",
            "kl_divergence_z",
            "kl_divergence_y",
            "accuracy",
        )
        if m in metric_names
    ] or metric_names
    fig, axes = plt.subplots(
        len(panels), 1, figsize=(7, 2.6 * len(panels)), squeeze=False,
        sharex=True,
    )
    for ax, metric in zip(axes[:, 0], panels):
        for kind, kind_curves in curves.items():
            if metric in kind_curves:
                values = kind_curves[metric]
                ax.plot(
                    np.arange(1, len(values) + 1), values, label=kind
                )
        ax.set_ylabel(metric.replace("_", " "))
        ax.legend(frameon=False, fontsize="small")
    axes[-1, 0].set_xlabel("epoch")
    fig.suptitle(f"{model_type} learning curves")
    return _save(fig, name, directory)


def plot_kl_divergence_evolution(
    kl_neurons: np.ndarray,
    name: str = "kl_divergence_evolution",
    directory: str = ".",
) -> str:
    """Heat map of per-latent-dimension KL over epochs (sorted by final
    KL, log scale; reference ``learning_curves.py`` KL-neuron panel)."""
    kl_neurons = np.asarray(kl_neurons)  # (E, D)
    order = np.argsort(kl_neurons[-1])[::-1]
    fig, ax = plt.subplots(figsize=(7, 4))
    with np.errstate(divide="ignore"):
        log_kl = np.log10(np.maximum(kl_neurons[:, order], 1e-12))
    image = ax.imshow(
        log_kl.T, aspect="auto", origin="lower", cmap="viridis"
    )
    fig.colorbar(image, ax=ax, label="log10 KL")
    ax.set_xlabel("epoch")
    ax.set_ylabel("latent dimension (sorted)")
    return _save(fig, name, directory)


def plot_accuracy_evolution(
    accuracies: dict[str, list[float]],
    name: str = "accuracy_evolution",
    directory: str = ".",
) -> str:
    fig, ax = plt.subplots(figsize=(7, 3))
    for kind, values in accuracies.items():
        ax.plot(np.arange(1, len(values) + 1), values, label=kind)
    ax.set_xlabel("epoch")
    ax.set_ylabel("accuracy")
    ax.legend(frameon=False)
    return _save(fig, name, directory)


def plot_separate_learning_curves(
    curves: dict[str, dict[str, list[float]]],
    loss,
    name: str = "learning_curves",
    directory: str = ".",
) -> str:
    """One figure overlaying the chosen loss curve(s) across subsets —
    training solid, validation dashed (reference
    ``learning_curves.py:144-229``)."""
    losses = list(loss) if isinstance(loss, (list, tuple)) else [loss]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for kind in sorted(curves):
        line_style = "solid" if kind == "training" else "dashed"
        for metric in losses:
            values = curves[kind].get(metric)
            if values is None:
                continue
            ax.plot(
                np.arange(1, len(values) + 1),
                values,
                linestyle=line_style,
                label=f"{metric.replace('_', ' ')} ({kind} set)",
            )
    ax.set_xlabel("epoch")
    ax.set_ylabel("nat")
    handles, labels = ax.get_legend_handles_labels()
    if handles:
        labels, handles = zip(*sorted(zip(labels, handles)))
        ax.legend(handles, labels, frameon=False, fontsize="small")
    full_name = "-".join([name] + losses)
    return _save(fig, full_name, directory)


def plot_probabilities(
    posterior_probabilities=None,
    prior_probabilities=None,
    x_label: str = "$k$",
    y_label: str | None = None,
    name: str = "probabilities",
    directory: str = ".",
) -> str:
    """Bar chart of mixture probabilities per cluster: posterior as bars,
    prior as dashed level lines (reference ``histograms.py:259-334``)."""
    if posterior_probabilities is None and prior_probabilities is None:
        raise ValueError("No posterior nor prior probabilities given.")
    fig, ax = plt.subplots(figsize=(7, 4))
    if posterior_probabilities is not None:
        posterior_probabilities = np.asarray(posterior_probabilities)
        k_range = np.arange(len(posterior_probabilities))
        ax.bar(k_range, posterior_probabilities, color="C0")
        ax.set_ylabel(y_label or r"$\pi_{\phi}^k$")
        if prior_probabilities is not None:
            prior_probabilities = np.asarray(prior_probabilities)
            for k, p in enumerate(prior_probabilities):
                ax.plot([k - 0.4, k + 0.4], [p, p], "k--")
            ax.plot([], [], "k--", label=r"$\pi_{\theta}^k$")
            ax.legend(frameon=False)
    else:
        prior_probabilities = np.asarray(prior_probabilities)
        ax.bar(
            np.arange(len(prior_probabilities)),
            prior_probabilities,
            color="C0",
        )
        ax.set_ylabel(y_label or r"$\pi_{\theta}^k$")
    ax.set_xlabel(x_label)
    return _save(fig, name, directory)


def plot_centroid_probabilities_evolution(
    probabilities: np.ndarray,
    name: str = "centroid_probabilities_evolution",
    directory: str = ".",
) -> str:
    """(E, K) mixture-probability evolution."""
    probabilities = np.asarray(probabilities)
    fig, ax = plt.subplots(figsize=(7, 3))
    for k in range(probabilities.shape[1]):
        ax.plot(
            np.arange(1, probabilities.shape[0] + 1),
            probabilities[:, k],
            label=f"cluster {k + 1}",
        )
    ax.set_xlabel("epoch")
    ax.set_ylabel("probability")
    ax.legend(frameon=False, fontsize="x-small", ncol=2)
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Latent scatter (reference figures/scatter.py:29-476)
# --------------------------------------------------------------------------


def _covariance_ellipse(mean, covariance, colour, ax, n_std=2.0):
    eigenvalues, eigenvectors = np.linalg.eigh(covariance)
    angle = float(
        np.degrees(np.arctan2(eigenvectors[1, -1], eigenvectors[0, -1]))
    )
    width, height = 2 * n_std * np.sqrt(np.maximum(eigenvalues, 0))
    ellipse = matplotlib.patches.Ellipse(
        xy=mean,
        width=width,
        height=height,
        angle=angle,
        edgecolor=colour,
        facecolor="none",
        linewidth=2,
    )
    ax.add_patch(ellipse)


def plot_values(
    values,
    colour_coding: np.ndarray | None = None,
    colour_coding_title: str = "class",
    centroids: dict[str, Any] | None = None,
    name: str = "latent_space",
    directory: str = ".",
    axis_labels: tuple[str, str] = ("component 1", "component 2"),
) -> str:
    """2-D scatter with optional label colouring and GM centroid means +
    covariance ellipses (``figures/utilities.py:86``)."""
    values = _densify(values)[:, :2]
    fig, ax = plt.subplots(figsize=(6, 6))
    if colour_coding is not None:
        colour_coding = np.asarray(colour_coding)
        class_names = sorted(np.unique(colour_coding).tolist(), key=str)
        palette = _class_palette(class_names)
        for class_name in class_names:
            idx = colour_coding == class_name
            ax.scatter(
                values[idx, 0],
                values[idx, 1],
                s=4,
                alpha=0.6,
                color=palette[class_name],
                label=str(class_name),
                linewidths=0,
            )
        ax.legend(
            frameon=False, fontsize="x-small", markerscale=2,
            title=colour_coding_title, loc="best",
        )
    else:
        ax.scatter(values[:, 0], values[:, 1], s=4, alpha=0.6, linewidths=0)

    if centroids and centroids.get("means") is not None:
        means = np.asarray(centroids["means"])
        means = means.reshape(-1, means.shape[-1])[:, :2]
        covariances = centroids.get("covariance_matrices")
        colours = seaborn.color_palette("deep", means.shape[0])
        for k, mean in enumerate(means):
            ax.scatter(
                mean[0], mean[1], marker="x", s=60, color=colours[k],
                zorder=3,
            )
            if covariances is not None:
                cov = np.asarray(covariances).reshape(
                    -1, covariances.shape[-2], covariances.shape[-1]
                )[k][:2, :2]
                _covariance_ellipse(mean, cov, colours[k], ax)

    ax.set_xlabel(axis_labels[0])
    ax.set_ylabel(axis_labels[1])
    seaborn.despine(fig)
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Histograms (reference figures/histograms.py)
# --------------------------------------------------------------------------


def plot_histogram(
    values,
    name: str = "histogram",
    directory: str = ".",
    discrete: bool = False,
    normed: bool = False,
    scale: str = "linear",
    label: str = "value",
) -> str:
    values = _densify(values).flatten()
    fig, ax = plt.subplots(figsize=(6, 4))
    if discrete:
        maximum = int(min(values.max(), 200))
        bins = np.arange(maximum + 2) - 0.5
    else:
        bins = "auto"
    ax.hist(values, bins=bins, density=normed)
    ax.set_yscale(scale)
    ax.set_xlabel(label)
    ax.set_ylabel("frequency" if not normed else "density")
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_class_histogram(
    labels,
    class_names: Sequence | None = None,
    normed: bool = False,
    name: str = "class_histogram",
    directory: str = ".",
) -> str:
    labels = np.asarray(labels)
    if class_names is None:
        class_names = np.unique(labels).tolist()
    counts = np.array([(labels == c).sum() for c in class_names], float)
    if normed:
        counts = counts / counts.sum()
    fig, ax = plt.subplots(figsize=(max(6, 0.4 * len(class_names)), 4))
    ax.bar(np.arange(len(class_names)), counts)
    ax.set_xticks(np.arange(len(class_names)))
    ax.set_xticklabels([str(c) for c in class_names], rotation=90, fontsize=7)
    ax.set_ylabel("fraction" if normed else "count")
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_cutoff_count_histogram(
    values,
    cutoff: int = 10,
    name: str = "cutoff_count_histogram",
    directory: str = ".",
) -> str:
    """Histogram of counts with everything ≥ cutoff pooled."""
    values = _densify(values).flatten()
    clipped = np.minimum(values, cutoff)
    fig, ax = plt.subplots(figsize=(6, 4))
    bins = np.arange(cutoff + 2) - 0.5
    ax.hist(clipped, bins=bins)
    ax.set_yscale("log")
    labels = [str(k) for k in range(cutoff)] + [f"≥{cutoff}"]
    ax.set_xticks(np.arange(cutoff + 1))
    ax.set_xticklabels(labels)
    ax.set_xlabel("count")
    seaborn.despine(fig)
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Heat maps / matrices (reference figures/matrices.py)
# --------------------------------------------------------------------------


def plot_heat_map(
    values,
    labels: np.ndarray | None = None,
    name: str = "heat_map",
    directory: str = ".",
    x_label: str = "feature",
    y_label: str = "example",
    z_label: str = "value",
    z_symbol: str | None = None,
    center: float | None = None,
) -> str:
    """Value heat map with rows optionally sorted by labels
    (reference ``subanalyses.py:294``)."""
    values = _densify(values)
    if labels is not None:
        order = np.argsort(np.asarray(labels, dtype=str), kind="stable")
        values = values[order]
    fig, ax = plt.subplots(figsize=(6, 5))
    image = ax.imshow(
        values,
        aspect="auto",
        cmap="RdBu_r" if center is not None else "viridis",
        interpolation="nearest",
    )
    fig.colorbar(image, ax=ax, label=z_symbol or z_label)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label + (" (sorted by label)" if labels is not None else ""))
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Profile comparisons (reference figures/series.py)
# --------------------------------------------------------------------------


def plot_profile_comparison(
    observed,
    expected,
    expected_total_standard_deviations=None,
    expected_explained_standard_deviations=None,
    name: str = "profile_comparison",
    directory: str = ".",
    x_label: str = "feature (sorted by observed value)",
    y_label: str = "count",
) -> str:
    """Observed vs reconstructed profile for one cell, features sorted by
    observed value, with stddev bands."""
    observed = _densify(observed).flatten()
    expected = _densify(expected).flatten()
    order = np.argsort(observed)[::-1]
    x = np.arange(len(observed))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.scatter(x, observed[order], s=3, label="observed", zorder=3)
    ax.plot(x, expected[order], color="C1", label="expected")
    if expected_total_standard_deviations is not None:
        std_total = _densify(expected_total_standard_deviations).flatten()[order]
        ax.fill_between(
            x,
            expected[order] - std_total,
            expected[order] + std_total,
            alpha=0.2,
            color="C1",
            label="total std. dev.",
        )
    if expected_explained_standard_deviations is not None:
        std_explained = _densify(
            expected_explained_standard_deviations
        ).flatten()[order]
        ax.fill_between(
            x,
            expected[order] - std_explained,
            expected[order] + std_explained,
            alpha=0.35,
            color="C1",
            label="explained std. dev.",
        )
    ax.set_yscale("symlog")
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.legend(frameon=False, fontsize="small")
    seaborn.despine(fig)
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Image sprite sheets (reference images.py)
# --------------------------------------------------------------------------


def combine_images_from_data_set(
    data_set,
    number_of_random_examples: int | None = 100,
    name: str = "image_examples",
    directory: str = ".",
    seed: int = 70,
) -> str:
    """Tile example images (feature-dimensioned data like MNIST) into one
    sprite sheet (reference ``analyses/images.py``)."""
    dims = getattr(data_set, "feature_dimensions", None)
    if not dims:
        side = int(np.sqrt(data_set.number_of_features))
        dims = (side, side)
    values = _densify(data_set.values)
    if number_of_random_examples is not None and (
        values.shape[0] > number_of_random_examples
    ):
        rng = np.random.RandomState(seed)
        values = values[
            rng.permutation(values.shape[0])[:number_of_random_examples]
        ]
    n = values.shape[0]
    grid = int(np.ceil(np.sqrt(n)))
    h, w = dims
    sheet = np.zeros((grid * h, grid * w), values.dtype)
    for i in range(n):
        r, c = divmod(i, grid)
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = values[i].reshape(h, w)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(sheet, cmap="gray")
    ax.axis("off")
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Cross-model figures (reference figures/cross_model.py:26-330)
# --------------------------------------------------------------------------


def plot_correlations(
    correlation_sets,
    x_key: str,
    y_key: str,
    x_label: str | None = None,
    y_label: str | None = None,
    name: str = "correlations",
    directory: str = ".",
) -> str:
    """Scatter of one metric against another across model runs, one colour
    per correlation set (reference ``figures/cross_model.py:64-88``)."""
    if not isinstance(correlation_sets, dict):
        correlation_sets = {"correlations": correlation_sets}
    fig, ax = plt.subplots()
    seaborn.despine()
    ax.set_xlabel(x_label or x_key)
    ax.set_ylabel(y_label or y_key)
    for set_name, correlation_set in correlation_sets.items():
        ax.scatter(
            correlation_set[x_key], correlation_set[y_key], label=set_name
        )
    if len(correlation_sets) > 1:
        ax.legend(loc="best")
    return _save(fig, name, directory)


def plot_elbo_heat_map(
    data_frame,
    x_label: str,
    y_label: str,
    z_label: str | None = None,
    z_min: float | None = None,
    z_max: float | None = None,
    name: str = "ELBO_heat_map",
    directory: str = ".",
) -> str:
    """Annotated heat map of a metric over two model-hyperparameter axes
    (reference ``figures/cross_model.py:26-61``)."""
    fig, ax = plt.subplots()
    if z_min is None:
        z_min = float(np.nanmin(data_frame.values))
    if z_max is None:
        z_max = float(np.nanmax(data_frame.values))
    cbar_kws = {"label": z_label} if z_label else {}
    seaborn.heatmap(
        data_frame,
        vmin=z_min,
        vmax=z_max,
        xticklabels=True,
        yticklabels=True,
        cbar=True,
        cbar_kws=cbar_kws,
        annot=True,
        fmt=".6g",
        square=False,
        ax=ax,
    )
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    return _save(fig, name, directory)


def _metric_mean_sd(value) -> tuple[float, float] | None:
    """Scalar or list of run values → (mean, sd across runs); None when the
    value is missing or non-numeric."""
    if value is None:
        return None
    values = np.atleast_1d(np.asarray(value, dtype=object)).ravel()
    values = np.array([v for v in values if v is not None])
    if values.size == 0:
        return None
    try:
        values = values.astype(np.float64)
    except (TypeError, ValueError):
        return None
    ddof = 1 if values.size > 1 else 0
    return float(values.mean()), float(values.std(ddof=ddof))


def plot_model_metrics(
    metrics_sets,
    key: str,
    label: str | None = None,
    primary_differentiator_key: str = "model",
    primary_differentiator_order: Sequence[str] | None = None,
    secondary_differentiator_key: str | None = None,
    secondary_differentiator_order: Sequence[str] | None = None,
    name: str = "model_metrics",
    directory: str = ".",
) -> str:
    """Errorbar plot of one metric per model variant, grouped on the x-axis
    by the primary differentiator and coloured by the secondary one
    (reference ``figures/cross_model.py:91-223``).  ``metrics_sets`` is a
    list of dicts with the metric under ``key`` — a scalar or a list of
    per-run values (plotted as mean ± sd) — plus the differentiator
    fields."""
    if not isinstance(metrics_sets, list):
        metrics_sets = [metrics_sets]
    primary_values = list(primary_differentiator_order or [])
    for metrics_set in metrics_sets:
        value = str(metrics_set.get(primary_differentiator_key))
        if value not in primary_values:
            primary_values.append(value)
    if secondary_differentiator_key:
        secondary_values = list(secondary_differentiator_order or [])
        for metrics_set in metrics_sets:
            value = str(metrics_set.get(secondary_differentiator_key))
            if value not in secondary_values:
                secondary_values.append(value)
    else:
        secondary_values = ["all"]
    palette = seaborn.color_palette("husl", len(secondary_values))
    colours = dict(zip(secondary_values, palette))

    fig, ax = plt.subplots(figsize=(max(6, 1.3 * len(primary_values)), 4))
    seaborn.despine()
    seen = set()
    # Offsets spread secondary values around each primary position
    # (reference cross_model.py:117-151).
    x_gap = 1.0
    x_scale = len(secondary_values) - 1 + 2 * x_gap
    for metrics_set in metrics_sets:
        stats = _metric_mean_sd(metrics_set.get(key))
        if stats is None:
            continue
        mean, sd = stats
        primary = str(metrics_set.get(primary_differentiator_key))
        secondary = (
            str(metrics_set.get(secondary_differentiator_key))
            if secondary_differentiator_key
            else "all"
        )
        offset = (
            (secondary_values.index(secondary) + x_gap - x_scale / 2)
            / x_scale
        ) * 0.8
        ax.errorbar(
            x=primary_values.index(primary) + offset,
            y=mean,
            yerr=sd or None,
            capsize=2,
            marker="_",
            markersize=10,
            linestyle="",
            color=colours[secondary],
            label=secondary if secondary not in seen else None,
            zorder=3,
        )
        seen.add(secondary)
    ax.set_xticks(np.arange(len(primary_values)))
    ax.set_xticklabels(primary_values, rotation=30, ha="right", fontsize=8)
    ax.set_xlabel(primary_differentiator_key.capitalize() + "s")
    ax.set_ylabel(label or key)
    if secondary_differentiator_key and len(secondary_values) > 1:
        ax.legend(loc="best", fontsize=8)
    ax.grid(axis="y", alpha=0.3)
    return _save(fig, name, directory)


def plot_model_metric_sets(
    metrics_sets,
    x_key: str,
    y_key: str,
    x_label: str | None = None,
    y_label: str | None = None,
    primary_differentiator_key: str = "model",
    primary_differentiator_order: Sequence[str] | None = None,
    secondary_differentiator_key: str | None = None,
    secondary_differentiator_order: Sequence[str] | None = None,
    special_cases: dict | None = None,
    other_method_metrics: dict | None = None,
    name: str = "model_metric_sets",
    directory: str = ".",
) -> str:
    """Scatter of metric pairs (e.g. ELBO vs ARI) per model variant, one
    colour per primary-differentiator value and one marker per secondary
    one, values as mean ± sd over runs, with horizontal baseline lines or
    bands for non-model methods (reference
    ``figures/cross_model.py:226-456``).

    ``other_method_metrics`` maps method name → {metric: [values]}; methods
    with only ``y_key`` values become axhline/axhspan baselines, methods
    with both keys become labelled points."""
    if not isinstance(metrics_sets, list):
        metrics_sets = [metrics_sets]
    if other_method_metrics:
        name += "-other_methods"
    special_cases = special_cases or {}
    groups = list(primary_differentiator_order or [])
    for metrics_set in metrics_sets:
        value = str(metrics_set.get(primary_differentiator_key))
        if value not in groups:
            groups.append(value)
    if secondary_differentiator_key:
        marker_groups = list(secondary_differentiator_order or [])
        for metrics_set in metrics_sets:
            value = str(metrics_set.get(secondary_differentiator_key))
            if value not in marker_groups:
                marker_groups.append(value)
    else:
        marker_groups = ["all"]
    palette = seaborn.color_palette("husl", len(groups))
    colours = dict(zip(groups, palette))
    marker_styles = ["X", "s", "D", "o", "P", "^", "p", "*"]

    fig, ax = plt.subplots(figsize=(8, 5.5))
    seaborn.despine()
    seen = set()
    for metrics_set in metrics_sets:
        x_stats = _metric_mean_sd(metrics_set.get(x_key))
        y_stats = _metric_mean_sd(metrics_set.get(y_key))
        if x_stats is None or y_stats is None:
            continue
        group = str(metrics_set.get(primary_differentiator_key))
        marker_group = (
            str(metrics_set.get(secondary_differentiator_key))
            if secondary_differentiator_key
            else "all"
        )
        marker = marker_styles[
            marker_groups.index(marker_group) % len(marker_styles)
        ]
        colour = colours[group]
        errorbar_colour = colour
        changes = dict(special_cases.get(group, {}))
        changes.update(special_cases.get(marker_group, {}))
        if changes.get("errorbar_colour") == "darken":
            errorbar_colour = seaborn.dark_palette(colour, n_colors=4)[2]
        label_parts = []
        if group not in seen:
            label_parts.append(group)
            seen.add(group)
        if secondary_differentiator_key and marker_group not in seen:
            label_parts.append(marker_group)
            seen.add(marker_group)
        ax.errorbar(
            x=x_stats[0],
            y=y_stats[0],
            xerr=x_stats[1] or None,
            yerr=y_stats[1] or None,
            ecolor=errorbar_colour,
            capsize=2,
            color=colour,
            marker=marker,
            markersize=7,
            linestyle="",
            label="; ".join(label_parts) if label_parts else None,
        )
    baseline_line_styles = ["dashed", "dotted", "dashdot", "solid"]
    if other_method_metrics:
        for method, metric_values in other_method_metrics.items():
            y_stats = _metric_mean_sd(metric_values.get(y_key))
            if y_stats is None:
                continue
            x_stats = _metric_mean_sd(metric_values.get(x_key))
            if x_stats is not None:
                ax.errorbar(
                    x=x_stats[0],
                    y=y_stats[0],
                    xerr=x_stats[1] or None,
                    yerr=y_stats[1] or None,
                    color="0.3",
                    capsize=2,
                    linestyle="",
                    marker="v",
                    label=method,
                )
            else:
                style = baseline_line_styles[0]
                baseline_line_styles.append(baseline_line_styles.pop(0))
                ax.axhline(
                    y_stats[0],
                    color="0.3",
                    linestyle=style,
                    label=method,
                    zorder=-1,
                )
                if y_stats[1]:
                    ax.axhspan(
                        ymin=y_stats[0] - y_stats[1],
                        ymax=y_stats[0] + y_stats[1],
                        facecolor="0.3",
                        alpha=0.1,
                        edgecolor=None,
                        zorder=-2,
                    )
    ax.set_xlabel(x_label or x_key)
    ax.set_ylabel(y_label or y_key)
    if len(seen) > 1 or other_method_metrics:
        ax.legend(loc="best", fontsize=8)
    return _save(fig, name, directory)


# --------------------------------------------------------------------------
# Series + centroid-evolution + latent-correlation figure families
# (reference figures/series.py:29-121, learning_curves.py:351-485,
# scatter.py:29-476)
# --------------------------------------------------------------------------


def plot_series(
    series: np.ndarray,
    x_label: str = "feature",
    y_label: str = "value",
    sort: bool = False,
    scale: str = "linear",
    name: str = "series",
    directory: str = ".",
) -> str:
    """1-D series plot, optionally sorted descending with a log y-scale
    (reference ``figures/series.py:29``, used for feature-value standard
    deviations)."""
    series = np.asarray(series, np.float64).squeeze()
    if sort:
        series = np.sort(series)[::-1]
    fig, ax = plt.subplots(figsize=(7, 3))
    ax.plot(np.arange(1, series.size + 1), series, linewidth=1)
    if scale == "log":
        positive = series[series > 0]
        if positive.size:
            ax.set_yscale("log")
    ax.set_xlabel(x_label + (" (sorted)" if sort else ""))
    ax.set_ylabel(y_label)
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_centroid_means_evolution(
    means: np.ndarray,
    name: str = "centroid_means_evolution",
    directory: str = ".",
    decomposed: bool = False,
    device=None,
) -> str:
    """Per-cluster mean paths over epochs, PCA-projected (on ``device``)
    when the latent space has more than two dimensions (reference
    ``figures/learning_curves.py:351-425``)."""
    means = np.asarray(means)  # (E, K, D)
    e, k, d = means.shape
    axis_labels = ("latent dimension 1", "latent dimension 2")
    if d > 2:
        from scvae_tpu_torch.analyses.decomposition import decompose

        flat = decompose(
            means.reshape(-1, d), method="PCA", number_of_components=2,
            device=device,
        )
        means = flat.reshape(e, k, 2)
        axis_labels = ("PC 1", "PC 2")
        decomposed = True
    elif d == 1:
        means = np.concatenate(
            [np.broadcast_to(np.arange(e)[:, None, None], (e, k, 1)), means],
            axis=-1,
        )
        axis_labels = ("epoch", "latent dimension 1")
    fig, ax = plt.subplots(figsize=(6, 6))
    colours = seaborn.color_palette("husl", k)
    for cluster in range(k):
        ax.plot(
            means[:, cluster, 0], means[:, cluster, 1],
            marker=".", markersize=3, linewidth=1,
            color=colours[cluster], label=f"cluster {cluster + 1}",
        )
        ax.scatter(
            means[-1, cluster, 0], means[-1, cluster, 1],
            marker="x", s=60, color=colours[cluster],
        )
    ax.set_xlabel(axis_labels[0])
    ax.set_ylabel(axis_labels[1])
    ax.legend(frameon=False, fontsize="x-small", ncol=2)
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_centroid_covariance_evolution(
    covariance_matrices: np.ndarray,
    name: str = "centroid_covariance_evolution",
    directory: str = ".",
) -> str:
    """Per-cluster generalised variance |Σ_k| (product of the covariance
    diagonal, like the reference) over epochs; log y-scale when the
    dynamic range warrants it (reference
    ``figures/learning_curves.py:428-485``)."""
    covariance_matrices = np.asarray(covariance_matrices)  # (E, K, D, D)
    e, k = covariance_matrices.shape[:2]
    determinants = np.prod(
        np.diagonal(covariance_matrices, axis1=-2, axis2=-1), axis=-1
    )  # (E, K)
    fig, ax = plt.subplots(figsize=(7, 3))
    colours = seaborn.color_palette("husl", k)
    epochs = np.arange(1, e + 1)
    for cluster in range(k):
        ax.plot(
            epochs, determinants[:, cluster],
            color=colours[cluster], linewidth=1,
            label=f"cluster {cluster + 1}",
        )
    if np.all(determinants > 0):
        per_line_ratio = determinants.max(axis=0) / determinants.min(axis=0)
        if per_line_ratio.max() / max(per_line_ratio.min(), 1e-30) > 1e2:
            ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("|Σ(y = k)|")
    ax.legend(frameon=False, fontsize="x-small", ncol=2)
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_variable_label_correlations(
    variable_values: np.ndarray,
    labels: Sequence,
    variable_name: str = "z",
    name: str = "variable_label_correlations",
    directory: str = ".",
) -> str:
    """One latent dimension against the class labels (jittered categorical
    scatter; reference ``figures/scatter.py`` label-correlation plots)."""
    variable_values = np.asarray(variable_values).reshape(-1)
    labels = np.asarray(labels).astype(str)
    class_names = sorted(set(labels.tolist()))
    palette = _class_palette(class_names)
    positions = {c: i for i, c in enumerate(class_names)}
    rng = np.random.RandomState(0)
    x = np.array([positions[c] for c in labels], np.float64)
    x = x + rng.uniform(-0.3, 0.3, size=x.shape)
    fig, ax = plt.subplots(figsize=(max(4, 0.6 * len(class_names)), 4))
    ax.scatter(
        x, variable_values, s=4, alpha=0.6,
        c=[palette[c] for c in labels], linewidths=0,
    )
    ax.set_xticks(range(len(class_names)))
    ax.set_xticklabels(class_names, rotation=45, ha="right", fontsize="x-small")
    ax.set_ylabel(variable_name)
    seaborn.despine(fig)
    return _save(fig, name, directory)


def plot_variable_correlations(
    values: np.ndarray,
    variable_names: Sequence[str] | None = None,
    colour_coding: Sequence | None = None,
    name: str = "variable_correlations",
    directory: str = ".",
    max_variables: int = 10,
) -> str:
    """Scatter matrix of the latent dimensions, coloured by labels — the
    reference's latent scatter-matrix plot
    (``figures/scatter.py:29-476`` via ``plot_variable_correlations``)."""
    values = _densify(values)
    d = min(values.shape[1], max_variables)
    values = values[:, :d]
    if variable_names is None:
        variable_names = [f"z{i + 1}" for i in range(d)]
    colours = None
    if colour_coding is not None:
        labels = np.asarray(colour_coding).astype(str)
        palette = _class_palette(sorted(set(labels.tolist())))
        colours = [palette[c] for c in labels]
    fig, axes = plt.subplots(
        d, d, figsize=(1.6 * d + 1, 1.6 * d + 1), squeeze=False
    )
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if i == j:
                ax.hist(values[:, i], bins=30, color="#777777")
            else:
                ax.scatter(
                    values[:, j], values[:, i], s=2, alpha=0.5,
                    c=colours, linewidths=0,
                )
            if i == d - 1:
                ax.set_xlabel(str(variable_names[j]), fontsize="x-small")
            if j == 0:
                ax.set_ylabel(str(variable_names[i]), fontsize="x-small")
            ax.set_xticks([])
            ax.set_yticks([])
    fig.tight_layout()
    return _save(fig, name, directory)
