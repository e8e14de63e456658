"""Evaluation metrics: clustering quality, summary statistics, correlations
(the port of ``scvae_tpu/analyses/metrics/``), computed on a device."""

from scvae_tpu_torch.analyses.metrics.clustering import (
    CLUSTERING_METRICS,
    accuracy,
    adjusted_mutual_information,
    adjusted_rand_index,
    compute_clustering_metrics,
    silhouette_score,
)
from scvae_tpu_torch.analyses.metrics.correlations import (
    correlation_matrix,
    most_correlated_feature_pairs,
)
from scvae_tpu_torch.analyses.metrics.summary import (
    format_summary_statistics,
    summary_statistics,
)

__all__ = [
    "CLUSTERING_METRICS",
    "accuracy",
    "adjusted_mutual_information",
    "adjusted_rand_index",
    "compute_clustering_metrics",
    "correlation_matrix",
    "format_summary_statistics",
    "most_correlated_feature_pairs",
    "silhouette_score",
    "summary_statistics",
]
