"""Analyses of data sets and trained models (the port of
``scvae_tpu/analyses/``): metrics, label prediction, decompositions (PCA,
SVD, ICA, t-SNE), the orchestrators and their figures, computed on a
device and drawn on the host; and the cross-analysis of many runs' files,
on the host."""

from scvae_tpu_torch.analyses.analyses import (
    ANALYSIS_GROUPS,
    analyse_data,
    analyse_intermediate_results,
    analyse_model,
    analyse_results,
)
from scvae_tpu_torch.analyses.cross_analysis import cross_analyse
from scvae_tpu_torch.analyses.decomposition import decompose
from scvae_tpu_torch.analyses.prediction import (
    PREDICTION_METHODS,
    PredictionSpecifications,
    map_cluster_ids_to_label_ids,
    predict_labels,
)

__all__ = [
    "ANALYSIS_GROUPS",
    "PREDICTION_METHODS",
    "PredictionSpecifications",
    "analyse_data",
    "analyse_intermediate_results",
    "analyse_model",
    "analyse_results",
    "cross_analyse",
    "decompose",
    "map_cluster_ids_to_label_ids",
    "predict_labels",
]
