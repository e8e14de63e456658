"""Analyses of data sets and trained models (the ported parts of
``scvae_tpu/analyses/``): metrics, label prediction, decompositions and the
metric and prediction files of the result analyses, computed on a device.
The figures and cross-analysis are not ported yet."""

from scvae_tpu_torch.analyses.analyses import (
    ANALYSIS_GROUPS,
    analyse_data,
    analyse_model,
    analyse_results,
)
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
    "analyse_model",
    "analyse_results",
    "decompose",
    "map_cluster_ids_to_label_ids",
    "predict_labels",
]
