"""Default configuration values.

A copy of ``scvae_tpu/defaults.py`` (the port imports nothing of the JAX
package): one table of defaults that every layer falls back to with the
reference's ``if x is None: x = default`` idiom.
"""

from __future__ import annotations

import copy
from typing import Any

DEFAULTS: dict[str, Any] = {
    "data": {
        "format": "infer",
        "directory": "data",
        "map_features": False,
        "feature_selection": [],
        "example_filter": [],
        "preprocessing_methods": [],
        "noisy_preprocessing_methods": [],
        "split_data_set": False,
        "splitting_method": "default",
        "splitting_fraction": 0.9,
    },
    "analyses": {
        "directory": "analyses",
        "decomposition_method": "PCA",
        "decomposition_dimensionality": 2,
        "highlight_feature_indices": [],
        "included_analyses": "standard",
        "analysis_level": "normal",
        "export_options": [],
    },
    "models": {
        "directory": "models",
        "type": "VAE",
        "latent_size": 2,
        "hidden_sizes": [100],
        "number_of_samples": {"training": 1, "evaluation": 1},
        "latent_distribution": {"VAE": "gaussian", "GMVAE": "gaussian mixture"},
        "number_of_classes": 1,
        "parameterise_latent_posterior": False,
        "inference_architecture": "MLP",
        "generative_architecture": "MLP",
        "reconstruction_distribution": "poisson",
        "number_of_reconstruction_classes": 0,
        "prior_probabilities_method": "uniform",
        "number_of_warm_up_epochs": 0,
        "kl_weight": 1.0,
        "proportion_of_free_nats_for_y_kl_divergence": 0.0,
        "minibatch_normalisation": True,
        "batch_correction": False,
        "dropout_keep_probabilities": [],
        "count_sum": False,
        "number_of_epochs": 200,
        "minibatch_size": 100,
        "learning_rate": 1e-4,
        "sample_size": 0,
        "run_id": "",
        "new_run": False,
        "reset_training": False,
    },
    "evaluation": {
        "data_set_kind": "test",
        "prediction_training_set_kind": "training",
        "prediction_method": "",
        "model_versions": "all",
    },
    "cross_analysis": {
        "log_summary": False,
    },
}


def get_default(*path: str) -> Any:
    """Look up a default by key path, e.g. ``get_default("models", "latent_size")``.

    Returns a deep copy for mutable values so callers cannot corrupt the
    defaults table.
    """
    node: Any = DEFAULTS
    for key in path:
        node = node[key]
    if isinstance(node, (dict, list)):
        return copy.deepcopy(node)
    return node


def default_if_none(value: Any, *path: str) -> Any:
    """The reference's pervasive ``if x is None: x = defaults[...]`` idiom."""
    if value is None:
        return get_default(*path)
    return value
