"""Correlation matrix and the most correlated feature pairs: the port of
``scvae_tpu/analyses/metrics/correlations.py`` (the reference's
``scvae/analyses/metrics/correlations.py``).

``correlation_matrix`` is one minus scikit-learn's (scipy's) correlation
distance between the rows, computed on a device in float64: the rows
centred and scaled to unit norm, their Gram matrix, and the diagonal 1 (the
distance of a row to itself is 0 there).
"""

from __future__ import annotations

import numpy as np

from scvae_tpu_torch.utils.device import float64_tensor, resolve_device


def correlation_matrix(data_matrix, axis=None, device=None) -> np.ndarray:
    """Pearson correlations between the rows of ``data_matrix`` (between
    its columns for ``axis`` 1, "features" or "columns"), float64; a row
    of zero variance correlates as NaN."""
    values = float64_tensor(data_matrix, resolve_device(device))
    if axis in (1, "features", "columns"):
        values = values.T
    centred = values - values.mean(1, keepdim=True)
    unit = centred / centred.norm(dim=1, keepdim=True)
    correlations = 1.0 - (1.0 - unit @ unit.T)
    correlations.fill_diagonal_(1.0)
    return correlations.cpu().numpy()


def most_correlated_feature_pairs(
    correlations: np.ndarray, n_limit: int | None = None
) -> list[tuple[int, int]]:
    """Upper-triangle pairs sorted by |correlation| ascending; returns the
    ``n_limit`` largest (reference ``correlations.py:20-60``)."""
    n_features = correlations.shape[0]
    n_pairs = n_features * (n_features - 1) // 2
    masked = np.ma.masked_array(
        np.absolute(correlations), mask=np.tri(n_features)
    )
    order = np.unravel_index(
        masked.argsort(axis=None, endwith=False), correlations.shape
    )
    pairs = [tuple(p) for p in np.array(order).T]
    if n_limit is None:
        n_limit = n_pairs
    else:
        n_limit = min(n_limit, n_pairs)
    return pairs[-n_limit:]
