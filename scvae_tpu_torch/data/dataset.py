"""A minimal in-memory data set (the part of ``scvae_tpu/data/dataset.py``
that training needs): a count matrix, dense or CSR, with cells as rows.
Loading, preprocessing, splitting and caching are not ported yet."""

from __future__ import annotations

import numpy as np
import scipy.sparse


class DataSet:
    def __init__(self, values, name: str = "in-memory"):
        if not scipy.sparse.issparse(values):
            values = np.asarray(values)
        if values.ndim != 2:
            raise ValueError(f"values must be (cells, genes), got {values.shape}")
        self.name = name
        self.values = values
        # per-cell total counts (N, 1), the constrained likelihoods' N
        self.count_sum = np.asarray(values.sum(axis=1)).reshape(-1, 1)

    @property
    def number_of_examples(self) -> int:
        return int(self.values.shape[0])

    @property
    def number_of_features(self) -> int:
        return int(self.values.shape[1])
