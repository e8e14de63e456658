"""Sparse row (CSR) matrix with whole-matrix statistics.

The port's copy of ``scvae_tpu/data/sparse.py``, the counterpart of the
reference's ``SparseRowMatrix``
(``scvae/data/sparse.py:23-89``): a ``scipy.sparse.csr_matrix`` subclass
adding all-entries ``mean``/``std``/``var`` (computed over zeros too) and a
``sparsity`` measure, because downstream summary statistics treat the
matrix as a dense array of counts.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


class SparseRowMatrix(scipy.sparse.csr_matrix):
    """CSR matrix whose ``mean``/``var``/``std`` without axis arguments are
    over every entry (including implicit zeros)."""

    def mean(self, axis=None, dtype=None, out=None):
        if axis is not None:
            return super().mean(axis=axis, dtype=dtype, out=out)
        return self.sum(dtype=np.float64) / (self.shape[0] * self.shape[1])

    def var(self, axis=None, ddof=0):
        if axis is not None:
            mean_ax = np.asarray(super().mean(axis=axis)).squeeze()
            sq = self.copy()
            sq.data = sq.data.astype(np.float64) ** 2
            mean_sq = np.asarray(sq.mean(axis=axis)).squeeze()
            n = self.shape[axis]
            var = mean_sq - mean_ax**2
            if ddof:
                var = var * n / (n - ddof)
            return var
        n_total = self.shape[0] * self.shape[1]
        mean = self.mean()
        sum_sq = float((self.data.astype(np.float64) ** 2).sum())
        var = sum_sq / n_total - mean**2
        if ddof:
            var = var * n_total / (n_total - ddof)
        return var

    def std(self, axis=None, ddof=0):
        return np.sqrt(self.var(axis=axis, ddof=ddof))

    @property
    def size_in_memory(self) -> int:
        return self.data.nbytes + self.indices.nbytes + self.indptr.nbytes


def sparsity(values) -> float:
    """Fraction of zero entries (reference ``sparse.py:65-89``)."""
    n_total = values.shape[0] * values.shape[1]
    if scipy.sparse.issparse(values):
        n_nonzero = values.count_nonzero()
    else:
        n_nonzero = np.count_nonzero(values)
    return 1.0 - n_nonzero / n_total
