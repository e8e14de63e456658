"""The port's native densify (``scvae_tpu_torch/native``) against the JAX
package's (``scvae_tpu.native``) and scipy's ``toarray``, exactly: row
indices shuffled and repeated, empty rows, data held as int16, int32,
float32 and float64; the whole-matrix densify; the cached C-interface
arrays (views where the dtypes already match); a row outside the matrix
and a build that fails raise."""

import numpy as np
import pytest
import scipy.sparse

from scvae_tpu import native as jnative
from scvae_tpu_torch import native


def _matrix(dtype, seed=0):
    """A 90 × 37 CSR matrix with every fifth row empty, values of
    ``dtype``."""
    rng = np.random.RandomState(seed)
    dense = rng.poisson(3.0, (90, 37)) * (rng.uniform(size=(90, 37)) < 0.2)
    dense[::5] = 0
    if np.issubdtype(dtype, np.floating):
        dense = dense * rng.uniform(0.5, 1.5, dense.shape)
    return scipy.sparse.csr_matrix(dense.astype(dtype))


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32,
                                   np.float64])
def test_gather_matches_jax_and_scipy(dtype):
    matrix = _matrix(dtype)
    rng = np.random.RandomState(1)
    rows = np.concatenate([rng.permutation(90), [0, 5, 5, 89, 3, 3]])
    got = native.csr_gather_dense(matrix, rows)
    want = jnative.csr_gather_dense(matrix, rows)
    assert want is not None  # the JAX package's library built
    assert got.dtype == np.float32 and got.shape == (96, 37)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, matrix[rows].toarray().astype(np.float32))
    assert not got[rows == 5].any()  # an empty row twice


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_whole_matrix_matches_jax_and_scipy(dtype):
    matrix = _matrix(dtype, seed=2)
    got = native.csr_to_dense(matrix)
    np.testing.assert_array_equal(got, jnative.csr_to_dense(matrix))
    np.testing.assert_array_equal(got, matrix.toarray().astype(np.float32))


def test_cached_arrays_copy_only_other_dtypes():
    matrix = _matrix(np.float32)
    data, indices, indptr = native._csr_arrays(matrix)
    assert native._csr_arrays(matrix)[0] is data  # cached on the matrix
    assert np.shares_memory(data, matrix.data)
    assert np.shares_memory(indices, matrix.indices)
    assert indptr.dtype == np.int64
    wide = _matrix(np.float64)
    data, _, _ = native._csr_arrays(wide)
    assert data.dtype == np.float32 and not np.shares_memory(data, wide.data)


def test_rows_outside_the_matrix_raise():
    matrix = _matrix(np.float32)
    for rows in ([0, 90], [-1]):
        with pytest.raises(IndexError):
            native.csr_gather_dense(matrix, np.array(rows))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_LIBRARY",
                        str(tmp_path / "build" / "libdensify.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native densify"):
        native.csr_gather_dense(_matrix(np.float32), np.arange(3))
    assert not (tmp_path / "build" / "libdensify.so").exists()
