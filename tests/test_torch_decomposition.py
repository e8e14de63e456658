"""The port's ICA and t-SNE against the JAX package's ``decompose`` and
against the scikit-learn functions it calls, on the CPU, on numpy inputs
made from seeds.

Tolerances (relative to the largest |value|):
* ICA: sources and the transform of another set to 1e-6 (float64 inputs;
  float32 inputs, which both compute in float32, to 1e-5);
* t-SNE's P: the Barnes–Hut method's sparse P against scikit-learn's
  ``_joint_probabilities_nn`` on its own neighbour graph, and the exact
  method's dense P against ``_joint_probabilities``, to 1e-6 (both read
  ~1e-16 here);
* the PCA start against scikit-learn's ``PCA`` (exact and randomised
  solvers), scaled as ``TSNE`` scales it, to 1e-6;
* the port's 2-D gradient (exact repulsion over every pair) against
  scikit-learn's exact ``_kl_divergence`` on the same P, to 1e-5;
* the exact method (four components) against JAX's ``decompose`` at 150
  rows: the embedding to 1e-5 (it reads 0 here: the same float32 and
  float64 roundings at every step);
* the 2-D path against JAX's ``decompose`` (scikit-learn's Barnes–Hut, θ =
  0.5) at 500 rows: KL(P ‖ Q) of each embedding under the same P within 5%
  and the 10-nearest-neighbour preservation within 0.05.
"""

import numpy as np
import pytest
import scipy.sparse
import sklearn.decomposition
import torch
from scipy.spatial.distance import squareform
from sklearn.manifold import _t_sne
from sklearn.metrics import pairwise_distances
from sklearn.neighbors import NearestNeighbors

import chip_smoke
from scvae_tpu.analyses import decomposition as jdecomposition
from scvae_tpu_torch.analyses import decomposition, tsne

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for PyTorch and OpenMP in this module: t-SNE and ICA take
    many small steps, which the threads of parallel test workers would
    oversubscribe."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


def _mixed(seed, n, features, sources=4):
    """Non-Gaussian sources mixed into ``features`` columns, with noise."""
    rs = np.random.RandomState(seed)
    s = np.column_stack([rs.laplace(size=n), rs.uniform(-2, 2, n),
                         rs.standard_t(3, n), rs.exponential(size=n)])
    return (s[:, :sources] @ rs.randn(sources, features) * 3
            + 0.2 * rs.randn(n, features) + rs.randn(features))


def _blobs(seed, n, k, features, spread=6.0):
    rs = np.random.RandomState(seed)
    centres = rs.randn(k, features) * spread
    return centres[rs.randint(0, k, n)] + rs.randn(n, features)


# -- ICA ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(300, 20, 2), (500, 8, 3), (120, 50, 2)])
def test_ica_matches_jax(shape):
    n, features, components = shape
    values = _mixed(1, n, features)
    others = {"validation": _mixed(2, 40, features), "empty": None}
    want = jdecomposition.decompose(values, other_value_sets=others,
                                    method="ICA",
                                    number_of_components=components)
    got = decomposition.decompose(values, other_value_sets=others,
                                  method="ica",
                                  number_of_components=components, device=CPU)
    assert got[0].dtype == want[0].dtype == np.float64
    assert got[0].shape == (n, components)
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1]["validation"], want[1]["validation"]) <= 1e-6
    assert got[1]["empty"] is None


def test_ica_float32_and_seeds():
    values = _mixed(3, 300, 12).astype(np.float32)
    want = jdecomposition.decompose(values, method="ICA")
    got = decomposition.decompose(values, method="ICA", device=CPU)
    assert got.dtype == want.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    # random=True draws from ``seed``, as FastICA(random_state=seed)
    estimator = sklearn.decomposition.FastICA(n_components=2, random_state=5)
    want = estimator.fit_transform(values.astype(np.float64))
    got = decomposition.decompose(values.astype(np.float64), method="ICA",
                                  random=True, seed=5, device=CPU)
    assert _rel(got, want) <= 1e-6
    port = decomposition.FastICA(2, 5, CPU)
    port.fit_transform(values.astype(np.float64))
    assert _rel(port.components_, estimator.components_) <= 1e-6


# -- t-SNE --------------------------------------------------------------------


def test_tsne_sparse_p_matches_sklearn():
    values = _blobs(4, 500, 5, 30)
    graph = NearestNeighbors(n_neighbors=91).fit(values).kneighbors_graph(
        mode="distance")
    graph.data **= 2
    want = _t_sne._joint_probabilities_nn(graph, 30.0, 0).toarray()
    p = tsne.TSNE(2, 42, CPU).joint_probabilities(
        torch.from_numpy(values))
    assert p.is_sparse and p.dtype == torch.float64
    got = p.to_dense().numpy()
    assert _rel(got, want) <= 1e-6
    np.testing.assert_array_equal(got != 0, want != 0)


@pytest.mark.parametrize("n", [40, 150])
def test_tsne_dense_p_matches_sklearn(n):
    values = _blobs(5, n, 3, 10)
    want = _t_sne._joint_probabilities(
        pairwise_distances(values, squared=True), 30.0, 0)
    got = tsne.TSNE(4, 42, CPU).joint_probabilities(
        torch.from_numpy(values)).numpy()
    assert np.all(np.diag(got) == 0)
    assert _rel(squareform(got, checks=False), want) <= 1e-6


@pytest.mark.parametrize("shape", [(500, 30), (300, 600)])
def test_tsne_pca_start_matches_sklearn(shape):
    """``init="pca"``: the exact solver at 500 × 30, the randomised one at
    300 × 600 (scikit-learn's "auto" choice), both from seed 42."""
    values = _blobs(6, shape[0], 4, shape[1])
    pca = sklearn.decomposition.PCA(n_components=2,
                                    random_state=np.random.RandomState(42))
    want = pca.fit_transform(values).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = tsne.TSNE(2, 42, CPU).initial_embedding(
        torch.from_numpy(values)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-6


def test_tsne_gradient_is_the_exact_objective():
    """The port's 2-D objective, exact over every pair, against
    scikit-learn's exact ``_kl_divergence`` on the same (sparse) P."""
    values = _blobs(7, 300, 4, 12)
    model = tsne.TSNE(2, 42, CPU)
    p = model.joint_probabilities(torch.from_numpy(values))
    y = torch.from_numpy(np.random.RandomState(7).randn(300, 2).astype(
        np.float32))
    error, gradient = tsne._SparseObjective(p, 1)(y, True)
    dense = squareform(p.to_dense().numpy(), checks=False)
    want_error, want_gradient = _t_sne._kl_divergence(
        y.numpy().ravel(), dense, 1, 300, 2)
    assert _rel(gradient.numpy().ravel(), want_gradient) <= 1e-5
    assert abs(chip_smoke.tsne_kl_divergence(p, y.numpy(), CPU)
               - want_error) <= 1e-9 * abs(want_error)
    # the error the descent checks: scikit-learn's over P's entries
    assert abs(error - want_error) <= 1e-5 * abs(want_error)


def _chunked_parts(values, y):
    """P of both methods, the 2-D gradient and error, KL(P ‖ Q) and the
    10-NN preservation, on the CPU at the current ``tsne.CHUNK_BYTES``."""
    x = torch.from_numpy(values)
    p = tsne.TSNE(2, 42, CPU).joint_probabilities(x)
    error, gradient = tsne._SparseObjective(p, 1)(y, True)
    return (p.to_dense().numpy(),
            tsne.TSNE(4, 42, CPU).joint_probabilities(x).numpy(),
            gradient.numpy(), error,
            chip_smoke.tsne_kl_divergence(p, y.numpy(), CPU),
            chip_smoke.neighbour_preservation(values, y.numpy(), 10, CPU))


def test_tsne_row_chunks_match_one_chunk(monkeypatch):
    """The chunked paths (the neighbours' diagonal mask at ``rows +
    start``, the exact method's distances, the repulsion's rows and its
    normaliser summed over chunks, the KL's normaliser) with chunks of
    13–54 rows of 300, the last one short, against one chunk: to 1e-6 of
    the largest |value|, the preservation equal."""
    values = _blobs(10, 300, 4, 12)
    y = torch.from_numpy(np.random.RandomState(10).randn(300, 2).astype(
        np.float32))
    whole = _chunked_parts(values, y)
    monkeypatch.setattr(tsne, "CHUNK_BYTES", 1 << 16)
    assert len(list(tsne._row_chunks(300, 300 * 8))) == 12
    chunked = _chunked_parts(values, y)
    for got, want in zip(chunked[:3], whole[:3]):
        assert _rel(got, want) <= 1e-6
    np.testing.assert_array_equal(chunked[0] != 0, whole[0] != 0)
    for got, want in zip(chunked[3:5], whole[3:5]):
        assert abs(got - want) <= 1e-6 * abs(want)
    assert chunked[5] == whole[5]


def test_tsne_exact_method_matches_jax():
    values = _blobs(3, 150, 4, 10)
    want = jdecomposition.decompose(values, method="t-SNE",
                                    number_of_components=4)
    got = decomposition.decompose(values, method="tsne",
                                  number_of_components=4, device=CPU)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (150, 4)
    assert _rel(got, want) <= 1e-5


def test_tsne_2d_matches_jax_objective():
    values = _blobs(1, 500, 5, 30)
    others = {"validation": values[:20]}
    want = jdecomposition.decompose(values, other_value_sets=others,
                                    method="t-SNE")
    got = decomposition.decompose(values, other_value_sets=others,
                                  method="t-SNE", device=CPU)
    assert got[1] is None and want[1] is None  # t-SNE transforms no other set
    got, want = got[0], want[0]
    assert got.dtype == want.dtype == np.float32 and got.shape == (500, 2)
    model = tsne.TSNE(2, 42, CPU)
    np.testing.assert_array_equal(model.fit_transform(values), got)
    assert model.n_iter_ == 999
    got_kl, want_kl = (
        chip_smoke.tsne_kl_divergence(model.p_, embedding, CPU)
        for embedding in (got, want))
    assert abs(got_kl - want_kl) <= 0.05 * want_kl, (got_kl, want_kl)
    assert abs(model.kl_divergence_ - got_kl) <= 1e-4 * got_kl
    got_kept = chip_smoke.neighbour_preservation(values, got, 10, CPU)
    want_kept = chip_smoke.neighbour_preservation(values, want, 10, CPU)
    assert abs(got_kept - want_kept) <= 0.05, (got_kept, want_kept)
    assert got_kept > 0.3


def test_tsne_sparse_values_and_small_sets():
    values = _blobs(8, 60, 3, 8)
    dense = decomposition.decompose(values, method="t-SNE", device=CPU)
    sparse = decomposition.decompose(
        scipy.sparse.csr_matrix(values), method="t-SNE", device=CPU)
    np.testing.assert_array_equal(dense, sparse)
    with pytest.raises(ValueError, match="perplexity"):
        decomposition.decompose(values[:30], method="t-SNE", device=CPU)
    with pytest.raises(ValueError, match="perplexity"):
        jdecomposition.decompose(values[:30], method="t-SNE")


def test_neighbour_preservation():
    values = _blobs(9, 200, 3, 5)
    assert chip_smoke.neighbour_preservation(values, values, 10, CPU) == 1.0
    shuffled = np.random.RandomState(9).permutation(values)
    assert chip_smoke.neighbour_preservation(values, shuffled, 10, CPU) < 0.2
