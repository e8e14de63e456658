"""The port's analyses against the JAX package's on the CPU, on the same
numpy inputs made from seeds: the clustering metrics, the summary
statistics, the correlations, the decompositions, k-means and label
prediction, the metric and prediction files of ``analyse_results``, and
the tree of files (figures and TSVs) that each orchestrator writes.

The JAX package computes these with scikit-learn, the port with PyTorch on
a device (here ``device="cpu"``) in float64.  Where the JAX package's
estimator is unseeded (k-means, the silhouette's sample, the randomised
SVD), the test seeds numpy's global generator, which scikit-learn then
draws from, and passes the same seed to the port, which draws from
``numpy.random.RandomState(seed)`` in scikit-learn's order: the draws are
the same.

Tolerances: ARI, AMI and accuracy to 1e-12; the silhouette to 1e-9
relative (within 0.02 of JAX's on a sample of another seed); summary
statistics and correlations to 1e-9; PCA and IncrementalPCA components and
transforms (other sets and centroids' means and covariances too) to 1e-6
relative, up to the sign convention's ties (none in these inputs); the
SVD's |transforms| to 1e-4; k-means partitions equal up to relabelling
(ARI 1.0) with inertia within 1e-6, mini-batch k-means of another seed
within ARI 0.99.
"""

import gzip
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import sklearn.cluster
import sklearn.decomposition
import sklearn.metrics
import torch

from scvae_tpu.analyses import analyses as janalyses
from scvae_tpu.analyses import decomposition as jdecomposition
from scvae_tpu.analyses import figures as jfigures
from scvae_tpu.analyses import metrics as jmetrics
from scvae_tpu.analyses import prediction as jprediction
from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.utils.strings import normalise_string
from scvae_tpu_torch import DataSet
from scvae_tpu_torch.analyses import analyses, decomposition, figures, metrics
from scvae_tpu_torch.analyses import prediction
from scvae_tpu_torch.analyses.kmeans import KMeans, MiniBatchKMeans

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for PyTorch and OpenMP in this module: t-SNE and ICA take
    many small steps, and the products of IncrementalPCA and the
    silhouette, which the threads of parallel test workers would
    oversubscribe (IncrementalPCA's test took 103 s under six workers with
    every thread, 2 s alone with one)."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def _labels(seed, n, k, agreement=None, reference=None):
    """``n`` labels of ``k`` classes; with ``reference``, equal to it with
    probability ``agreement``."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, k, n)
    if reference is not None:
        labels = np.where(rs.rand(n) < agreement, reference, labels)
    return labels


def _blobs(seed, n, k, features, spread=6.0):
    rs = np.random.RandomState(seed)
    centres = rs.randn(k, features) * spread
    ids = rs.randint(0, k, n)
    return centres[ids] + rs.randn(n, features), ids


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


# -- clustering metrics -------------------------------------------------------

SUPERVISED_CASES = [
    # (classes, clusters, rows, agreement)
    (5, 7, 500, None), (5, 5, 500, 0.8), (10, 10, 3_000, 0.6),
    (2, 30, 200, None), (1, 3, 50, None), (3, 1, 40, None),
    (4, 4, 100, 1.0),
]


@pytest.mark.parametrize("case", SUPERVISED_CASES)
@pytest.mark.parametrize("names", [False, True])
def test_ari_ami_accuracy_match_jax(case, names):
    k_true, k_predicted, n, agreement = case
    labels = _labels(1, n, k_true)
    predicted = _labels(2, n, k_predicted, agreement,
                        labels if agreement else None)
    excluded = None
    if names:  # string labels, one class excluded
        labels = np.array([f"type {i}" for i in labels])
        excluded = ["type 0"]
    for port, jax in ((metrics.adjusted_rand_index,
                       jmetrics.adjusted_rand_index),
                      (metrics.adjusted_mutual_information,
                       jmetrics.adjusted_mutual_information)):
        got = port(labels, predicted, excluded, device=CPU)
        want = jax(labels, predicted, excluded)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12, (port.__name__, got, want)
    predicted_names = (np.array([f"type {i % k_true}" for i in predicted])
                       if names else predicted % k_true)
    with np.errstate(invalid="ignore"):  # every label excluded: NaN
        np.testing.assert_equal(
            metrics.accuracy(labels, predicted_names, excluded),
            jmetrics.accuracy(labels, predicted_names, excluded))


@pytest.mark.parametrize("kind", ["blobs", "random"])
def test_silhouette_matches_jax(kind):
    values, ids = _blobs(3, 700, 4, 5)
    if kind == "random":
        ids = _labels(4, 700, 6)
    got = metrics.silhouette_score(values, ids, device=CPU)
    want = jmetrics.silhouette_score(values, ids)
    assert abs(got - want) <= 1e-9 * abs(want)
    sparse = scipy.sparse.csr_matrix(np.where(values > 1, values, 0))
    got = metrics.silhouette_score(sparse, ids, device=CPU)
    want = jmetrics.silhouette_score(sparse, ids)
    assert abs(got - want) <= 1e-9 * abs(want)


def test_silhouette_nan_cases():
    values, _ = _blobs(5, 30, 2, 3)
    for ids in (np.zeros(30, int), np.arange(30)):
        assert np.isnan(metrics.silhouette_score(values, ids, device=CPU))
        assert np.isnan(jmetrics.silhouette_score(values, ids))


def test_silhouette_sample_above_20000_rows():
    values, ids = _blobs(6, 21_000, 3, 3, spread=10.0)
    np.random.seed(11)
    want = jmetrics.silhouette_score(values, ids)
    same_sample = metrics.silhouette_score(values, ids, seed=11, device=CPU)
    assert abs(same_sample - want) <= 1e-9 * abs(want)
    other_sample = metrics.silhouette_score(values, ids, seed=12, device=CPU)
    assert abs(other_sample - want) <= 0.02


def _evaluation_set(module, values, labels, superset=None, seed=7):
    data_set = module(
        "synthetic", values=values, labels=labels,
        example_names=np.array([f"cell {i}" for i in range(len(labels))]),
        feature_names=np.array([f"gene {j}" for j in range(values.shape[1])]),
        specifications={"excluded classes": ["type 3"],
                        **({"label superset": superset} if superset else {})},
        kind="test", version="original")
    rs = np.random.RandomState(seed)
    clusters = rs.randint(0, 4, len(labels))
    data_set.update_predictions(
        predicted_cluster_ids=clusters,
        predicted_labels=np.where(rs.rand(len(labels)) < 0.7, labels,
                                  labels[rs.permutation(len(labels))]),
    )
    return data_set


def _metric_sets():
    values, ids = _blobs(8, 300, 4, 6)
    labels = np.array([f"type {i}" for i in ids])
    superset = {"group A": ["type 0", "type 1"],
                "group B": ["type 2", "type 3"]}
    return (_evaluation_set(DataSet, values, labels, superset),
            _evaluation_set(JaxDataSet, values, labels, superset))


def _assert_metric_values(got, want):
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name]), name
        for key, value in want[name].items():
            if value is None:
                assert got[name][key] is None, (name, key)
            else:
                assert isinstance(got[name][key], float), (name, key)
                assert abs(got[name][key] - value) <= 1e-9 * max(
                    1.0, abs(value)), (name, key, got[name][key], value)


def test_compute_clustering_metrics_matches_jax():
    port_set, jax_set = _metric_sets()
    got = metrics.compute_clustering_metrics(port_set, device=CPU)
    want = jmetrics.compute_clustering_metrics(jax_set)
    _assert_metric_values(got, want)
    assert got["adjusted Rand index"]["clusters; superset"] is not None


# -- summary statistics and correlations --------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_summary_statistics_match_jax(sparse):
    rs = np.random.RandomState(9)
    values = rs.poisson(0.7, (60, 17)).astype(np.float64) * rs.rand(60, 17)
    if sparse:
        values = scipy.sparse.csr_matrix(values)
    for tolerance in (1e-3, 0.5):
        got = metrics.summary_statistics(values, name="x", tolerance=tolerance,
                                         device=CPU)
        want = jmetrics.summary_statistics(values, name="x",
                                           tolerance=tolerance)
        assert list(got) == list(want)
        for key, value in want.items():
            if key == "name":
                assert got[key] == value
            else:
                assert abs(got[key] - value) <= 1e-9 * abs(value), key
    skipped = metrics.summary_statistics(values, skip_sparsity=True,
                                         device=CPU)
    assert np.isnan(skipped["sparsity"])
    table = [got, {**got, "name": "a much longer name", "mean": 1234.5678}]
    assert metrics.format_summary_statistics(table) == (
        jmetrics.format_summary_statistics(table))
    assert metrics.format_summary_statistics(got, name="Set") == (
        jmetrics.format_summary_statistics(got, name="Set"))


@pytest.mark.parametrize("axis", [None, "features"])
def test_correlations_match_jax(axis):
    rs = np.random.RandomState(10)
    values = rs.randn(40, 12) @ rs.randn(12, 12)
    got = metrics.correlation_matrix(values, axis=axis, device=CPU)
    want = jmetrics.correlation_matrix(values, axis=axis)
    assert np.abs(got - want).max() <= 1e-9
    assert metrics.most_correlated_feature_pairs(got, n_limit=5) == (
        jmetrics.most_correlated_feature_pairs(want, n_limit=5))
    assert metrics.most_correlated_feature_pairs(got) == (
        jmetrics.most_correlated_feature_pairs(want))


# -- decompositions -----------------------------------------------------------


def _low_rank(seed, n, features):
    rs = np.random.RandomState(seed)
    scales = np.array([10.0, 5.0, 2.0, 1.0])
    return ((rs.randn(n, 4) * scales) @ rs.randn(4, features)
            + 0.3 * rs.randn(n, features) + rs.randn(features))


def _centroids(seed, features):
    rs = np.random.RandomState(seed)
    factors = rs.randn(3, features, features)
    return {
        "prior": {"means": rs.randn(3, features),
                  "covariance_matrices": factors @ factors.transpose(0, 2, 1),
                  "probabilities": np.full(3, 1 / 3)},
        "posterior": None,
    }


@pytest.mark.parametrize("case", ["PCA", "IncrementalPCA", "sparse"])
def test_pca_matches_jax(case):
    features = {"PCA": 30, "IncrementalPCA": 2_010, "sparse": 40}[case]
    values = _low_rank(12, 420, features)
    others = {"validation": _low_rank(13, 50, features), "empty": None}
    if case == "sparse":
        values = scipy.sparse.csr_matrix(np.where(np.abs(values) > 1,
                                                  values, 0))
    centroids = _centroids(14, features)
    got = decomposition.decompose(values, other_value_sets=others,
                                  centroids=centroids, method="pca",
                                  number_of_components=2, device=CPU)
    want = jdecomposition.decompose(values, other_value_sets=others,
                                    centroids=centroids, method="pca",
                                    number_of_components=2)
    assert _rel(got[0], want[0]) <= 1e-6
    assert _rel(got[1]["validation"], want[1]["validation"]) <= 1e-6
    assert got[1]["empty"] is None and got[2]["posterior"] is None
    for parameter in ("means", "covariance_matrices"):
        assert _rel(got[2]["prior"][parameter],
                    want[2]["prior"][parameter]) <= 1e-6, parameter
    np.testing.assert_array_equal(got[2]["prior"]["probabilities"],
                                  want[2]["prior"]["probabilities"])
    # the components themselves, against the estimator JAX calls
    dense = values.toarray() if scipy.sparse.issparse(values) else values
    if case == "PCA":
        port = decomposition.PCA(2, CPU)
        estimator = sklearn.decomposition.PCA(n_components=2)
    else:
        port = decomposition.IncrementalPCA(2, CPU)
        estimator = sklearn.decomposition.IncrementalPCA(n_components=2,
                                                         batch_size=100)
    port.fit_transform(values)
    estimator.fit(dense)
    assert _rel(port.components_, estimator.components_) <= 1e-6


def test_pca_keeps_float32():
    values = _low_rank(15, 200, 10).astype(np.float32)
    got = decomposition.decompose(values, method="PCA", device=CPU)
    want = jdecomposition.decompose(values, method="PCA")
    assert got.dtype == want.dtype == np.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(300, 40), (40, 300)])
def test_svd_matches_jax(shape):
    values = _low_rank(16, *shape)
    others = {"validation": _low_rank(17, 20, shape[1])}
    np.random.seed(18)
    want = jdecomposition.decompose(values, other_value_sets=others,
                                    method="SVD")
    got = decomposition.decompose(values, other_value_sets=others,
                                  method="svd", seed=18, device=CPU)
    assert _rel(np.abs(got[0]), np.abs(want[0])) <= 1e-4
    assert _rel(np.abs(got[1]["validation"]),
                np.abs(want[1]["validation"])) <= 1e-4


@pytest.mark.parametrize("method", ["ICA", "t-SNE"])
def test_ica_and_tsne_match_jax(method):
    """ICA and t-SNE (the exact method, four components) against JAX's
    ``decompose`` (scikit-learn) on the same values, to 1e-6 and 1e-5 of
    the largest |value| (tests/test_torch_decomposition.py holds the 2-D
    t-SNE, P and the PCA start).  The values mix non-Gaussian sources, as
    ICA assumes: on mostly Gaussian values (``_low_rank``) FastICA's
    fixed-point iteration grows a rounding difference about threefold a
    step, and any two linear-algebra libraries part there (ROADMAP C)."""
    rs = np.random.RandomState(19)
    values = (rs.laplace(size=(60, 3)) @ rs.randn(3, 5) + rs.randn(5)
              + 0.1 * rs.randn(60, 5))  # of full rank: no component is noise
    components = 4 if method == "t-SNE" else 2
    got = decomposition.decompose(values, method=method,
                                  number_of_components=components, device=CPU)
    want = jdecomposition.decompose(values, method=method,
                                    number_of_components=components)
    assert got.dtype == want.dtype and got.shape == (60, components)
    assert _rel(got, want) <= (1e-5 if method == "t-SNE" else 1e-6)


# -- k-means and label prediction ---------------------------------------------


class _Values:
    """The attributes of a data set that the k-means method reads."""

    def __init__(self, values):
        self.values = values
        self.number_of_examples = values.shape[0]


@pytest.mark.parametrize("k", [3, 5, 10])
def test_kmeans_matches_jax(k):
    values, _ = _blobs(20 + k, 2_000, k, 6)
    evaluation = _blobs(40 + k, 300, k, 6)[0]
    np.random.seed(k)
    want, _, _ = jprediction._predict_using_kmeans(
        _Values(values), _Values(evaluation), k)
    got, _, _ = prediction._predict_using_kmeans(
        _Values(values), _Values(evaluation), k, seed=k, device=CPU)
    assert got.dtype == want.dtype == np.int32
    assert sklearn.metrics.adjusted_rand_score(want, got) == 1.0
    estimator = sklearn.cluster.KMeans(n_clusters=k, n_init=10,
                                       random_state=k).fit(values)
    port = KMeans(k, seed=k, device=CPU).fit(values)
    assert abs(port.inertia_ - estimator.inertia_) <= 1e-6 * (
        estimator.inertia_)
    np.testing.assert_array_equal(port.labels_, estimator.labels_)
    assert _rel(port.cluster_centers_, estimator.cluster_centers_) <= 1e-9


def test_minibatch_kmeans_matches_jax():
    values, _ = _blobs(50, 12_000, 10, 8, spread=8.0)
    np.random.seed(0)
    want, _, _ = jprediction._predict_using_kmeans(
        _Values(values), _Values(values[:2_000]), 10)
    other, _, _ = prediction._predict_using_kmeans(
        _Values(values), _Values(values[:2_000]), 10, seed=1, device=CPU)
    assert sklearn.metrics.adjusted_rand_score(want, other) >= 0.99
    same, _, _ = prediction._predict_using_kmeans(
        _Values(values), _Values(values[:2_000]), 10, seed=0, device=CPU)
    assert sklearn.metrics.adjusted_rand_score(want, same) == 1.0
    estimator = sklearn.cluster.MiniBatchKMeans(
        n_clusters=10, batch_size=100, n_init=3, random_state=2).fit(values)
    port = MiniBatchKMeans(10, seed=2, device=CPU).fit(values)
    assert port.n_steps_ == estimator.n_steps_
    assert abs(port.inertia_ - estimator.inertia_) <= 1e-6 * (
        estimator.inertia_)


@pytest.fixture(scope="module")
def development_splits(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("data"))
    splits = []
    for module in (JaxDataSet, DataSet):
        data_set = module("development", directory=directory,
                          example_filter=["random", 400])
        splits.append(data_set.split(method="random", fraction=0.9))
    return splits


def test_predict_labels_matches_jax(development_splits):
    (jax_training, _, jax_test), (training, _, test) = development_splits
    specifications = [
        module.PredictionSpecifications("kmeans", 3, "training")
        for module in (jprediction, prediction)
    ]
    np.random.seed(21)
    want = jprediction.predict_labels(jax_training, jax_test,
                                      specifications=specifications[0])
    got = prediction.predict_labels(training, test,
                                    specifications=specifications[1],
                                    seed=21, device=CPU)
    for got_part, want_part in zip(got, want):
        if want_part is None:
            assert got_part is None
        else:
            np.testing.assert_array_equal(got_part, want_part)
    assert got[2] is not None  # the development set has superset labels

    # "model": the evaluation set's own cluster ids, mapped to labels
    ids = np.random.RandomState(22).randint(0, 4, test.number_of_examples)
    for data_set in (jax_test, test):
        data_set.reset_predictions()
        data_set.update_predictions(predicted_cluster_ids=ids)
    want = jprediction.predict_labels(jax_training, jax_test, method="model",
                                      number_of_clusters=4)
    got = prediction.predict_labels(training, test, method="model",
                                    number_of_clusters=4, device=CPU)
    for got_part, want_part in zip(got, want):
        np.testing.assert_array_equal(got_part, want_part)
    for data_set in (jax_test, test):
        data_set.reset_predictions()


@pytest.mark.parametrize("method,clusters,kind", [
    ("kmeans", 3, "training"), ("k-means", 10, "validation"),
    ("K-Means", 2, None), ("model", 5, "Test"), ("Model", 1, "full"),
])
def test_prediction_specification_names_match_jax(method, clusters, kind):
    got = prediction.PredictionSpecifications(method, clusters, kind)
    want = jprediction.PredictionSpecifications(method, clusters, kind)
    assert (got.name, got.method, got.number_of_clusters,
            got.training_set_kind) == (want.name, want.method,
                                       want.number_of_clusters,
                                       want.training_set_kind)
    assert set(prediction.PREDICTION_METHODS) == set(
        jprediction.PREDICTION_METHODS)
    with pytest.raises(TypeError):
        prediction.PredictionSpecifications(method)


# -- the metric and prediction files of analyse_results -----------------------


class _Model:
    """The attributes of a model that ``analyse_results`` reads."""

    name = "VAE/gaussian/poisson-l_2-h_16"
    latent_distribution_name = "gaussian"
    number_of_monte_carlo_samples = {"training": 1, "evaluation": 1}
    number_of_importance_samples = {"training": 1, "evaluation": 1}
    _last_evaluation_metrics = {"lower_bound": -10.5,
                                "reconstruction_error": -9.25,
                                "kl_divergence": 1.25}

    def number_of_epochs_trained(self, run_id=None, early_stopping=False,
                                 best_model=False):
        return 4 if best_model else 5

    def log_directory(self, run_id=None):
        return "no such directory"


def _tree(directory):
    return sorted(
        os.path.relpath(os.path.join(root, name), directory)
        for root, _, names in os.walk(directory) for name in names)


@pytest.mark.parametrize("best_model", [False, True])
def test_result_files_match_jax(tmp_path, best_model):
    port_set, jax_set = _metric_sets()
    for data_set, module in ((port_set, prediction), (jax_set, jprediction)):
        data_set.update_predictions(
            prediction_specifications=module.PredictionSpecifications(
                "kmeans", 4, "training"))
    included = ["metrics", "predictions"]
    port_directory, jax_directory = tmp_path / "port", tmp_path / "jax"
    port_results = analyses.analyse_results(
        port_set, None, None, _Model(), best_model=best_model,
        included_analyses=included, analyses_directory=str(port_directory),
        device=CPU)
    janalyses.analyse_results(
        jax_set, None, None, _Model(), best_model=best_model,
        included_analyses=included, analyses_directory=str(jax_directory))
    assert _tree(port_directory) == _tree(jax_directory)
    assert port_results["directory"].startswith(str(port_directory))
    for name in _tree(jax_directory):
        got_path, want_path = port_directory / name, jax_directory / name
        if name.endswith(".log"):
            got = got_path.read_text().splitlines()
            want = want_path.read_text().splitlines()
            assert got[0].startswith("Timestamp: ")
            assert got[1:] == want[1:], name
        elif name.endswith(".pkl.gz"):
            with gzip.open(got_path) as f:
                got = pickle.load(f)
            with gzip.open(want_path) as f:
                want = pickle.load(f)
            assert list(got) == list(want), name
            assert got["number of epochs trained"] == (4 if best_model else 5)
            if "clustering metric values" in want:
                _assert_metric_values(got["clustering metric values"],
                                      want["clustering metric values"])
                for key in ("prediction method", "number of classes",
                            "training set"):
                    assert got[key] == want[key]
            else:
                assert got["evaluation"] == want["evaluation"]
                assert got["accuracy"] == want["accuracy"]
                assert got["superset_accuracy"] == want["superset_accuracy"]
                for got_stats, want_stats in zip(got["statistics"],
                                                 want["statistics"]):
                    assert list(got_stats) == list(want_stats)
                    for key, value in want_stats.items():
                        if key != "name":
                            assert abs(got_stats[key] - value) <= 1e-9 * abs(
                                value)
        else:  # the predictions' TSV
            with gzip.open(got_path) as f:
                got = f.read()
            with gzip.open(want_path) as f:
                want = f.read()
            assert got == want, name


def test_latent_values_file(tmp_path):
    port_set, _ = _metric_sets()
    latent = DataSet("synthetic", values=port_set.values[:, :2],
                     example_names=port_set.example_names,
                     feature_names=np.array(["latent variable 1",
                                             "latent variable 2"]),
                     kind="test", version="z")
    analyses.analyse_results(port_set, None, {"z": latent}, _Model(),
                             included_analyses=["latent_values"],
                             analyses_directory=str(tmp_path), device=CPU)
    (path,) = [name for name in _tree(tmp_path)
               if name.endswith("latent_values_test.tsv.gz")]
    import pandas

    frame = pandas.read_csv(tmp_path / path, sep="\t", index_col=0)
    np.testing.assert_allclose(frame.values, port_set.values[:, :2],
                               rtol=1e-12)
    assert list(frame.columns) == ["latent variable 1", "latent variable 2"]


@pytest.fixture(scope="module")
def trained_gmvae(development_splits, tmp_path_factory):
    """A GMVAE the port trained for three epochs with validation on the
    development split, evaluated on the test set: (the JAX model on the
    same log directory, the port's model, the port's output sets)."""
    from scvae_tpu.models.gmvae_api import (
        GaussianMixtureVariationalAutoencoder as JaxGMVAE,
    )
    from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder

    (_, _, _), (training, validation, test) = development_splits
    arguments = dict(feature_size=25, latent_size=3, hidden_sizes=[8],
                     reconstruction_distribution="poisson",
                     number_of_latent_clusters=3,
                     log_directory=str(tmp_path_factory.mktemp("models")))
    model = GaussianMixtureVariationalAutoencoder(**arguments)
    model.train(training, validation, number_of_epochs=3, minibatch_size=64,
                device=CPU, verbose=False)
    outputs = model.evaluate(test, device=CPU, verbose=False)
    jax_model = JaxGMVAE(**arguments)
    jax_model._last_evaluation_metrics = model._last_evaluation_metrics
    return jax_model, model, outputs


def _copy_set(module, data_set):
    """``data_set`` rebuilt in ``module``'s ``DataSet`` from its arrays."""
    copy = module(
        "synthetic", values=data_set.values,
        total_standard_deviations=data_set.total_standard_deviations,
        explained_standard_deviations=(
            data_set.explained_standard_deviations),
        labels=data_set.labels, example_names=data_set.example_names,
        feature_names=data_set.feature_names,
        specifications={"excluded classes": data_set.excluded_classes or []},
        kind=data_set.kind, version=data_set.version)
    copy.update_predictions(
        predicted_cluster_ids=data_set.predicted_cluster_ids,
        predicted_labels=data_set.predicted_labels)
    return copy


def _sets(module, outputs):
    transformed, reconstructed, latent = outputs
    return (_copy_set(module, transformed), _copy_set(module, reconstructed),
            {key: _copy_set(module, value) for key, value in latent.items()})


def _tsv(path):
    import pandas

    return pandas.read_csv(path, sep="\t", index_col=0)


def _assert_same_tsvs(port_directory, jax_directory):
    """Every TSV of JAX's tree in the port's: the same rows and columns;
    predictions and latent values equal, PCA and ICA exports to 1e-5 of
    the largest |value| (the sets are float32, which ICA computes in, as
    scikit-learn does), t-SNE exports (the exact objective against
    scikit-learn's Barnes–Hut) finite."""
    for name in _tree(jax_directory):
        if not name.endswith(".tsv.gz"):
            continue
        got, want = _tsv(port_directory / name), _tsv(jax_directory / name)
        assert list(got.index) == list(want.index), name
        assert got.shape == want.shape, name
        base = os.path.basename(name)
        if base.startswith("t_sne"):
            assert np.isfinite(got.values).all(), name
        elif base.startswith(("pca", "ica")):
            assert _rel(got.values, want.values) <= 1e-5, name
        else:
            assert got.equals(want), name


def save_unrendered(figure, name, directory, *, for_publication=False):
    """A figure module's ``_save`` without the drawing: the same path, an
    empty file."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, normalise_string(name) + ".png")
    open(path, "wb").close()
    jfigures.plt.close(figure)
    return path


@pytest.mark.parametrize("analysis", [
    "latent_space", "profile_comparisons", "heat_maps", "standard", "all",
])
def test_figure_analyses_write_jax_tree(tmp_path, analysis, trained_gmvae,
                               development_splits, monkeypatch):
    """Each orchestrator with ``analysis`` writes the JAX package's tree of
    files: the model analyses of a run the port trained (the JAX model
    reads the same log directory), the result analyses of its evaluation
    (both packages' sets built from the same arrays), the data analyses of
    the development split's test set and, for "all", the intermediate
    analyses of the same latent values; "all" with the decomposition
    exports, and PCA, ICA and t-SNE in the result analyses.

    Every figure function runs on the orchestrators' inputs, and each
    package saves its figures as empty files, not rendered: rendering is
    most of the time.  tests/test_torch_figures.py holds each function's
    pixels against JAX's, and tests/test_torch_analyses_render.py renders
    the port's figures of "all"."""
    for module in (jfigures, figures):
        monkeypatch.setattr(module, "_save", save_unrendered)
    jax_model, model, outputs = trained_gmvae
    port_directory, jax_directory = tmp_path / "port", tmp_path / "jax"
    options = {}
    if analysis == "all":
        options = {"decomposition_methods": ["PCA", "ICA", "t-SNE"],
                   "export_options": ["decomposition", "latent"]}
    subset = np.arange(5)
    analyses.analyse_model(model, included_analyses=[analysis],
                           analyses_directory=str(port_directory), device=CPU)
    janalyses.analyse_model(jax_model, included_analyses=[analysis],
                            analyses_directory=str(jax_directory))
    for module, orchestrator, directory, extra in (
            (DataSet, analyses.analyse_results, port_directory,
             {"device": CPU}),
            (JaxDataSet, janalyses.analyse_results, jax_directory, {})):
        model_object = model if module is DataSet else jax_model
        orchestrator(*_sets(module, outputs), model_object,
                     evaluation_subset_indices=subset,
                     included_analyses=[analysis],
                     analyses_directory=str(directory), **options, **extra)
    (jax_sets, port_sets) = development_splits
    exports = {"export_options": options.get("export_options")}
    analyses.analyse_data([port_sets[2]], included_analyses=[analysis],
                          analyses_directory=str(port_directory), device=CPU,
                          **exports)
    janalyses.analyse_data([jax_sets[2]], included_analyses=[analysis],
                           analyses_directory=str(jax_directory), **exports)
    if analysis == "all":
        latent = np.random.RandomState(23).randn(
            port_sets[0].number_of_examples, 3)
        curves = model.learning_curves()
        for orchestrator, directory, extra in (
                (analyses.analyse_intermediate_results, port_directory,
                 {"device": CPU}),
                (janalyses.analyse_intermediate_results, jax_directory, {})):
            orchestrator(2, learning_curves=curves, latent_values=latent,
                         data_set=port_sets[0], model_name=model.name,
                         analyses_directory=str(directory), **extra)
    port_tree, jax_tree = _tree(port_directory), _tree(jax_directory)
    assert port_tree == jax_tree
    assert any(name.endswith(".png") for name in port_tree)
    _assert_same_tsvs(port_directory, jax_directory)
    if analysis == "all":
        for figure in ("kl_divergence_evolution.png",
                       "centroid_means_evolution.png",
                       "latent_space_clusters.png", "t_sne_test_z.png",
                       "ica_test_y.png", "distances_test_z.png", "epoch_3"):
            assert any(figure in name for name in port_tree), figure


def test_analyse_data_statistics_match_jax(development_splits, tmp_path):
    (jax_sets, port_sets) = development_splits
    analyses.analyse_data(list(port_sets), included_analyses=["metrics"],
                          analyses_directory=str(tmp_path / "port"),
                          device=CPU)
    janalyses.analyse_data(list(jax_sets), included_analyses=["metrics"],
                           analyses_directory=str(tmp_path / "jax"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    name = os.path.join("data", "statistics.log")
    assert (tmp_path / "port" / name).read_text() == (
        tmp_path / "jax" / name).read_text()


# -- what the analyses import -------------------------------------------------


def test_analyses_import_no_sklearn_or_jax(tmp_path):
    """The analyses and the CLI run without scikit-learn, JAX and the JAX
    package (the card's machine has none of them): k-means, the metrics,
    PCA, SVD, ICA and t-SNE."""
    code = """
import sys
for name in ("h5py", "sklearn", "jax", "scvae_tpu"):
    sys.modules[name] = None
import numpy as np
import scvae_tpu_torch.cli
from scvae_tpu_torch.analyses import decompose, metrics
from scvae_tpu_torch.analyses.kmeans import KMeans, MiniBatchKMeans

rs = np.random.RandomState(0)
values = rs.randn(12_000, 3) + np.repeat(np.eye(3) * 9, 4_000, axis=0)
ids = MiniBatchKMeans(3, seed=0, device="cpu").fit(
    values).labels_
assert metrics.adjusted_rand_index(np.repeat(np.arange(3), 4_000), ids,
                                   device="cpu") > 0.99
assert KMeans(3, seed=0, device="cpu").fit(values[::10]).inertia_ > 0
assert metrics.silhouette_score(values[::10], ids[::10], device="cpu") > 0.5
assert decompose(values, method="PCA", device="cpu").shape == (12_000, 2)
assert decompose(values, method="SVD", seed=0, device="cpu").shape == (
    12_000, 2)
assert decompose(values[::20], method="ICA", device="cpu").shape == (
    600, 2)
assert decompose(values[::100], method="t-SNE", device="cpu").shape == (
    120, 2)
blocked = [name for name in ("h5py", "sklearn", "jax", "scvae_tpu")
           if sys.modules.get(name) is not None]
assert not blocked, blocked
"""
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": REPO,
                                        "OMP_NUM_THREADS": "1"})
