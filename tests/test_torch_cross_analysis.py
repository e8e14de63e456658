"""The port's cross-analysis against the JAX package's on the CPU.

Both packages' ``cross_analyse`` run over copies of the same analyses
tree with the same filters, ``epoch_cut_off`` and ``other_methods``; the
returned tables are equal (``pandas.testing.assert_frame_equal``), and so
are the bytes of ``comparison.csv``, the summary log and what each prints,
and the paths of the figures they save.  The trees are synthetic, as in
``tests/test_analyses.py`` (``TestCrossAnalysisAggregation``): gzip'd
pickles of metrics and predictions at the paths ``analyse_results`` writes,
with several models, named runs, versions and another method's baseline;
and, one each way, the tree that each package's ``analyse_results`` wrote
for the same stub models and evaluation sets, so that the port's
``cross_analyse`` reads JAX's files and JAX's reads the port's.

The figure functions run on the cross-analysis' inputs, but both packages
save their figures as empty files, not rendered: rendering is most of the
time, and ``tests/test_torch_figures.py`` holds each figure function's
pixels against JAX's.
"""

import gzip
import os
import pickle
import shutil

import numpy as np
import pandas
import pytest

from scvae_tpu.analyses import analyses as janalyses
from scvae_tpu.analyses import cross_analysis as jcross_analysis
from scvae_tpu.analyses import figures as jfigures
from scvae_tpu.analyses import prediction as jprediction
from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu_torch import DataSet
from scvae_tpu_torch.analyses import analyses, cross_analysis, figures
from scvae_tpu_torch.analyses import prediction
from scvae_tpu_torch.utils.strings import normalise_string


def _save_unrendered(figure, name, directory, *, for_publication=False):
    """A figure module's ``_save`` without the drawing: the same path, an
    empty file."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, normalise_string(name) + ".png")
    open(path, "wb").close()
    jfigures.plt.close(figure)
    return path


@pytest.fixture(autouse=True)
def _unrendered(monkeypatch):
    for module in (jfigures, figures):
        monkeypatch.setattr(module, "_save", _save_unrendered)


def _write_run(base, rel_path, elbo, ari=None, epochs=5, method="k-means",
               classes=5, silhouette=None):
    """The files ``analyse_results`` writes for one run and version, as
    ``tests/test_analyses.py`` writes them."""
    directory = os.path.join(str(base), rel_path)
    os.makedirs(directory, exist_ok=True)
    metrics = {
        "evaluation": {"lower_bound": [elbo],
                       "reconstruction_error": [elbo + 1.0],
                       "kl_divergence": [1.0]},
        "number of epochs trained": epochs,
    }
    with gzip.open(os.path.join(directory, "test-metrics.pkl.gz"), "w") as f:
        pickle.dump(metrics, f)
    if ari is not None:
        predictions = {
            "prediction method": method,
            "number of classes": classes,
            "clustering metric values": {
                "adjusted Rand index": {"clusters": ari,
                                        "clusters; superset": ari + 0.05},
                "adjusted mutual information": {"clusters": ari - 0.01},
                "silhouette score": {"clusters": silhouette},
            },
        }
        with gzip.open(os.path.join(
                directory, f"test-prediction-{method}.pkl.gz"), "w") as f:
            pickle.dump(predictions, f)


def _models_tree(base):
    """Two likelihoods and two latent sizes of a VAE, a GMVAE's best model,
    a second data set, and a run with no predictions."""
    for rel, elbo, ari, epochs in (
            ("dev/VAE/gaussian/poisson-l_2-h_100-mc_1-iw_1", -120.0, 0.4, 5),
            ("dev/VAE/gaussian/poisson-l_10-h_100-mc_1-iw_1", -110.0, 0.5, 5),
            ("dev/VAE/gaussian/negative_binomial-l_2-h_100-mc_1-iw_1",
             -100.0, 0.6, 5),
            ("dev/VAE/gaussian/negative_binomial-l_10-h_100-mc_1-iw_1",
             -95.0, 0.7, 5),
            ("dev/GMVAE/gaussian_mixture-c_5/"
             "negative_binomial-l_10-h_100-mc_1-iw_1/run_a/best",
             -90.0, 0.8, 40),
            ("other/VAE/gaussian/zero_inflated_poisson-l_2-h_50", -130.0,
             None, 12)):
        _write_run(base, rel, elbo, ari, epochs, silhouette=0.25)


def _runs_tree(base):
    """Three named runs of one model at two versions, and a Seurat
    baseline beside the runs."""
    data_set = "development/no_preprocessing/split-random_0.9"
    model = "VAE/gaussian/negative_binomial-l_10-h_100-mc_1-iw_1"
    for run, elbo in (("a", -100.0), ("b", -102.0), ("c", -104.0)):
        for version, shift in (("e_20-mc_1-iw_1", 0.0),
                               ("e_18-best_model-mc_1-iw_1", 1.5)):
            _write_run(base, f"{data_set}/{model}/run_{run}/{version}",
                       elbo + shift, 0.6 + shift / 10, epochs=20,
                       silhouette=0.3)
    method_directory = os.path.join(str(base), data_set, "seurat")
    os.makedirs(method_directory)
    with gzip.open(os.path.join(method_directory,
                                "test-prediction-seurat.pkl.gz"), "w") as f:
        pickle.dump({"prediction method": "Seurat", "number of classes": 7,
                     "clustering metric values": {
                         "adjusted Rand index": {"clusters": 0.55}}}, f)


def _filters_tree(base):
    _write_run(base, "dev/VAE/gaussian/poisson-l_2-h_100", -120.0, 0.4,
               epochs=5)
    _write_run(base, "dev/GMVAE/gaussian_mixture-c_5/poisson-l_2-h_100",
               -90.0, 0.8, epochs=50)


TREES = {"models": _models_tree, "runs": _runs_tree,
         "filters": _filters_tree, "empty": lambda base: None}
CASES = {
    "all": ("models", dict(log_summary=True)),
    "data set filter": ("models", dict(data_set_included_strings=["dev"],
                                       model_included_strings=["VAE"],
                                       log_summary=True)),
    "gmvae plots without methods": (
        "models", dict(no_prediction_methods_for_gmvae_in_plots=True,
                       additional_other_option="BN", log_summary=True)),
    "runs and baselines": ("runs", dict(other_methods=["seurat"],
                                        log_summary=True)),
    "epoch cut-off": ("filters", dict(epoch_cut_off=10, log_summary=True)),
    "model excluded": ("filters", dict(model_excluded_strings=["GMVAE"])),
    "prediction excluded": ("filters",
                            dict(prediction_excluded_strings=["k-means"])),
    "nothing left": ("filters", dict(data_set_excluded_strings=["dev"])),
    "empty": ("empty", {}),
}


def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def _cross_analyse_both(tree, options, capsys):
    """Each package's ``cross_analyse`` over its own copy of ``tree``:
    {package: (table, printed text, the files it added)}."""
    results = {}
    for package, function in (("port", cross_analysis.cross_analyse),
                              ("jax", jcross_analysis.cross_analyse)):
        copy = tree.parent / f"{tree.name}-{package}"
        shutil.copytree(tree, copy)
        before = set(_files(copy))
        table = function(str(copy), **options)
        added = sorted(set(_files(copy)) - before)
        results[package] = (table, capsys.readouterr().out, copy, added)
    return results


def _assert_same(results):
    (table, printed, port_root, added), (want_table, want_printed,
                                         jax_root, want_added) = (
        results["port"], results["jax"])
    pandas.testing.assert_frame_equal(table, want_table)
    assert printed == want_printed
    assert added == want_added
    for name in added:
        got = (port_root / name).read_bytes()
        want = (jax_root / name).read_bytes()
        if name.endswith(".png"):
            assert got == want == b"", name
        else:
            assert got == want, name
    return added


@pytest.mark.parametrize("case", list(CASES))
def test_cross_analysis_matches_jax(case, tmp_path, capsys):
    tree_name, options = CASES[case]
    tree = tmp_path / "analyses"
    os.makedirs(tree)
    TREES[tree_name](tree)
    added = _assert_same(_cross_analyse_both(tree, options, capsys))
    directories = {os.path.dirname(name) for name in added}
    if case in ("nothing left", "empty"):
        assert not added
        return
    assert len(directories) == 1
    (directory,) = directories
    names = [os.path.basename(name) for name in added]
    assert "comparison.csv" in names
    assert (os.path.basename(directory) + ".log" in names) == bool(
        options.get("log_summary"))
    if case == "all":
        assert directory == os.path.join("cross_analysis", "all")
        for figure in ("correlations_dev.png", "elbo_heat_map_dev.png",
                       "model_metrics_dev_elbo.png",
                       "model_metric_sets_dev_superset_ari_elbo.png"):
            assert figure in names, figure
    if case == "runs and baselines":
        assert any("other_methods" in name for name in names)


# -- trees that analyse_results wrote ------------------------------------------


class _Model:
    """The attributes of a trained model that ``analyse_results`` reads."""

    latent_distribution_name = "gaussian"
    number_of_monte_carlo_samples = {"training": 1, "evaluation": 1}
    number_of_importance_samples = {"training": 1, "evaluation": 1}

    def __init__(self, name, epochs, lower_bound):
        self.name, self.epochs = name, epochs
        self._last_evaluation_metrics = {
            "lower_bound": lower_bound,
            "reconstruction_error": lower_bound + 0.75,
            "kl_divergence": 0.75}

    def number_of_epochs_trained(self, run_id=None, early_stopping=False,
                                 best_model=False):
        return self.epochs - 2 if best_model else self.epochs

    def log_directory(self, run_id=None):
        return "no such directory"


# (model name, run id, epochs, lower bound, with the best model)
WRITTEN_RUNS = [
    ("VAE/gaussian/poisson-l_2-h_16", None, 5, -10.5, False),
    ("VAE/gaussian/negative_binomial-l_2-h_16", None, 6, -9.75, True),
    ("VAE/gaussian/negative_binomial-l_4-h_16", None, 6, -9.5, False),
    ("GMVAE/gaussian_mixture-c_4/negative_binomial-l_2-h_16", "a", 8, -9.0,
     True),
    ("GMVAE/gaussian_mixture-c_4/negative_binomial-l_2-h_16", "b", 8, -9.25,
     True),
    ("GMVAE/gaussian_mixture-c_4/negative_binomial-l_2-h_16", "c", 8, -9.5,
     True),
]


def _evaluation_set(module, seed):
    rs = np.random.RandomState(seed)
    labels = np.array([f"type {i}" for i in rs.randint(0, 4, 120)])
    values = rs.poisson(2.0, (120, 6)).astype(np.float32)
    data_set = module(
        "synthetic", values=values, labels=labels,
        example_names=np.array([f"cell {i}" for i in range(120)]),
        feature_names=np.array([f"gene {j}" for j in range(6)]),
        specifications={"label superset": {
            "group A": ["type 0", "type 1"],
            "group B": ["type 2", "type 3"]}},
        kind="test", version="original")
    data_set.update_predictions(
        predicted_cluster_ids=rs.randint(0, 4, 120),
        predicted_labels=np.where(rs.rand(120) < 0.6, labels,
                                  labels[rs.permutation(120)]))
    return data_set


@pytest.fixture(scope="module")
def written_trees(tmp_path_factory):
    """{package: the analyses tree its ``analyse_results`` wrote} for the
    WRITTEN_RUNS, each evaluated on the same values, labels and predicted
    clusters, under one data set's directory."""
    trees = {}
    for package, module, orchestrator, specifications, extra in (
            ("port", DataSet, analyses.analyse_results,
             prediction.PredictionSpecifications, {"device": "cpu"}),
            ("jax", JaxDataSet, janalyses.analyse_results,
             jprediction.PredictionSpecifications, {})):
        root = tmp_path_factory.mktemp(package + "_written")
        for index, (name, run_id, epochs, lower_bound, best) in enumerate(
                WRITTEN_RUNS):
            data_set = _evaluation_set(module, index)
            data_set.update_predictions(
                prediction_specifications=specifications(
                    "kmeans", 4, "training"))
            for best_model in (False, True) if best else (False,):
                orchestrator(
                    data_set, None, None,
                    _Model(name, epochs, lower_bound - 0.5 * best_model),
                    run_id=run_id, best_model=best_model,
                    included_analyses=["metrics", "predictions"],
                    analyses_directory=str(root / "analyses" / "synthetic"),
                    **extra)
        trees[package] = root / "analyses"
    return trees


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_analysis_of_written_trees(writer, written_trees, tmp_path,
                                         capsys):
    """Both packages over the tree ``writer``'s ``analyse_results`` wrote:
    the port reads JAX's files and JAX reads the port's."""
    tree = tmp_path / "analyses"
    shutil.copytree(written_trees[writer], tree)
    assert _files(written_trees["port"]) == _files(written_trees["jax"])
    added = _assert_same(_cross_analyse_both(
        tree, dict(log_summary=True, other_methods=["seurat"]), capsys))
    table = pandas.read_csv(tmp_path / "analyses-port" / "cross_analysis"
                            / "all" / "comparison.csv")
    assert len(table) == 10  # every run's every version
    assert "cross_analysis/all/all.log" in added
    log = (tmp_path / "analyses-port" / "cross_analysis" / "all"
           / "all.log").read_text()
    assert "GMVAE(4)" in log and "kM(4)" in log
