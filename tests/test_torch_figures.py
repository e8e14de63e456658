"""The port's figures against the JAX package's on the CPU: every public
function of ``scvae_tpu_torch/analyses/figures.py`` and its namesake of
``scvae_tpu/analyses/figures.py`` drawn from the same numpy inputs made
from seeds, into files of the same name.  The PNG files are equal byte for
byte, or else (the centroid means' PCA, which the port computes with
PyTorch and the JAX package with scikit-learn) their decoded pixels are
equal.  Without matplotlib, the analyses that draw raise ``ImportError``
and the others run."""

import os
import subprocess
import sys
import types

import matplotlib.image
import numpy as np
import pandas
import pytest

from scvae_tpu.analyses import figures as jfigures
from scvae_tpu_torch.analyses import figures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _curves(rs, kinds=("training", "validation"), epochs=6, gmvae=False):
    metrics = ["lower_bound", "reconstruction_error"]
    metrics += (["kl_divergence_z", "kl_divergence_y", "accuracy"] if gmvae
                else ["kl_divergence"])
    return {kind: {metric: (-100 + rs.randn(epochs).cumsum()).tolist()
                   for metric in metrics} for kind in kinds}


def _labels(rs, n, k=4):
    return np.array([f"type {i}" for i in rs.randint(0, k, n)])


def _centroids(rs, k=3, d=2):
    factors = rs.randn(k, d, d) * 0.3
    return {"means": rs.randn(k, d) * 3,
            "covariance_matrices": factors @ factors.transpose(0, 2, 1),
            "probabilities": np.full(k, 1 / k)}


def _images(rs):
    return types.SimpleNamespace(feature_dimensions=(8, 8),
                                 number_of_features=64,
                                 values=rs.rand(150, 64))


def _metric_sets(rs):
    return [{"model": model, "likelihood": likelihood,
             "ELBO": (-1000 + 20 * rs.randn(3)).tolist(),
             "ARI": float(rs.rand())}
            for model in ("VAE", "GMVAE")
            for likelihood in ("NB", "ZINB", "Poisson")]


# name → (function, arguments from a RandomState)
CASES = {
    "learning_curves": ("plot_learning_curves",
                        lambda rs: ((_curves(rs),), {"model_type": "VAE"})),
    "learning_curves_gmvae": ("plot_learning_curves", lambda rs: (
        (_curves(rs, gmvae=True),), {"model_type": "GMVAE"})),
    "kl_divergence_evolution": ("plot_kl_divergence_evolution", lambda rs: (
        (np.abs(rs.randn(7, 5)),), {})),
    "accuracy_evolution": ("plot_accuracy_evolution", lambda rs: (
        ({"training": rs.rand(5).tolist(), "validation": rs.rand(5).tolist()},),
        {})),
    "separate_learning_curves": ("plot_separate_learning_curves", lambda rs: (
        (_curves(rs),), {"loss": ["lower_bound", "reconstruction_error"]})),
    "separate_learning_curves_one": ("plot_separate_learning_curves",
                                     lambda rs: ((_curves(rs),),
                                                 {"loss": "kl_divergence"})),
    "probabilities": ("plot_probabilities", lambda rs: (
        (rs.dirichlet(np.ones(5)), np.full(5, 0.2)), {})),
    "probabilities_prior": ("plot_probabilities", lambda rs: (
        (None, rs.dirichlet(np.ones(4))), {})),
    "centroid_probabilities_evolution": (
        "plot_centroid_probabilities_evolution",
        lambda rs: ((rs.dirichlet(np.ones(4), size=6),), {})),
    "values": ("plot_values", lambda rs: ((rs.randn(300, 2),), {})),
    "values_labels_centroids": ("plot_values", lambda rs: (
        (rs.randn(300, 2) * 3,),
        {"colour_coding": _labels(rs, 300), "centroids": _centroids(rs),
         "axis_labels": ("PC 1", "PC 2"), "colour_coding_title": "cluster"})),
    "histogram": ("plot_histogram", lambda rs: ((rs.gamma(2.0, size=500),),
                                                {"label": "count sum"})),
    "histogram_discrete": ("plot_histogram", lambda rs: (
        (rs.poisson(4.0, size=(50, 10)),),
        {"discrete": True, "normed": True, "scale": "log"})),
    "class_histogram": ("plot_class_histogram", lambda rs: (
        (_labels(rs, 200, 6),),
        {"class_names": [f"type {i}" for i in range(6)]})),
    "class_histogram_normed": ("plot_class_histogram", lambda rs: (
        (_labels(rs, 200, 3),), {"normed": True})),
    "cutoff_count_histogram": ("plot_cutoff_count_histogram", lambda rs: (
        (rs.poisson(3.0, size=(80, 30)),), {"cutoff": 6})),
    "heat_map": ("plot_heat_map", lambda rs: ((rs.rand(40, 25),), {})),
    "heat_map_labels_centred": ("plot_heat_map", lambda rs: (
        (rs.randn(40, 40),),
        {"labels": _labels(rs, 40), "center": 0.0, "z_label": "correlation",
         "x_label": "latent dimension", "y_label": "latent dimension"})),
    "profile_comparison": ("plot_profile_comparison", lambda rs: (
        (rs.poisson(2.0, 60), rs.gamma(2.0, size=60)),
        {"expected_total_standard_deviations": rs.rand(60),
         "expected_explained_standard_deviations": rs.rand(60) / 2})),
    "image_examples": ("combine_images_from_data_set",
                       lambda rs: ((_images(rs),), {})),
    "correlations": ("plot_correlations", lambda rs: (
        ({"set A": {"x": rs.rand(8), "y": rs.rand(8)},
          "set B": {"x": rs.rand(8), "y": rs.rand(8)}}, "x", "y"), {})),
    "elbo_heat_map": ("plot_elbo_heat_map", lambda rs: (
        (pandas.DataFrame(-1000 + rs.rand(3, 4) * 50,
                          index=["2", "10", "50"],
                          columns=["NB", "ZINB", "P", "ZIP"]),
         "likelihood", "latent size"), {"z_label": "ELBO"})),
    "model_metrics": ("plot_model_metrics", lambda rs: (
        (_metric_sets(rs), "ELBO"),
        {"secondary_differentiator_key": "likelihood"})),
    "model_metric_sets": ("plot_model_metric_sets", lambda rs: (
        (_metric_sets(rs), "ELBO", "ARI"),
        {"secondary_differentiator_key": "likelihood",
         "special_cases": {"VAE": {"errorbar_colour": "darken"}},
         "other_method_metrics": {"k-means": {"ARI": [0.3, 0.35]},
                                  "PCA": {"ELBO": [-990.0], "ARI": [0.2]}}})),
    "series": ("plot_series", lambda rs: ((rs.gamma(1.0, size=200),),
                                          {"sort": True, "scale": "log"})),
    "centroid_means_evolution": ("plot_centroid_means_evolution", lambda rs: (
        (rs.randn(5, 3, 2).cumsum(0),), {})),
    "centroid_means_evolution_pca": ("plot_centroid_means_evolution",
                                     lambda rs: ((rs.randn(5, 3, 6).cumsum(0),),
                                                 {})),
    "centroid_means_evolution_1d": ("plot_centroid_means_evolution",
                                    lambda rs: ((rs.randn(5, 3, 1),), {})),
    "centroid_covariance_evolution": (
        "plot_centroid_covariance_evolution",
        lambda rs: ((np.exp(rs.randn(6, 3, 2, 2) * 3),), {})),
    "variable_label_correlations": ("plot_variable_label_correlations",
                                    lambda rs: ((rs.randn(120), _labels(rs, 120)),
                                                {"variable_name": "z2"})),
    "variable_correlations": ("plot_variable_correlations", lambda rs: (
        (rs.randn(100, 3),),
        {"colour_coding": _labels(rs, 100),
         "variable_names": ["z1", "z2", "z3"]})),
}


def test_every_public_figure_function_is_compared():
    public = sorted(name for name in dir(jfigures)
                    if name.startswith(("plot_", "combine_"))
                    and callable(getattr(jfigures, name)))
    assert public == sorted({function for function, _ in CASES.values()})
    assert public == sorted(name for name in dir(figures)
                            if name.startswith(("plot_", "combine_")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_matches_jax(case, tmp_path):
    function, arguments = CASES[case]
    paths = []
    for module, directory in ((figures, tmp_path / "port"),
                              (jfigures, tmp_path / "jax")):
        args, kwargs = arguments(np.random.RandomState(len(case)))
        kwargs = {**kwargs, "directory": str(directory)}
        if function == "plot_centroid_means_evolution" and module is figures:
            kwargs["device"] = "cpu"
        paths.append(getattr(module, function)(*args, name=case, **kwargs))
    got, want = paths
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax")
    with open(got, "rb") as f, open(want, "rb") as g:
        same_bytes = f.read() == g.read()
    if not same_bytes:
        np.testing.assert_array_equal(matplotlib.image.imread(got),
                                      matplotlib.image.imread(want))


def test_figure_settings_match_jax():
    assert (figures.FIGURE_DPI, figures.PUBLICATION_DPI) == (
        jfigures.FIGURE_DPI, jfigures.PUBLICATION_DPI)
    for value in (None, 3.5, [1.0, 2.0, 4.0], ["a", None], [None], [2.0]):
        assert figures._metric_mean_sd(value) == jfigures._metric_mean_sd(
            value)


def test_figure_analyses_without_matplotlib(tmp_path):
    """With matplotlib blocked, a figure analysis raises ``ImportError``
    naming it, and the metrics, predictions and latent values still
    run."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
import numpy as np
from scvae_tpu_torch import DataSet
from scvae_tpu_torch.analyses import analyses

values = np.random.RandomState(0).poisson(2.0, (40, 6)).astype(float)
data_set = DataSet("synthetic", values=values, kind="test",
                   labels=np.array(["a", "b"] * 20))
data_set.update_predictions(predicted_cluster_ids=np.arange(40) % 2)


class Model:
    name = "VAE/model"
    latent_distribution_name = "gaussian"
    number_of_monte_carlo_samples = {{"evaluation": 1}}
    number_of_importance_samples = {{"evaluation": 1}}

    def number_of_epochs_trained(self, **_):
        return 1

    def log_directory(self, **_):
        return "absent"


latent = DataSet("synthetic", values=values[:, :2], kind="test", version="z")
analyses.analyse_results(data_set, None, {{"z": latent}}, Model(),
                         included_analyses=["metrics", "predictions",
                                            "latent_values"],
                         analyses_directory={str(tmp_path)!r}, device="cpu")
analyses.analyse_data([data_set], included_analyses=["metrics"],
                      analyses_directory={str(tmp_path)!r}, device="cpu")
for call in (
        lambda: analyses.analyse_results(
            data_set, None, {{"z": latent}}, Model(),
            included_analyses=["latent_space"],
            analyses_directory={str(tmp_path)!r}, device="cpu"),
        lambda: analyses.analyse_data(
            [data_set], included_analyses=["distributions"],
            analyses_directory={str(tmp_path)!r}, device="cpu")):
    try:
        call()
    except ImportError as error:
        assert "matplotlib" in str(error), error
        assert "latent_space" in str(error) or "distributions" in str(error)
    else:
        raise AssertionError("a figure analysis ran without matplotlib")
assert sys.modules.get("matplotlib") is None
"""
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": REPO,
                                        "OMP_NUM_THREADS": "1"})
    names = [os.path.join(root, name)
             for root, _, files in os.walk(tmp_path) for name in files]
    for name in ("test-metrics.log", "predictions_test.tsv.gz",
                 "latent_values_test.tsv.gz", "statistics.log"):
        assert any(path.endswith(name) for path in names), name
