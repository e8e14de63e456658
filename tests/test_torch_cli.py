"""The port's command line and the API's status methods against the JAX
package's on the CPU.

* ``build_parser()``: every subcommand's actions (option strings, dest,
  default, nargs, type, metavar, const, required) equal JAX's;
* the status methods (``has_been_trained``, ``better_model_exists``,
  ``model_stopped_early``, ``number_of_epochs_trained`` per version,
  ``learning_curves``) of a VAE and a GMVAE that the port trained with a
  validation set into early stopping, against the JAX API's on the same
  model directory (the port writes the JAX package's files);
* ``analyse`` → ``train`` → ``evaluate -P kmeans -K 3 --included-analyses
  metrics predictions latent_values`` of each package's CLI on the
  400-row development split (as ``tests/test_cli.py`` runs JAX's): the
  same file tree (the port's holds the latent values' TSV besides, which
  JAX writes only with its latent-space figures), pickles with the same
  keys, the data summary statistics equal, and the port's metric values
  equal to JAX's metric functions recomputed from the port's prediction
  TSV (1e-12; the silhouette 1e-6, scikit-learn's distances of the float32
  values being float32);
* ``train -A`` (the intermediate analyses at log-spaced epochs, then the
  model analyses) and ``evaluate -A`` with its default ("standard")
  analyses of each package: the same tree of files, figures included; the
  latent values' TSVs with the same rows and columns;
* ``cross-analyse -s`` of each package over copies of the tree that each
  package's ``train -A`` / ``evaluate -A`` wrote: the same
  ``comparison.csv`` and summary log, byte for byte;
* ``--number-of-devices 2`` and ``--model-parallelism 2`` in a world of
  one process raise ``ValueError``, which names ``torchrun``: each needs a
  world of two processes.
"""

import argparse
import gzip
import os
import pickle

import numpy as np
import pandas
import pytest
import torch

from scvae_tpu import cli as jcli
from scvae_tpu.analyses import figures as jfigures
from scvae_tpu.analyses import metrics as jmetrics
from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
from scvae_tpu.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
)
from scvae_tpu.utils.strings import normalise_string
from scvae_tpu_torch import (
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
    cli,
)

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


def _subcommands(parser):
    (subparsers,) = [action for action in parser._actions
                     if isinstance(action, argparse._SubParsersAction)]
    return subparsers.choices


def _action(action):
    return (tuple(action.option_strings), action.dest, action.default,
            action.nargs, action.type, action.metavar, action.const,
            action.required)


def test_parser_matches_jax():
    port, jax = cli.build_parser(), jcli.build_parser()
    port_commands, jax_commands = _subcommands(port), _subcommands(jax)
    assert list(port_commands) == list(jax_commands)
    for name, jax_command in jax_commands.items():
        assert [_action(a) for a in port_commands[name]._actions] == [
            _action(a) for a in jax_command._actions], name
    assert [_action(a) for a in port._actions
            if not isinstance(a, argparse._SubParsersAction)] == [
        _action(a) for a in jax._actions
        if not isinstance(a, argparse._SubParsersAction)]


# -- the status methods -------------------------------------------------------

STATUS_MODELS = {
    "vae": (VariationalAutoencoder, JaxVAE, {}),
    "gmvae": (GaussianMixtureVariationalAutoencoder, JaxGMVAE,
              {"number_of_latent_clusters": 3}),
}


@pytest.fixture(scope="module")
def development_split(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("data"))
    return DataSet("development", directory=directory,
                   example_filter=["random", 400]).split(method="random",
                                                         fraction=0.9)


@pytest.mark.parametrize("kind", list(STATUS_MODELS))
def test_status_methods_match_jax(kind, development_split, tmp_path):
    port_class, jax_class, options = STATUS_MODELS[kind]
    arguments = dict(feature_size=25, latent_size=2, hidden_sizes=[8],
                     reconstruction_distribution="poisson",
                     log_directory=str(tmp_path / "models"), **options)
    port, jax = port_class(**arguments), jax_class(**arguments)
    assert port.log_directory() == jax.log_directory()
    for model in (port, jax):
        assert not model.has_been_trained()
        assert not model.better_model_exists()
        assert not model.model_stopped_early()
        assert model.number_of_epochs_trained() == 0
        assert model.learning_curves() == {}

    training, validation, _ = development_split
    port.early_stopping_rounds = 2
    result = port.train(training, validation, number_of_epochs=12,
                        minibatch_size=64, learning_rate=1e-2, device=CPU,
                        verbose=False)
    assert result.stopped_early  # so that every version exists
    for method in ("has_been_trained", "better_model_exists",
                   "model_stopped_early"):
        assert getattr(port, method)() is getattr(jax, method)() is True
    for version in ({}, {"best_model": True}, {"early_stopping": True}):
        assert port.number_of_epochs_trained(**version) == (
            jax.number_of_epochs_trained(**version)), version
    assert port.number_of_epochs_trained() == result.number_of_epochs_trained
    curves = port.learning_curves()
    assert curves == jax.learning_curves()
    assert curves == result.history
    if kind == "gmvae":
        assert len(curves["validation"]["accuracy"]) == (
            result.number_of_epochs_trained)
    assert not port.has_been_trained(run_id="other")
    assert port.learning_curves(run_id="other") == {}


# -- the command line ---------------------------------------------------------

MODEL_ARGUMENTS = ["-m", "VAE", "-r", "poisson", "-l", "2", "-H", "16",
                   "-B", "64"]
INCLUDED = ["--included-analyses", "metrics", "predictions", "latent_values"]


def _data_arguments(root):
    return ["development", "-D", str(root / "data"), "-E", "random", "400",
            "--split-data-set"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each package's analyse → train → evaluate on the development split;
    {package: root directory}."""
    runs = {}
    for package, main in (("jax", jcli.main),
                          ("port", lambda argv: cli.main(argv, device=CPU))):
        root = tmp_path_factory.mktemp(package)
        data = _data_arguments(root)
        model = [*MODEL_ARGUMENTS, "-M", str(root / "models")]
        analyses = ["-A", str(root / "analyses")]
        assert main(["analyse", *data, *analyses, "--included-analyses",
                     "metrics"]) == 0
        assert main(["train", *data, *model, "-e", "2"]) == 0
        assert main(["evaluate", *data, *model, *analyses, "-P", "kmeans",
                     "-K", "3", *INCLUDED]) == 0
        runs[package] = root
    return runs


def _files(directory):
    return sorted(
        os.path.relpath(os.path.join(root, name), directory)
        for root, _, names in os.walk(directory) for name in names)


def _load(path):
    with gzip.open(path) as f:
        return pickle.load(f)


def test_cli_writes_jax_files(cli_runs):
    port = _files(cli_runs["port"] / "analyses")
    jax = _files(cli_runs["jax"] / "analyses")
    latent = [name for name in port
              if os.path.basename(name) == "latent_values_test.tsv.gz"]
    assert len(latent) == 2  # end of training and the best model
    assert sorted(set(port) - set(latent)) == jax
    assert any(name.endswith("test-prediction-kmeans_3.pkl.gz")
               for name in jax)
    for name in jax:
        if name.endswith(".pkl.gz"):
            got = _load(cli_runs["port"] / "analyses" / name)
            want = _load(cli_runs["jax"] / "analyses" / name)
            assert list(got) == list(want), name
            if "clustering metric values" in want:
                got = got["clustering metric values"]
                want = want["clustering metric values"]
                assert {k: list(v) for k, v in got.items()} == {
                    k: list(v) for k, v in want.items()}
            else:
                assert list(got["evaluation"]) == list(want["evaluation"])
                # the test set's statistics; the reconstructions differ
                assert got["statistics"][0] == pytest.approx(
                    want["statistics"][0], rel=1e-9)
    statistics = [name for name in jax if name.endswith("statistics.log")]
    assert len(statistics) == 1
    assert (cli_runs["port"] / "analyses" / statistics[0]).read_text() == (
        cli_runs["jax"] / "analyses" / statistics[0]).read_text()


def test_cli_metrics_recompute_from_predictions(cli_runs):
    """The port's prediction pickle against JAX's metric functions over
    the port's prediction TSV and the test set."""
    root = cli_runs["port"]
    test_set = JaxDataSet("development", directory=str(root / "data"),
                          example_filter=["random", 400]).split(
                              method="random", fraction=0.9)[2]
    analyses = root / "analyses"
    names = [name for name in _files(analyses)
             if name.endswith("test-prediction-kmeans_3.pkl.gz")]
    assert len(names) == 2
    for name in names:
        directory = analyses / os.path.dirname(name)
        table = pandas.read_csv(directory / "predictions_test.tsv.gz",
                                sep="\t", index_col=0)
        assert list(table.index) == list(test_set.example_names)
        test_set.reset_predictions()
        # the latent set that k-means labels has no superset labels
        assert list(table.columns) == ["cluster_id", "predicted_label"]
        test_set.update_predictions(
            predicted_cluster_ids=table["cluster_id"].values,
            predicted_labels=table["predicted_label"].values.astype(str),
        )
        want = jmetrics.compute_clustering_metrics(test_set)
        got = _load(analyses / name)["clustering metric values"]
        assert list(got) == list(want)
        for metric, values in want.items():
            for key, value in values.items():
                if value is None:
                    assert got[metric][key] is None
                    continue
                tolerance = 1e-6 if metric == "silhouette score" else 1e-12
                np.testing.assert_allclose(got[metric][key], value,
                                           rtol=tolerance, atol=tolerance)
        metrics = _load(directory / "test-metrics.pkl.gz")
        assert metrics["accuracy"] == [want["accuracies"]["accuracy"]]


def test_device_mesh_flags(cli_runs, tmp_path):
    """``--number-of-devices 2`` and ``--model-parallelism 2`` each need a
    world of two processes (``torchrun``)."""
    root = cli_runs["port"]
    data = _data_arguments(root)
    model = [*MODEL_ARGUMENTS, "-M", str(root / "models")]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(["train", *data, *model, "-e", "1",
                  "--number-of-devices", "2"], device=CPU)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(["train", *data, *model, "-e", "1",
                  "--model-parallelism", "2"], device=CPU)


def _save_unrendered(figure, name, directory, *, for_publication=False):
    """The JAX package's ``figures._save`` without the drawing: the same
    path, an empty file."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, normalise_string(name) + ".png")
    open(path, "wb").close()
    jfigures.plt.close(figure)
    return path


@pytest.fixture(scope="module")
def analysis_runs(tmp_path_factory):
    """Each package's ``train -A`` for three epochs, then ``evaluate -A``
    with the default analyses, on the development split; {package: root
    directory}.  The port renders its figures; the JAX package's are saved
    as empty files (tests/test_torch_figures.py holds each figure's pixels
    against JAX's)."""
    runs = {}
    for package, main in (("jax", jcli.main),
                          ("port", lambda argv: cli.main(argv, device=CPU))):
        root = tmp_path_factory.mktemp(package + "_analyses")
        data = _data_arguments(root)
        model = [*MODEL_ARGUMENTS, "-M", str(root / "models")]
        analyses = ["-A", str(root / "analyses")]
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jfigures, "_save", _save_unrendered)
            assert main(["train", *data, *model, "-e", "3", *analyses]) == 0
            assert main(["evaluate", *data, *model, *analyses]) == 0
        runs[package] = root
    return runs


def test_cli_analyses_write_jax_tree(analysis_runs):
    port = _files(analysis_runs["port"] / "analyses")
    jax = _files(analysis_runs["jax"] / "analyses")
    assert port == jax
    assert all((analysis_runs["port"] / "analyses" / name).stat().st_size
               for name in port if name.endswith(".png"))
    for epoch in (1, 2, 3):  # log_spaced_indices(3): every epoch
        assert any(f"intermediate/epoch_{epoch}/latent_space.png" in name
                   for name in port), epoch
    for figure in ("learning_curves.png", "latent_space_labels.png",
                   "pca_test_z.png", "count_histogram_cutoff_10_test.png"):
        assert any(name.endswith(figure) for name in port), figure
    latent = [name for name in jax
              if os.path.basename(name) == "latent_values_test.tsv.gz"]
    assert len(latent) == 2  # end of training and the best model
    for name in latent:
        got = pandas.read_csv(analysis_runs["port"] / "analyses" / name,
                              sep="\t", index_col=0)
        want = pandas.read_csv(analysis_runs["jax"] / "analyses" / name,
                               sep="\t", index_col=0)
        assert list(got.index) == list(want.index)
        assert list(got.columns) == list(want.columns)
        assert np.isfinite(got.values).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cross_analyse_matches_jax(writer, analysis_runs, tmp_path,
                                   monkeypatch):
    """Both packages' ``cross-analyse`` over copies of the analyses tree
    that ``writer``'s ``train -A`` and ``evaluate -A`` wrote, the figures
    saved unrendered."""
    import shutil

    from scvae_tpu_torch.analyses import figures

    for module in (jfigures, figures):
        monkeypatch.setattr(module, "_save", _save_unrendered)
    written = {}
    for package, main in (("jax", jcli.main),
                          ("port", lambda argv: cli.main(argv, device=CPU))):
        tree = tmp_path / package
        shutil.copytree(analysis_runs[writer] / "analyses", tree)
        assert main(["cross-analyse", str(tree), "-s"]) == 0
        written[package] = tree / "cross_analysis" / "all"
    assert _files(written["port"]) == _files(written["jax"])
    for name in ("comparison.csv", "all.log"):
        got = (written["port"] / name).read_bytes()
        assert got == (written["jax"] / name).read_bytes(), name
    table = pandas.read_csv(written["port"] / "comparison.csv")
    assert len(table) == 2  # the end of training and the best model
    assert np.isfinite(table["ELBO"]).all()
