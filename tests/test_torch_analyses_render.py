"""The port's orchestrators with "all", their figures rendered: a GMVAE
the port trains for three epochs on the development split, evaluated on
its test set, then the model, result, data and intermediate analyses on
the CPU, as ``test_figure_analyses_write_jax_tree[all]`` in
tests/test_torch_analyses.py runs them.  That test holds the tree of files
and the TSVs against the JAX package's with the figures saved unrendered;
tests/test_torch_figures.py holds each figure's pixels against JAX's.
Here every figure is a PNG that decodes to an image of more than one
colour."""

import os

import matplotlib.image
import numpy as np
import pytest
import torch

from scvae_tpu_torch import DataSet, GaussianMixtureVariationalAutoencoder
from scvae_tpu_torch.analyses import analyses

CPU = "cpu"
# The figures of test_figure_analyses_write_jax_tree[all]'s tree (57), and the
# class histogram of the label superset, which its copied sets lack.
FIGURES = 58


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for PyTorch and OpenMP: t-SNE and ICA take many small
    steps, which the threads of parallel test workers would
    oversubscribe."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


def test_all_analyses_render(tmp_path):
    data_set = DataSet("development", directory=str(tmp_path / "data"),
                       example_filter=["random", 400])
    training, validation, test = data_set.split(method="random",
                                                fraction=0.9)
    model = GaussianMixtureVariationalAutoencoder(
        feature_size=25, latent_size=3, hidden_sizes=[8],
        reconstruction_distribution="poisson", number_of_latent_clusters=3,
        log_directory=str(tmp_path / "models"))
    model.train(training, validation, number_of_epochs=3, minibatch_size=64,
                device=CPU, verbose=False)
    transformed, reconstructed, latent = model.evaluate(test, device=CPU,
                                                        verbose=False)
    directory = {"analyses_directory": str(tmp_path / "analyses"),
                 "device": CPU}
    options = {"included_analyses": ["all"], **directory}
    exports = ["decomposition", "latent"]
    analyses.analyse_model(model, **options)
    analyses.analyse_results(
        transformed, reconstructed, latent, model,
        evaluation_subset_indices=np.arange(5),
        decomposition_methods=["PCA", "ICA", "t-SNE"],
        export_options=exports, **options)
    analyses.analyse_data([test], export_options=exports, **options)
    analyses.analyse_intermediate_results(
        2, learning_curves=model.learning_curves(),
        latent_values=np.random.RandomState(23).randn(
            training.number_of_examples, 3),
        data_set=training, model_name=model.name, **directory)
    figures = [os.path.join(root, name)
               for root, _, names in os.walk(tmp_path / "analyses")
               for name in names if name.endswith(".png")]
    assert len(figures) == FIGURES
    for path in figures:
        image = matplotlib.image.imread(path)
        assert image.ndim == 3 and (image != image[0, 0]).any(), path
