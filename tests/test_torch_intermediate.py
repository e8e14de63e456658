"""The port's intermediate analyses against the JAX package's on the CPU:
``log_spaced_indices``; the VAE's ``latent_means`` on the JAX model's
weights (moved with ``params_from_jax``); the intermediate callback of the
VAE and the GMVAE (the epochs at which it calls the analyser, and what it
hands it: the latent means of the training set's first 2,000 rows, to
rtol 1e-5 and an absolute 1e-6 of the largest |value|) on the development
split; and ``train`` with an analyser, on
the device path and streamed, at JAX's epochs, with the last call's values
those of the stored parameters."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.models import vae as jvae
from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
from scvae_tpu.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
)
from scvae_tpu.utils.profiling import log_spaced_indices as jax_log_spaced
from scvae_tpu_torch import (
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import vae as tvae
from scvae_tpu_torch.utils.profiling import log_spaced_indices

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 10, 11, 12, 50, 200, 1_000])
@pytest.mark.parametrize("count", [11, 4])
def test_log_spaced_indices_match_jax(n, count):
    got, want = log_spaced_indices(n, count), jax_log_spaced(n, count)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _port(tree):
    return tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("architecture", ["MLP", "LFM"])
def test_vae_latent_means_match_jax(architecture):
    common = dict(feature_size=30, latent_size=4, hidden_sizes=(16, 12),
                  inference_architecture=architecture)
    jconfig, tconfig = jvae.VAEConfig(**common), tvae.VAEConfig(**common)
    params, state = jvae.init(jconfig, jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)),
        params)
    x = np.random.RandomState(3).poisson(2.0, (24, 30)).astype(np.float32)
    want = np.asarray(jvae.latent_means(jconfig, params, state,
                                        jnp.asarray(x)))
    got = tvae.latent_means(tconfig, _port(params), _port(state),
                            torch.from_numpy(x))
    assert not got.requires_grad and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def development_splits(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("data"))
    return [module("development", directory=directory,
                   example_filter=["random", 400]).split(method="random",
                                                         fraction=0.9)
            for module in (JaxDataSet, DataSet)]


MODELS = {
    "vae": (VariationalAutoencoder, JaxVAE, {}),
    "gmvae": (GaussianMixtureVariationalAutoencoder, JaxGMVAE,
              {"number_of_latent_clusters": 3}),
}


def _models(kind, directory):
    port_class, jax_class, options = MODELS[kind]
    arguments = dict(feature_size=25, latent_size=3, hidden_sizes=[8],
                     reconstruction_distribution="poisson",
                     log_directory=str(directory), **options)
    return port_class(**arguments), jax_class(**arguments)


@pytest.mark.parametrize("kind", list(MODELS))
def test_intermediate_callback_matches_jax(kind, development_splits,
                                           tmp_path):
    """Both callbacks over 12 epochs of the same parameters."""
    (jax_training, _, _), (training, _, _) = development_splits
    port, jax_model = _models(kind, tmp_path)
    jax_model._active_mesh = None
    jax_calls, port_calls = [], []
    jax_callback = jax_model._make_intermediate_callback(
        lambda **call: jax_calls.append(call), jax_training, 12, "r1", "A")
    port_callback = port._make_intermediate_callback(
        lambda **call: port_calls.append(call), training, 12, "r1", "A", CPU)
    jax_state = jax_model._init_state(jax.random.PRNGKey(0))
    port_state = types.SimpleNamespace(params=_port(jax_state.params),
                                       model_state=_port(jax_state.model_state))
    for epoch in range(12):
        jax_callback(epoch, jax_state, {})
        port_callback(epoch, port_state, {})
    assert [call["epoch"] for call in port_calls] == [
        call["epoch"] for call in jax_calls] == log_spaced_indices(12).tolist()
    for got, want in zip(port_calls, jax_calls):
        assert sorted(got) == sorted(want)
        assert got["latent_values"].shape == (training.number_of_examples, 3)
        # float32 sums of head-product terms up to ~50 in magnitude, taken
        # in another order, move a small mean by ~1e-5: the absolute bound
        # is 1e-6 of the array's largest |value|
        largest = np.abs(want["latent_values"]).max()
        np.testing.assert_allclose(got["latent_values"], want["latent_values"],
                                   rtol=1e-5, atol=1e-6 * largest)
        assert got["data_set"] is training
        for key in ("model_name", "model_type", "run_id",
                    "analyses_directory"):
            assert got[key] == want[key], key


@pytest.mark.parametrize("placement", ["device", "streaming"])
def test_train_calls_analyser_at_jax_epochs(placement, development_splits,
                                            tmp_path):
    (jax_training, jax_validation, _), (training, validation, _) = (
        development_splits)
    port, _ = _models("vae", tmp_path / "port")
    _, jax_model = _models("vae", tmp_path / "jax")
    calls = {"port": [], "jax": []}
    user_epochs = []
    for name, model, sets in (("port", port, (training, validation)),
                              ("jax", jax_model,
                               (jax_training, jax_validation))):
        options = {"device": "cpu"} if name == "port" else {}
        model.train(
            *sets, number_of_epochs=4, minibatch_size=64,
            data_placement=placement, verbose=False,
            intermediate_analyser=lambda _name=name, **call: calls[
                _name].append(call),
            analyses_directory="A",
            epoch_callback=(lambda epoch, *_: user_epochs.append(epoch))
            if name == "port" else None,
            **options)
    assert [call["epoch"] for call in calls["port"]] == [
        call["epoch"] for call in calls["jax"]] == [0, 1, 2, 3]
    assert user_epochs == [0, 1, 2, 3]
    for got, want in zip(calls["port"], calls["jax"]):
        assert got["latent_values"].shape == want["latent_values"].shape
        assert got["model_name"] == want["model_name"]
        assert got["analyses_directory"] == "A"
    # the last call's values are the latent means of the stored parameters
    state, _ = port._restore(None, False, False, CPU)
    x = torch.from_numpy(training.values[:2000].toarray().astype(np.float32))
    np.testing.assert_array_equal(
        calls["port"][-1]["latent_values"],
        tvae.latent_means(port.config, state.params, state.model_state,
                          x).numpy())


def test_intermediate_analyses_of_a_large_labelled_set(tmp_path):
    """The callback hands over the first 2,000 rows' latent values; the
    port colours them with those rows' labels, where the JAX package takes
    every row's and fails on a labelled set of more than 2,000 rows
    (ROADMAP C)."""
    from scvae_tpu.analyses import analyses as janalyses
    from scvae_tpu_torch.analyses import analyses

    rs = np.random.RandomState(4)
    labels = np.array([f"type {i}" for i in rs.randint(0, 3, 2_500)])
    values = rs.poisson(1.0, (2_500, 4)).astype(np.float32)
    latent = rs.randn(2_000, 3)
    saved = analyses.analyse_intermediate_results(
        0, latent_values=latent,
        data_set=DataSet("synthetic", values=values, labels=labels),
        model_name="VAE/model", analyses_directory=str(tmp_path / "port"),
        device="cpu")
    assert [path.endswith("latent_space.png") for path in saved] == [True]
    with pytest.raises(IndexError):
        janalyses.analyse_intermediate_results(
            0, latent_values=latent,
            data_set=JaxDataSet("synthetic", values=values, labels=labels),
            model_name="VAE/model", analyses_directory=str(tmp_path / "jax"))
    # at 2,000 rows or fewer the two write the same figure
    for module, orchestrator, directory, extra in (
            (DataSet, analyses.analyse_intermediate_results, "port",
             {"device": "cpu"}),
            (JaxDataSet, janalyses.analyse_intermediate_results, "jax", {})):
        orchestrator(0, latent_values=latent[:, :2],
                     data_set=module("synthetic", values=values[:2_000],
                                     labels=labels[:2_000]),
                     model_name="VAE/model",
                     analyses_directory=str(tmp_path / "small" / directory),
                     **extra)
    name = "VAE/model/intermediate/epoch_1/latent_space.png"
    assert (tmp_path / "small" / "port" / name).read_bytes() == (
        tmp_path / "small" / "jax" / name).read_bytes()
