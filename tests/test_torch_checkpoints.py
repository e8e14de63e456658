"""Run names, checkpoints, early stopping and resume in the port against the
JAX package.

* model names and log directories are the JAX package's strings;
* a checkpoint that the JAX package writes (a small VAE and GMVAE after two
  clip + Adam steps; an LFM VAE, a VAE with batch correction and the count
  sum feature, a batch-corrected GMVAE with the full-covariance latent)
  restores in the port leaf for leaf, optimiser moments and step included,
  and gives JAX's evaluation outputs; a checkpoint that the port writes
  after two CPU training epochs restores in JAX likewise;
* on a fixed validation curve the port's loop makes JAX's early-stopping
  decisions and leaves the same ``best/`` and ``early_stopping/`` files, and
  its learning curves load with JAX's ``load_learning_curves``;
* four epochs equal two epochs and a resume of two, bit for bit.

Restored leaves are compared exactly.  Evaluation outputs on the restored
weights (the JAX model's own z draws injected): the latent means and z rtol
1e-5 (atol 1e-6); the reconstruction's means and standard deviations rtol
1e-4, since they leave the decoder through exp (an NB mean of 128 read
4.2e-5 apart: the activation's float32 rounding, ~1e-6 of a value near 5,
becomes a relative error of the mean); the ELBO and reconstruction term rtol
2e-4 and the KL terms 2e-3, as in ``tests/test_torch_vae.py`` (the two
packages' special functions differ in their last digits).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu.models import checkpoints as jcheckpoints
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import naming as jnaming
from scvae_tpu.models import step as jstep
from scvae_tpu.models import training as jtraining
from scvae_tpu.models import vae as jvae
from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
from scvae_tpu.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
)
from scvae_tpu_torch import (
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import checkpoints, naming, step, training
from scvae_tpu_torch.models import gmvae as tgmvae
from scvae_tpu_torch.models import vae as tvae

F, LATENT, HIDDEN, B, K = 14, 3, [10, 8], 16, 3
MODELS = {
    "vae": (VariationalAutoencoder, JaxVAE, tvae, jvae,
            dict(reconstruction_distribution="negative binomial")),
    "gmvae": (GaussianMixtureVariationalAutoencoder, JaxGMVAE, tgmvae, jgmvae,
              dict(reconstruction_distribution="zero-inflated negative "
                   "binomial", number_of_latent_clusters=K,
                   prior_probabilities_method="learn")),
    # no encoder or decoder subtree
    "vae-lfm": (VariationalAutoencoder, JaxVAE, tvae, jvae,
                dict(reconstruction_distribution="negative binomial",
                     inference_architecture="LFM",
                     generative_architecture="LFM")),
    # a wider first decoder layer
    "vae-batch": (VariationalAutoencoder, JaxVAE, tvae, jvae,
                  dict(reconstruction_distribution="negative binomial",
                       batch_correction=True, number_of_batches=3,
                       count_sum=True)),
    # the full-covariance heads: locations and triangular scales
    "gmvae-full": (GaussianMixtureVariationalAutoencoder, JaxGMVAE, tgmvae,
                   jgmvae,
                   dict(reconstruction_distribution="negative binomial",
                        number_of_latent_clusters=K, batch_correction=True,
                        number_of_batches=3,
                        latent_distribution="full-covariance gaussian "
                        "mixture")),
}


def _models(kind, directory):
    port_cls, jax_cls, _, _, kwargs = MODELS[kind]
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  learning_rate=1e-3, log_directory=str(directory), **kwargs)
    return port_cls(**common), jax_cls(**common)


def _counts(n, seed=0):
    return np.random.RandomState(seed).poisson(2.0, (n, F)).astype(np.float32)


def _batch_indices(n, seed=0):
    return np.random.RandomState(seed + 1).randint(0, 3, (n, 1)).astype(
        np.int32)


def _batch(kind, x, seed, to):
    """x, t and, where the model takes them, the batch indices and the
    normalised count sum, as ``to`` makes arrays."""
    kwargs = MODELS[kind][4]
    batch = {"x": to(x), "t": to(x)}
    if kwargs.get("batch_correction"):
        batch["batch_indices"] = to(_batch_indices(len(x), seed))
    if kwargs.get("count_sum"):
        count_sum = x.sum(-1, keepdims=True)
        batch["count_sum_feature"] = to(count_sum / count_sum.max())
    return batch


def _training_set(kind, n):
    """``n`` counts, as a data set with batch indices where the model
    corrects for them."""
    x = _counts(n)
    if not MODELS[kind][4].get("batch_correction"):
        return x
    return DataSet("in-memory", values=x, batch_indices=_batch_indices(n))


def _jax_noise(kind, rng):
    """The z draws of JAX's forward in evaluation mode: the VAE splits its
    key in three, the GMVAE in four, and samples with the third."""
    if MODELS[kind][2] is tvae:
        return np.array(jax.random.normal(jax.random.split(rng, 3)[2],
                                          (1, B, LATENT)))
    return np.array(jax.random.normal(jax.random.split(rng, 4)[2],
                                      (1, K, B, LATENT)))


def _assert_same_evaluation(kind, port_model, jax_model, tstate, jstate):
    _, _, tmodule, jmodule, _ = MODELS[kind]
    x = _counts(B, seed=3)
    rng = jax.random.PRNGKey(11)
    want = jmodule.evaluation_outputs(
        jax_model.config, jstate.params, jstate.model_state,
        _batch(kind, x, 3, jnp.asarray), rng)
    got = tmodule.evaluation_outputs(
        port_model.config, tstate.params, tstate.model_state,
        _batch(kind, x, 3, torch.from_numpy), None,
        noise=torch.from_numpy(_jax_noise(kind, rng)))
    for key, rtol in (("p_x_mean", 1e-4), ("p_x_stddev", 1e-4),
                      ("stddev_of_p_x_given_z_mean", 1e-4), ("q_z_mean", 1e-5),
                      ("z", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, atol=1e-6, err_msg=key)
    for key, rtol in (("lower_bound", 2e-4), ("reconstruction_error", 2e-4),
                      ("kl_divergence", 2e-3)):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=rtol, err_msg=key)


def _flat(train_state):
    return tparams.train_state_to_jax(train_state.params,
                                      train_state.model_state,
                                      train_state.opt_state, train_state.step)


@pytest.mark.parametrize("kind", list(MODELS))
def test_names_match_jax(kind, tmp_path):
    port_model, jax_model = _models(kind, tmp_path)
    assert port_model.name == jax_model.name
    for run_id in (None, "run-7_b"):
        for early, best in ((False, False), (True, False), (False, True)):
            assert port_model.log_directory(
                run_id=run_id, early_stopping=early, best_model=best) == (
                jax_model.log_directory(run_id=run_id, early_stopping=early,
                                        best_model=best))
    names = [
        dict(latent_distribution="gaussian", reconstruction_distribution="poisson",
             latent_size=100, hidden_sizes=(256, 256)),
        dict(latent_distribution="gaussian mixture", number_of_latent_clusters=3,
             parameterise_latent_posterior=True, inference_architecture="LFM",
             reconstruction_distribution="zero-inflated negative binomial",
             k_max=10, use_count_sum_as_feature=True, latent_size=2,
             hidden_sizes=(100,), number_of_monte_carlo_samples=2,
             number_of_importance_samples=5, analytical_kl_term=True,
             minibatch_normalisation=True, batch_correction=True,
             dropout_parts=["0.9", "0.8"], kl_weight=0.5,
             number_of_warm_up_epochs=3, prior_probabilities_method="learn"),
    ]
    for kwargs in names:
        assert naming.model_name(kind.upper(), **kwargs) == (
            jnaming.model_name(kind.upper(), **kwargs))
    for versions in ("all", None, "eot", ["best", "es"], "Early Stopping"):
        assert naming.parse_model_versions(versions) == (
            jnaming.parse_model_versions(versions))
    for module in (naming, jnaming):
        with pytest.raises(ValueError):
            module.parse_model_versions("latest")
        with pytest.raises(ValueError):
            module.check_run_id("a b")
        with pytest.raises(ValueError):
            module.log_directory("m", "n", early_stopping=True,
                                 best_model=True)
        assert naming.check_run_id(module.generate_run_id())


def _jax_trained_state(kind, jax_model):
    """A JAX train state after two clip + Adam steps."""
    _, _, _, jmodule, _ = MODELS[kind]
    config = jax_model.config
    optimizer = jstep.make_optimizer(1e-3)
    ts = jax_model._init_state(jax.random.PRNGKey(0))

    def loss(params, model_state, batch, rng, wuw):
        return jmodule.loss_fn(config, params, model_state, batch, rng,
                               warm_up_weight=wuw)

    train_step = jstep.make_train_step(loss, optimizer, donate=False)
    batch = _batch(kind, _counts(B), 0, jnp.asarray)
    for i in range(2):
        ts, _ = train_step(ts, batch, jax.random.PRNGKey(20 + i), 1.0)
    return ts


@pytest.mark.parametrize("kind", list(MODELS))
def test_jax_checkpoint_restores_in_port(kind, tmp_path):
    port_model, jax_model = _models(kind, tmp_path)
    ts = _jax_trained_state(kind, jax_model)
    directory = jax_model.log_directory(best_model=True)
    jcheckpoints.save_checkpoint(directory, ts, epoch=2, step=int(ts.step))
    restored, where = port_model._restore(None, False, True,
                                          torch.device("cpu"))
    assert where == directory
    want = jcheckpoints._flatten(ts)
    got = _flat(restored)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert restored.step == restored.opt_state["count"] == 2
    _assert_same_evaluation(kind, port_model, jax_model, restored, ts)


@pytest.mark.parametrize("kind", list(MODELS))
def test_port_checkpoint_restores_in_jax(kind, tmp_path):
    port_model, jax_model = _models(kind, tmp_path)
    result = port_model.train(_training_set(kind, 64), number_of_epochs=2,
                              minibatch_size=B, device="cpu", verbose=False)
    directory = port_model.log_directory()
    assert directory == jax_model.log_directory()
    assert jtraining.resume_start_epoch(directory) == 2
    template = jax_model._init_state(jax.random.PRNGKey(1))
    jstate, metadata = jcheckpoints.restore_checkpoint(directory, template)
    assert metadata["epoch"] == 2 and metadata["step"] == 8
    want = _flat(result.train_state)
    got = jcheckpoints._flatten(jstate)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # with no validation set the best version is the latest
    jbest, _ = jcheckpoints.restore_checkpoint(
        jax_model.log_directory(best_model=True), template)
    np.testing.assert_array_equal(
        jcheckpoints._flatten(jbest)[".step"], got[".step"])
    curves = jcheckpoints.load_learning_curves(directory)
    assert curves == checkpoints.load_learning_curves(directory)
    assert curves == result.history
    _assert_same_evaluation(kind, port_model, jax_model, result.train_state,
                            jstate)


# Validation curves: one that stops after three epochs without improvement,
# one that ends while degrading, one that ends on an improvement.
CURVES = {
    "stops": [-10.0, -9.0, -9.5, -8.0, -8.5, -8.7, -8.6, -7.0, -7.5],
    "degrading": [-10.0, -9.0, -9.5, -8.0, -8.5, -8.7],
    "improving": [-10.0, -10.5, -9.0, -9.2, -8.0],
}
ROUNDS = 3


def _version_files(directory):
    """{version: (epoch, stored w)} of the run's three versions."""
    out = {}
    for version in ("", "best", "early_stopping"):
        path = os.path.join(directory, version)
        if os.path.exists(os.path.join(path, "checkpoint.npz")):
            with np.load(os.path.join(path, "checkpoint.npz")) as data:
                w = data[".params['w']"].tolist()
            with open(os.path.join(path, "checkpoint.json")) as f:
                out[version] = (json.load(f)["epoch"], w)
    return out


def _run_jax_loop(curve, directory):
    def run_epoch(ts, epoch, wuw, rng):
        return jstep.TrainState(
            params={"w": jnp.full((2,), epoch + 1.0)}, model_state={},
            opt_state={}, step=ts.step + 1), {"lower_bound": -1.0}

    def evaluate_validation(ts, rng):
        return {"lower_bound": curve[int(ts.params["w"][0]) - 1]}

    ts = jstep.TrainState(params={"w": jnp.zeros(2)}, model_state={},
                          opt_state={}, step=jnp.zeros((), jnp.int32))
    return jtraining.run_training_loop(
        train_state=ts, run_epoch=run_epoch, evaluate_training=None,
        evaluate_validation=evaluate_validation,
        number_of_epochs=len(curve), rng=jax.random.PRNGKey(0),
        log_directory=directory, early_stopping_rounds=ROUNDS, verbose=False)


def _run_port_loop(curve, directory):
    def state(w, count):
        return step.TrainState(
            params={"w": torch.full((2,), float(w))}, model_state={},
            opt_state={"mu": {"w": torch.zeros(2)}, "nu": {"w": torch.zeros(2)},
                       "count": count}, step=count)

    def run_epoch(ts, epoch, wuw, generator):
        return state(epoch + 1, ts.step + 1), {"lower_bound": -1.0}

    def evaluate_validation(ts, generator):
        return {"lower_bound": curve[int(ts.params["w"][0]) - 1]}

    return training.run_training_loop(
        train_state=state(0, 0), run_epoch=run_epoch, evaluate_training=None,
        evaluate_validation=evaluate_validation, number_of_epochs=len(curve),
        generator=torch.Generator(), steps_per_epoch=1,
        log_directory=directory, early_stopping_rounds=ROUNDS, verbose=False)


@pytest.mark.parametrize("case", list(CURVES))
def test_early_stopping_versions_match_jax(case, tmp_path):
    curve = CURVES[case]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _run_jax_loop(curve, jdir)
    got = _run_port_loop(curve, tdir)
    assert (got.stopped_early, got.best_epoch, got.number_of_epochs_trained) == (
        want.stopped_early, want.best_epoch, want.number_of_epochs_trained)
    assert got.history == want.history
    assert _version_files(tdir) == _version_files(jdir)
    assert jcheckpoints.load_learning_curves(tdir) == (
        jcheckpoints.load_learning_curves(jdir))
    from scvae_tpu.models.utilities import early_stopping_status as jstatus

    from scvae_tpu_torch.models.utilities import early_stopping_status
    seen = curve[:want.number_of_epochs_trained]
    assert early_stopping_status(seen, ROUNDS) == jstatus(seen, ROUNDS)


def test_resume_equals_uninterrupted(tmp_path):
    """Two epochs, then a resume to four (the early-stopping state rebuilt
    from the stored validation curve, the generator set to the stored
    state), give the parameters, optimiser state and files of four epochs in
    one run, bit for bit."""
    x, valid = _counts(64), _counts(24, seed=1)
    runs = {}
    for label, epochs in (("whole", (4,)), ("resumed", (2, 4))):
        model, _ = _models("vae", tmp_path / label)
        for number_of_epochs in epochs:
            result = model.train(x, valid, number_of_epochs=number_of_epochs,
                                 minibatch_size=B, device="cpu",
                                 verbose=False)
        runs[label] = (model, result)
    model_whole, want = runs["whole"]
    model_resumed, got = runs["resumed"]
    assert got.number_of_epochs_trained == want.number_of_epochs_trained == 4
    assert got.best_epoch == want.best_epoch
    a, b = _flat(got.train_state), _flat(want.train_state)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got.history == want.history
    assert len(got.history["validation"]["lower_bound"]) == 4
    for directory in (model_whole.log_directory(),
                      model_resumed.log_directory()):
        assert checkpoints.load_metadata(directory)["epoch"] == 4
    assert (checkpoints.load_learning_curves(model_resumed.log_directory())
            == checkpoints.load_learning_curves(model_whole.log_directory()))


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_default_log_directory_matches_jax(kind, tmp_path, monkeypatch):
    """Given no log directory, both packages write the run under
    ``models/<name>`` of the working directory and evaluate from it (each
    in a working directory of its own, or the second would resume the
    first's run)."""
    from scvae_tpu.data.dataset import DataSet as JaxDataSet

    port_cls, jax_cls, _, _, kwargs = MODELS[kind]
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  learning_rate=1e-3, **kwargs)
    x = _counts(64)
    for label, cls in (("jax", jax_cls), ("port", port_cls)):
        (tmp_path / label).mkdir()
        monkeypatch.chdir(tmp_path / label)
        model = cls(**common)
        assert model.log_directory() == os.path.join("models", model.name)
        if label == "jax":
            data, options = JaxDataSet("counts", values=x), {}
        else:
            data, options = x, {"device": "cpu"}
        model.train(data, number_of_epochs=1, minibatch_size=B,
                    verbose=False, **options)
        assert os.listdir(".") == ["models"]
        assert os.path.exists(os.path.join(
            model.log_directory(), checkpoints.CHECKPOINT_FILE))
        _, reconstructed, _ = model.evaluate(data, minibatch_size=B,
                                             verbose=False, **options)
        values = np.asarray(reconstructed.values)
        assert values.shape == (64, F) and np.all(np.isfinite(values))
