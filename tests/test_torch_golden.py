"""The golden runs of ``tests/test_golden.py`` in the port.

The JAX package's ±2% bands pin its own seed-0 draws, not the model (its
seeds 1–4 land far outside them), so the port is held to them on JAX's
draws:

1. the port's development set with ``example_filter=["random", 1000]`` and
   the random 0.9 split equals JAX's in values, names, labels and the rows
   of each split, in order;
2. both golden configurations, trained by the port from JAX's initial
   weights (``params.params_from_jax`` of JAX's init from the run's key)
   with every training step's and every evaluation batch's z noise drawn
   from the keys JAX derives for them, follow JAX's run in this test: the
   KL curves within rtol 1e-3 at every epoch, the validation curves inside
   the ±2% bands at every golden epoch, the GMVAE's accuracies within
   0.01, and after epoch 1 every parameter element but the noise-driven
   ones (below) within 1e-6.  The draws go in through a test-side
   substitution of the port's ``Normal.sample``;
3. with the noise-driven elements frozen on both sides (the ``-frozen``
   cases) every parameter agrees with JAX's to 1e-6 after every epoch and
   the lower bounds follow JAX's within rtol 1e-3 at every epoch;
4. on the port's own draws the curves are finite and the accuracies lie in
   [0, 1], and the deferred fetch gives the sync fetch's accuracies.

The noise-driven elements are those whose gradient is zero in exact
arithmetic (``_noise_driven``).  Adam takes full-size steps on their
rounding noise, so they move by up to 0.06 and differ from JAX's by as
much; the evaluation's batch norm, which uses the running statistics,
passes their shift on to the lower bound.  JAX's run takes the same steps
on its own rounding, so any implementation that rounds otherwise parts from
it there, and how far depends on the host's rounding: the unfrozen lower
bounds are therefore held to the bands only.  On one x86 host the
unfrozen VAE's training lower bound read 3.8e-4, 4.3e-3 and 6.2e-3 from
JAX's over epochs 1–3 and 2.5e-2 at epoch 10 (validation 3.9e-5 to
1.9e-2), the unfrozen GMVAE's 1.1e-3, 1.8e-4 and 2.3e-4 (validation
7.7e-4 to 2.1e-4), with the KL within 2.0e-4; another host read the VAE
within 1e-3 through epoch 3.  Frozen, both read within 2e-6 at every
epoch and every parameter within 1.2e-7.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.models import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
    VariationalAutoencoder as JaxVAE,
)
from scvae_tpu.models import step as jstep
from scvae_tpu_torch import (
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.distributions.normal import Normal
from scvae_tpu_torch.models import api
from scvae_tpu_torch.models import step as tstep

MINIBATCH = 100
COMMON = dict(feature_size=25, latent_size=2, hidden_sizes=[32],
              reconstruction_distribution="negative binomial")
TRAIN = dict(minibatch_size=MINIBATCH, learning_rate=1e-3, seed=0,
             verbose=False)
# name: (model kwargs, epochs, keys split per forward pass, the golden
#        bands of tests/test_golden.py)
CONFIGS = {
    "vae": (dict(number_of_warm_up_epochs=5), 10, 3,
            {"lower_bound": {0: -14318.4, 4: -24735.4, 9: -6052.0}}),
    "gmvae": (dict(number_of_latent_clusters=3), 3, 4,
              {"lower_bound": {0: -7576.6, 1: -6453.5, 2: -8586.9},
               "kl_divergence": {0: 570.50, 1: 320.11, 2: 255.02}}),
}


def _models(name, log_directory):
    kwargs, epochs = CONFIGS[name][:2]
    jax_class, port_class = {
        "vae": (JaxVAE, VariationalAutoencoder),
        "gmvae": (JaxGMVAE, GaussianMixtureVariationalAutoencoder),
    }[name]
    return tuple(model_class(**COMMON, **kwargs,
                             log_directory=str(log_directory / where))
                 for model_class, where in ((jax_class, "jax"),
                                            (port_class, "port"))) + (epochs,)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """(JAX's, the port's) development splits, each with its own cache."""
    def split(data_set_class):
        directory = str(tmp_path_factory.mktemp("data"))
        return data_set_class("development", directory=directory,
                              example_filter=["random", 1000]).split(
                                  method="random", fraction=0.9)

    return split(JaxDataSet), split(DataSet)


def test_development_split_equals_jax(splits):
    for jax_set, port_set in zip(*splits):
        assert port_set.kind == jax_set.kind
        np.testing.assert_array_equal(port_set.values.toarray(),
                                      jax_set.values.toarray())
        assert port_set.values.dtype == jax_set.values.dtype
        # the example names number the rows: equal names are equal rows
        np.testing.assert_array_equal(port_set.example_names,
                                      jax_set.example_names)
        np.testing.assert_array_equal(port_set.feature_names,
                                      jax_set.feature_names)
        np.testing.assert_array_equal(port_set.labels, jax_set.labels)
        assert port_set.labels.dtype == jax_set.labels.dtype
        np.testing.assert_array_equal(port_set.superset_labels,
                                      jax_set.superset_labels)
        assert port_set.class_names == jax_set.class_names
        assert port_set.excluded_classes == jax_set.excluded_classes
    assert [s.number_of_examples for s in splits[1]] == [810, 90, 100]


def _normal(key, keys_per_pass, shape):
    """The standard-normal draws of a forward pass given ``key``: the VAE
    splits it in three, the GMVAE in four, and samples z with the third."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key, keys_per_pass)[2], shape)))


def _jax_draws(epochs, n_training, n_validation, keys_per_pass, z_shape):
    """Every z draw of JAX's sync loop (``scvae_tpu/models/training.py:
    240-257``), in the port's order: each epoch's training steps (a key
    split per step, ``step.py:252``), then the full-pass evaluations of the
    training and the validation set (a key split per full batch, then the
    remainder's from the evaluator's own key, ``step.py:305-338`` and
    ``api.py:531-592``).  ``z_shape(rows)`` is a pass's z shape."""
    draws = []
    rng, _ = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]))

    def evaluation(key, n):
        n_full = jstep.sequential_batches(n, MINIBATCH).size
        batch_key = key
        for _ in range(n_full // MINIBATCH):
            batch_key, sub = jax.random.split(batch_key)
            draws.append(_normal(sub, keys_per_pass, z_shape(MINIBATCH)))
        if n > n_full:
            draws.append(_normal(jax.random.split(key)[1], keys_per_pass,
                                 z_shape(n - n_full)))

    for _ in range(epochs):
        rng, step_key = jax.random.split(rng)
        for _ in range(n_training // MINIBATCH):
            step_key, sub = jax.random.split(step_key)
            draws.append(_normal(sub, keys_per_pass, z_shape(MINIBATCH)))
        rng, sub = jax.random.split(rng)
        evaluation(sub, n_training)
        rng, sub = jax.random.split(rng)
        evaluation(sub, n_validation)
    return draws


@pytest.fixture
def jax_draws(monkeypatch):
    """Route the port's z draws through a queue of JAX's draws."""
    queue = collections.deque()
    original = Normal.sample

    def sample(self, generator, sample_shape=(), noise=None):
        if noise is None:
            noise = queue.popleft()
        return original(self, generator, sample_shape, noise=noise)

    monkeypatch.setattr(Normal, "sample", sample)
    return queue


def _noise_driven(name, key, shape):
    """The elements of a leaf whose gradient is zero in exact arithmetic, as
    a boolean mask.  Found by a float64 gradient of JAX's loss at JAX's
    initial weights on the first minibatches, where the other elements read
    0.03 or more: in both models the biases right before batch norm (at
    most 6.4e-14); in the VAE also the posterior mean's bias while the KL
    weight is 0 (3.1e-15; the decoder's batch norm removes it); in the
    GMVAE the rows of q(z|x, y)'s first kernel that multiply the one-hot y
    (4e-17: each cluster's pass adds them to every row, and its batch norm
    removes them).  The GMVAE warms up for no epoch, so its q(z|x, y) mean
    bias always has a gradient (3.5)."""
    mask = np.zeros(shape, bool)
    if (("['layers']" in key and key.endswith("['bias']"))
            or (name == "vae" and key == "['posterior']['mu']['bias']")):
        mask[...] = True
    elif name == "gmvae" and key == "['q_z']['encoder']['layers'][0]['kernel']":
        mask[COMMON["feature_size"]:] = True
    return mask


def _freeze_noise_driven(name, monkeypatch):
    """Set the updates of the noise-driven elements to zero in JAX's and in
    the port's optimiser (otherwise each is ``clip(1.0)`` then Adam)."""
    def jax_optimizer(learning_rate):
        def zero_noise_driven(updates, params=None):
            return jax.tree_util.tree_map_with_path(
                lambda path, update: jnp.where(
                    _noise_driven(name, jax.tree_util.keystr(path),
                                  update.shape), 0.0, update),
                updates)
        return optax.chain(optax.stateless(zero_noise_driven),
                           optax.clip(1.0), optax.adam(learning_rate))

    class FrozenClipAdam(tstep.ClipAdam):
        def update_(self, params, grads, opt_state):
            masks = {id(leaf): torch.from_numpy(
                         _noise_driven(name, key, tuple(leaf.shape)))
                     for key, leaf in tparams.flatten(params).items()}
            grads = [grad.masked_fill(masks[id(leaf)], 0.0)
                     for leaf, grad in zip(tstep.tree_leaves(params), grads)]
            super().update_(params, grads, opt_state)

    monkeypatch.setattr(jstep, "make_optimizer", jax_optimizer)
    monkeypatch.setattr(tstep, "make_optimizer", FrozenClipAdam)


@pytest.mark.parametrize("name, frozen", [("vae", False), ("vae", True),
                                          ("gmvae", False), ("gmvae", True)],
                         ids=["vae", "vae-frozen", "gmvae", "gmvae-frozen"])
def test_golden_run_on_jax_draws(name, frozen, splits, jax_draws, tmp_path,
                                 monkeypatch):
    (jax_train, jax_valid, _), (train_set, valid_set, _) = splits
    jax_model, model, epochs = _models(name, tmp_path)
    if frozen:
        _freeze_noise_driven(name, monkeypatch)
    per_epoch = {"jax": [], "port": []}

    def keep_parameters(side, flatten):
        def callback(epoch, train_state, epoch_metrics):
            per_epoch[side].append({
                key: np.array(leaf)
                for key, leaf in flatten(train_state.params).items()})
        return callback

    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want = jax_model.train(
        jax_train, jax_valid, number_of_epochs=epochs,
        data_placement="device",
        epoch_callback=keep_parameters(
            "jax", lambda tree: tparams.flatten(as_numpy(tree))),
        **TRAIN).history

    # JAX's initial weights, drawn from the run's key (api.py:757-759)
    init_key = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]))[1]
    start = jax_model._init_state(init_key)

    def init_state(generator, optimizer, device):
        return api._place(tparams.params_from_jax(as_numpy(start.params)),
                          tparams.params_from_jax(as_numpy(start.model_state)),
                          optimizer, device)

    monkeypatch.setattr(model, "_init_state", init_state)
    keys_per_pass = CONFIGS[name][2]
    clusters = () if name == "vae" else (model.number_of_latent_clusters,)
    jax_draws.extend(_jax_draws(
        epochs, train_set.number_of_examples, valid_set.number_of_examples,
        keys_per_pass,
        lambda rows: (1,) + clusters + (rows, COMMON["latent_size"])))
    got = model.train(train_set, valid_set, number_of_epochs=epochs,
                      device="cpu",
                      epoch_callback=keep_parameters("port", tparams.flatten),
                      **TRAIN).history
    assert not jax_draws  # every draw of JAX's run was used, in turn

    # frozen: every parameter is JAX's after every epoch; else after epoch 1
    # every parameter but the noise-driven ones
    for epoch in range(epochs if frozen else 1):
        for key, leaf in per_epoch["port"][epoch].items():
            checked = (np.ones(leaf.shape, bool) if frozen
                       else ~_noise_driven(name, key, leaf.shape))
            np.testing.assert_allclose(
                leaf[checked], per_epoch["jax"][epoch][key][checked], rtol=0,
                atol=1e-6, err_msg=f"{key} epoch {epoch + 1}")

    for kind in ("training", "validation"):
        assert len(got[kind]["lower_bound"]) == epochs
        np.testing.assert_allclose(got[kind]["kl_divergence"],
                                   want[kind]["kl_divergence"], rtol=1e-3,
                                   err_msg=kind)
        if frozen:
            np.testing.assert_allclose(got[kind]["lower_bound"],
                                       want[kind]["lower_bound"], rtol=1e-3,
                                       err_msg=kind)
    for metric, band in CONFIGS[name][3].items():
        curve = got["validation"][metric]
        assert np.all(np.isfinite(curve))
        for epoch, value in band.items():
            np.testing.assert_allclose(curve[epoch], value, rtol=0.02,
                                       err_msg=f"{metric} epoch {epoch}")
    if name == "gmvae":
        for kind in ("training", "validation"):
            np.testing.assert_allclose(got[kind]["accuracy"],
                                       want[kind]["accuracy"], atol=0.01,
                                       err_msg=kind)


@pytest.mark.parametrize("name", ["vae", "gmvae"])
def test_golden_run_on_own_draws(name, splits, tmp_path, monkeypatch):
    _, (train_set, valid_set, _) = splits
    monkeypatch.chdir(tmp_path)
    _, model, epochs = _models(name, tmp_path)
    history = model.train(train_set, valid_set, number_of_epochs=epochs,
                          device="cpu", **TRAIN).history
    for kind in ("training", "validation"):
        assert len(history[kind]["lower_bound"]) == epochs
        assert np.all(np.isfinite(history[kind]["lower_bound"]))
        if name == "gmvae":
            accuracy = history[kind]["accuracy"]
            assert len(accuracy) == epochs
            assert all(0.0 <= a <= 1.0 for a in accuracy)
        else:
            assert "accuracy" not in history[kind]


def test_accuracy_equal_in_both_fetch_modes(splits, tmp_path):
    _, (train_set, valid_set, _) = splits
    histories = {}
    for fetch in ("sync", "deferred"):
        model = GaussianMixtureVariationalAutoencoder(
            **COMMON, **CONFIGS["gmvae"][0],
            log_directory=str(tmp_path / fetch))
        histories[fetch] = model.train(
            train_set, valid_set, number_of_epochs=3, device="cpu",
            metrics_fetch=fetch, **TRAIN).history
    for kind in ("training", "validation"):
        assert histories["deferred"][kind] == histories["sync"][kind]
        assert len(histories["sync"][kind]["accuracy"]) == 3
