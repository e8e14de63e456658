"""The model options and the unfused training path against the JAX package:
batch correction, the count sum as a decoder feature, the LFM encoder and
decoder, ``fused_likelihood=False`` over the four base families, a
categorised likelihood over the 32-head cap (K = 40, unfused), every other
reconstruction distribution, and the GMVAE's batch correction, count sum
feature, full-covariance latent and unfused path.  Each case runs the
training objective and its whole parameter gradient on both sides with the
same weights (the port's init, moved with ``params_to_jax``), batch and z
noise; the JAX side's fused cases run its Pallas kernels in interpret mode.

The multivariate Gaussian and the Gaussian mixture have no JAX VAE to hold
the port to: JAX's init makes the multivariate Gaussian's scales head F wide
(its ``fill_triangular`` wants F(F+1)/2), and its ``elbo_terms`` sums the
per-example log-probability of both over the batch axis before its reshape.
For them the JAX side is JAX's own forward pass and distributions on the
port's weights, with JAX's objective arithmetic written out here.

Then a three-epoch API run of a VAE with NB, batch correction, the count sum
feature and ``fused_likelihood=False`` (at the default learning rate) on
JAX's initial weights and z draws follows JAX's learning curves.

Tolerances: the objective's terms rtol 2e-4 (KL 2e-3), as
``tests/test_torch_vae.py``; the gradient ‖Δ‖/‖g‖ ≤ 1e-4 in float32; the
learning curves rtol 1e-3."""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.distributions import kl_divergence as jax_kl
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import vae as jvae
from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
from scvae_tpu.models.objectives import log_reduce_exp
from scvae_tpu.ops import force_pallas
from scvae_tpu_torch import DataSet, VariationalAutoencoder
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.distributions.normal import Normal
from scvae_tpu_torch.models import api
from scvae_tpu_torch.models import gmvae as tgmvae
from scvae_tpu_torch.models import vae as tvae

F, LATENT, HIDDEN, B, BATCHES, K = 10, 4, (16, 8), 12, 3, 3
NB = "negative binomial"
BATCH_KWARGS = dict(batch_correction=True, number_of_batches=BATCHES)

VAE_CASES = {
    "batch-correction": (NB, BATCH_KWARGS),
    "count-sum": (NB, dict(count_sum=True)),
    "lfm-encoder": (NB, dict(inference_architecture="LFM")),
    "lfm-decoder-batch": (NB, dict(generative_architecture="LFM",
                                   count_sum=True, **BATCH_KWARGS)),
    "lfm-both": (NB, dict(inference_architecture="LFM",
                          generative_architecture="LFM")),
    "unfused-nb": (NB, dict(fused_likelihood=False)),
    "unfused-poisson": ("poisson", dict(fused_likelihood=False)),
    "unfused-zip": ("zero-inflated poisson", dict(fused_likelihood=False)),
    "unfused-zinb": ("zero-inflated negative binomial",
                     dict(fused_likelihood=False)),
    "poisson-cat-40": ("poisson", dict(number_of_reconstruction_classes=40)),
    "bernoulli": ("bernoulli", {}),
    "gaussian": ("gaussian", {}),
    "log-normal": ("log-normal", {}),
    "lomax": ("lomax", {}),
    "emg": ("exponentially_modified_gaussian", {}),
    "gamma": ("gamma", {}),
    "multivariate-gaussian": ("multivariate gaussian", {}),
    "gaussian-mixture": ("gaussian mixture", {}),
}
GMVAE_CASES = {
    "batch-count-sum": (NB, dict(count_sum=True, **BATCH_KWARGS)),
    "full-covariance": (NB, dict(
        latent_distribution="full-covariance gaussian mixture")),
    "full-covariance-unfused-batch": ("poisson", dict(
        latent_distribution="full-covariance gaussian mixture",
        fused_likelihood=False, **BATCH_KWARGS)),
    "unfused-zinb": ("zero-inflated negative binomial",
                     dict(fused_likelihood=False)),
}


def _targets(name, x):
    if name == "gamma":
        return x + 1.0  # zero is outside the support
    if name == "bernoulli":
        return (x > 0).astype(np.float32)
    return x


def _batch(name, x, to, seed):
    """The fields of one batch as ``to`` makes arrays; the batch indices are
    float32 on the port's side, as the row gather hands them over."""
    rng = np.random.RandomState(seed)
    count_sum = x.sum(-1, keepdims=True).astype(np.float32)
    indices = rng.randint(0, BATCHES, (len(x), 1))
    return {
        "x": to(x), "t": to(_targets(name, x)), "count_sum": to(count_sum),
        "count_sum_feature": to(count_sum / count_sum.max()),
        "batch_indices": to(indices.astype(
            np.int32 if to is jnp.asarray else np.float32)),
    }


@contextlib.contextmanager
def _jax_kernels():
    with force_pallas(), pltpu.force_tpu_interpret_mode():
        yield


def _weights(tmodule, tconfig, seed):
    """The port's initial weights with non-trivial offsets, as the port's
    and the JAX package's trees."""
    params, state = tmodule.init(tconfig, torch.Generator().manual_seed(seed))
    for i, leaf in enumerate(tparams.flatten(params).values()):
        leaf += 0.05 * torch.cos(torch.arange(leaf.numel()).reshape(
            leaf.shape) + i)
    to_jax = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, tparams.params_to_jax(tree))
    return params, state, to_jax(params), to_jax(state)


def _jax_event_loss(jconfig, params, state, batch, rng):
    """JAX's VAE objective (``scvae_tpu/models/vae.py:489-550``) with the
    per-example log-probability of an event distribution taken as it is."""
    out = jvae.forward(jconfig, params, state, batch, rng, training=True)
    log_p_x = jnp.reshape(out.p_x.log_prob(batch["t"]), (1, 1, B))
    kl = jnp.sum(jax_kl(out.q_z, out.p_z), axis=-1)
    return -jnp.mean(log_reduce_exp(log_p_x - 0.5 * kl, axis=0)), {
        "reconstruction_error": jnp.mean(log_p_x),
        "lower_bound": jnp.mean(log_reduce_exp(log_p_x - kl, axis=0)),
    }


def _compare(jm, tm, keys):
    for key in keys:
        rtol = 2e-3 if key.startswith("kl_divergence") else 2e-4
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=rtol, err_msg=key)


def _gradient_error(loss, leaves, jgrads, named):
    ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert ref.keys() == named.keys()
    want = np.concatenate([np.ravel(ref[key]) for key in named])
    got = torch.cat([g.ravel() for g in torch.autograd.grad(loss, leaves)])
    return np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", list(VAE_CASES))
def test_vae_loss_and_gradients_match_jax(case):
    name, kwargs = VAE_CASES[case]
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  reconstruction_distribution=name, **kwargs)
    tconfig = tvae.VAEConfig(**common)
    fused = tvae.fused_path_enabled(tconfig)
    assert fused == (case in ("batch-correction", "count-sum", "lfm-encoder",
                              "lfm-decoder-batch", "lfm-both"))
    event = tconfig.reconstruction_spec.event
    tp, ts, jp, js = _weights(tvae, tconfig, seed=1)
    x = np.random.RandomState(2).poisson(2.0, (B, F)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jbatch = _batch(name, x, jnp.asarray, 3)

    if event:
        jconfig = jvae.VAEConfig(**common)

        def jax_loss(p):
            return _jax_event_loss(jconfig, p, js, jbatch, rng)
    else:
        jconfig = jvae.VAEConfig(**{**common, "fused_likelihood": fused})

        def jax_loss(p):
            loss, (metrics, _) = jvae.loss_fn(jconfig, p, js, jbatch, rng,
                                              warm_up_weight=0.5)
            return loss, metrics

    with _jax_kernels() if fused else contextlib.nullcontext():
        (jloss, jm), jgrads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(jp)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    noise = np.array(jax.random.normal(jax.random.split(rng, 3)[2],
                                       (1, B, LATENT)))
    loss, (tm, _) = tvae.loss_fn(tconfig, tp, ts,
                                 _batch(name, x, torch.from_numpy, 3), None,
                                 warm_up_weight=0.5,
                                 noise=torch.from_numpy(noise))
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4)
    _compare(jm, tm, ("lower_bound", "reconstruction_error") if event else (
        "lower_bound", "reconstruction_error", "kl_divergence"))
    assert _gradient_error(loss, leaves, jgrads, named) <= 1e-4
    if "inference_architecture" in kwargs:
        assert "encoder" not in tp
    if "generative_architecture" in kwargs:
        assert "decoder" not in tp
        width = LATENT + BATCHES * bool(kwargs.get("batch_correction")) + bool(
            kwargs.get("count_sum"))
        assert tuple(tp["reconstruction"]["p"]["kernel"].shape) == (width, F)


@pytest.mark.parametrize("case", list(GMVAE_CASES))
def test_gmvae_loss_and_gradients_match_jax(case):
    name, kwargs = GMVAE_CASES[case]
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  reconstruction_distribution=name,
                  number_of_latent_clusters=K, **kwargs)
    tconfig = tgmvae.GMVAEConfig(**common)
    fused = tgmvae.fused_path_enabled(tconfig)
    assert fused == ("fused_likelihood" not in kwargs)
    jconfig = jgmvae.GMVAEConfig(**{**common, "fused_likelihood": fused})
    tp, ts, jp, js = _weights(tgmvae, tconfig, seed=2)
    x = np.random.RandomState(4).poisson(2.0, (B, F)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    jbatch = _batch(name, x, jnp.asarray, 6)

    def jax_loss(p):
        loss, (metrics, _) = jgmvae.loss_fn(jconfig, p, js, jbatch, rng,
                                            warm_up_weight=0.5)
        return loss, metrics

    with _jax_kernels() if fused else contextlib.nullcontext():
        (jloss, jm), jgrads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(jp)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    noise = np.array(jax.random.normal(jax.random.split(rng, 4)[2],
                                       (1, K, B, LATENT)))
    loss, (tm, _) = tgmvae.loss_fn(tconfig, tp, ts,
                                   _batch(name, x, torch.from_numpy, 6), None,
                                   warm_up_weight=0.5,
                                   noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4)
    _compare(jm, tm, ("lower_bound", "reconstruction_error", "kl_divergence",
                      "kl_divergence_z", "kl_divergence_y"))
    np.testing.assert_allclose(tm["kl_divergence_neurons"].detach().numpy(),
                               np.asarray(jm["kl_divergence_neurons"]),
                               rtol=2e-3, atol=1e-5)
    assert _gradient_error(loss, leaves, jgrads, named) <= 1e-4
    if "latent_distribution" in kwargs:
        scales = tp["q_z"]["heads"]["scales"]["kernel"]
        assert scales.shape[-1] == LATENT * (LATENT + 1) // 2
        centroids = tgmvae.prior_centroids(tconfig, tp)
        want = jgmvae.prior_centroids(jconfig, jp)
        for key in ("probabilities", "means", "covariance_matrices"):
            np.testing.assert_allclose(centroids[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        covariances = centroids["covariance_matrices"]
        assert covariances.shape == (K, LATENT, LATENT)
        np.testing.assert_allclose(covariances,
                                   np.swapaxes(covariances, -1, -2))
        assert np.all(np.linalg.eigvalsh(covariances) > 0)


# -- three epochs through both APIs -----------------------------------------

N_TRAIN, N_VALID, MINIBATCH, EPOCHS, SEED = 300, 100, 100, 3, 0
RUN = dict(feature_size=F, latent_size=LATENT, hidden_sizes=[16],
           reconstruction_distribution=NB, batch_correction=True,
           number_of_batches=4, count_sum=True, fused_likelihood=False)


def _sets(data_set_class):
    rng = np.random.RandomState(0)
    values = rng.poisson(3.0, (N_TRAIN + N_VALID, F)).astype(np.float32)
    indices = rng.randint(0, 4, N_TRAIN + N_VALID)
    return [data_set_class("in-memory", values=values[rows],
                           batch_indices=indices[rows])
            for rows in (slice(0, N_TRAIN), slice(N_TRAIN, None))]


def _jax_draws():
    """Every z draw of JAX's sync loop, in the port's order (as
    ``tests/test_torch_golden.py`` lays them out): each epoch's training
    steps, then the full-pass evaluations of the training and the
    validation set, whose rows are whole minibatches (no remainder
    batch)."""
    assert N_TRAIN % MINIBATCH == 0 and N_VALID % MINIBATCH == 0
    def normal(key, rows):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(key, 3)[2], (1, rows, LATENT))))

    draws = []
    rng, _ = jax.random.split(jax.random.PRNGKey(SEED))

    def evaluation(key, n):
        batch_key = key
        for _ in range(n // MINIBATCH):
            batch_key, sub = jax.random.split(batch_key)
            draws.append(normal(sub, MINIBATCH))

    for _ in range(EPOCHS):
        rng, step_key = jax.random.split(rng)
        for _ in range(N_TRAIN // MINIBATCH):
            step_key, sub = jax.random.split(step_key)
            draws.append(normal(sub, MINIBATCH))
        rng, sub = jax.random.split(rng)
        evaluation(sub, N_TRAIN)
        rng, sub = jax.random.split(rng)
        evaluation(sub, N_VALID)
    return draws


def test_three_epochs_unfused_with_batch_correction_follow_jax(tmp_path,
                                                               monkeypatch):
    jax_model = JaxVAE(**RUN, log_directory=str(tmp_path / "jax"))
    want = jax_model.train(*_sets(JaxDataSet), number_of_epochs=EPOCHS,
                           minibatch_size=MINIBATCH,
                           seed=SEED, data_placement="device",
                           verbose=False).history
    model = VariationalAutoencoder(**RUN, log_directory=str(tmp_path / "port"))
    start = jax_model._init_state(
        jax.random.split(jax.random.PRNGKey(SEED))[1])
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

    def init_state(generator, optimizer, device):
        return api._place(tparams.params_from_jax(as_numpy(start.params)),
                          tparams.params_from_jax(as_numpy(start.model_state)),
                          optimizer, device)

    monkeypatch.setattr(model, "_init_state", init_state)
    queue = collections.deque(_jax_draws())
    original = Normal.sample

    def sample(self, generator, sample_shape=(), noise=None):
        if noise is None:
            noise = queue.popleft()
        return original(self, generator, sample_shape, noise=noise)

    monkeypatch.setattr(Normal, "sample", sample)
    got = model.train(*_sets(DataSet), number_of_epochs=EPOCHS,
                      minibatch_size=MINIBATCH, seed=SEED,
                      device="cpu", verbose=False).history
    assert not queue  # every draw of JAX's run was used, in turn
    for kind in ("training", "validation"):
        for key in ("lower_bound", "reconstruction_error", "kl_divergence"):
            assert len(got[kind][key]) == EPOCHS
            np.testing.assert_allclose(got[kind][key], want[kind][key],
                                       rtol=1e-3, err_msg=f"{kind} {key}")
