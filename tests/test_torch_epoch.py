"""The port's compiled epoch on the CPU: ``make_train_epoch`` and
``make_eval_epoch`` against the JAX package's ``lax.scan`` epochs, and what
a CUDA graph's capture needs of the step.

* One training epoch of a small NB VAE (batch norm on, four minibatches of a
  shuffled permutation) through both packages' ``make_train_epoch``, with
  JAX's own z draws handed to the port's fused path: the epoch's metrics
  and the parameters after it follow JAX at the trajectory test's rtol
  1e-3 (PARITY.md §2), and the port's Adam count is a device tensor of 4;
* one full evaluation pass through both packages' ``make_eval_epoch`` with
  the posterior means as z: the means of the batches' metrics at
  ``tests/test_torch_checkpoints.py``'s tolerances (ELBO and reconstruction
  rtol 2e-4, KL 2e-3: the packages' special functions differ in their last
  digits);
* a training step and an evaluation batch of every model family run
  without an operation that a CUDA graph's capture refuses (a host copy
  into a tensor, a host read of a device value, a data-dependent shape):
  recorded with a ``TorchDispatchMode`` on the CPU;
* a warm-up weight handed over as a 0-d tensor gives the loss of the
  float, an epoch refuses a train state or data other than those it was
  first called with, and the launch counters add what a replay launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from scvae_tpu.models import step as jstep
from scvae_tpu.models import vae as jvae
from scvae_tpu_torch import ops
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.data.dataset import DataSet
from scvae_tpu_torch.data.pipeline import (
    build_model_arrays,
    device_resident_data,
)
from scvae_tpu_torch.models import api, gmvae, step, vae

F, LATENT, HIDDEN, B, N, LR = 12, 3, (8,), 16, 64, 1e-3
CONFIG = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
              reconstruction_distribution="negative binomial")


def _data():
    return np.random.RandomState(1234).poisson(2.0, (N, F)).astype(np.float32)


def _jax_start():
    config = jvae.VAEConfig(**CONFIG)
    params, state = jvae.init(config, jax.random.PRNGKey(0))
    return config, params, state


def _port_state(params, state):
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (tparams.params_from_jax(as_numpy(params)),
            tparams.params_from_jax(as_numpy(state)))


def test_train_epoch_matches_jax():
    jconfig, params, state = _jax_start()
    tconfig = vae.VAEConfig(**CONFIG)
    x = _data()
    perm = jstep.epoch_permutation(N, B, np.random.RandomState(3))
    rng = jax.random.PRNGKey(7)

    def jax_loss(params, model_state, batch, rng, wuw):
        return jvae.loss_fn(jconfig, params, model_state, batch, rng,
                            warm_up_weight=wuw)

    optimizer = jstep.make_optimizer(LR)
    train_epoch = jstep.make_train_epoch(jax_loss, optimizer, donate=False)
    ts, jmetrics = train_epoch(
        jstep.create_train_state(params, state, optimizer),
        {"x": jnp.asarray(x), "t": jnp.asarray(x)}, jnp.asarray(perm), rng,
        1.0)

    # JAX's z draws: the scan splits the key once a step, the VAE's
    # forward splits that key in three and samples with the third
    noises, key = [], rng
    for _ in range(perm.shape[0]):
        key, sub = jax.random.split(key)
        noises.append(torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(sub, 3)[2], (1, B, LATENT)))))
    noise = iter(noises)

    def port_loss(params, model_state, batch, generator, wuw, shard=None):
        return vae.loss_fn(tconfig, params, model_state, batch, generator,
                           warm_up_weight=wuw, noise=next(noise), shard=shard)

    t_optimizer = step.make_optimizer(LR)
    tts = step.create_train_state(*_port_state(params, state), t_optimizer)
    xt = torch.from_numpy(x)
    tts, tmetrics = step.make_train_epoch(port_loss, t_optimizer)(
        tts, {"x": xt, "t": xt}, torch.from_numpy(perm), None, 1.0)

    assert tmetrics.keys() == jmetrics.keys()
    for name in jmetrics:
        np.testing.assert_allclose(float(tmetrics[name]),
                                   float(jmetrics[name]), rtol=1e-3,
                                   err_msg=name)
    assert tts.step == int(ts.step) == perm.shape[0]
    count = tts.opt_state["count"]
    assert isinstance(count, torch.Tensor) and count.dtype == torch.int32
    assert int(count) == perm.shape[0]
    flat_jax = tparams.flatten(jax.tree_util.tree_map(np.asarray, ts.params))
    for name, leaf in tparams.flatten(tts.params).items():
        if "['layers']" in name and name.endswith("['bias']"):
            continue  # zero gradient before batch norm (test_torch_train)
        np.testing.assert_allclose(leaf.numpy(), flat_jax[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    flat_state = tparams.flatten(jax.tree_util.tree_map(np.asarray,
                                                        ts.model_state))
    # the running means take 1e-3 of each batch mean, which carries the
    # bias before batch norm that Adam moves by up to lr a step on noise
    # (skipped above): 4 steps · 1e-3 · 4e-3 apart at most
    for name, leaf in tparams.flatten(tts.model_state).items():
        np.testing.assert_allclose(leaf.numpy(), flat_state[name], rtol=1e-3,
                                   atol=2e-5, err_msg=name)


EVAL_RTOL = {"lower_bound": 2e-4, "reconstruction_error": 2e-4,
             "kl_divergence": 2e-3, "kl_divergence_neurons": 2e-3}


def test_eval_epoch_matches_jax():
    jconfig, params, state = _jax_start()
    tconfig = vae.VAEConfig(**CONFIG)
    x = _data()
    idx = jstep.sequential_batches(N - 5, B)  # a remainder left out

    def jax_eval(params, model_state, batch, rng):
        return jvae.elbo_terms(jconfig, params, model_state, batch, rng,
                               training=False, deterministic_z=True)[0]

    want = jstep.make_eval_epoch(jax_eval)(
        params, state, {"x": jnp.asarray(x), "t": jnp.asarray(x)},
        jnp.asarray(idx), jax.random.PRNGKey(0))

    def port_eval(params, model_state, batch, generator, shard=None):
        return vae.elbo_terms(tconfig, params, model_state, batch, generator,
                              training=False, deterministic_z=True,
                              shard=shard)[0]

    tparams_, tstate = _port_state(params, state)
    xt = torch.from_numpy(x)
    got = step.make_eval_epoch(port_eval)(tparams_, tstate,
                                          {"x": xt, "t": xt},
                                          torch.from_numpy(idx), None)
    assert got.keys() == want.keys() == set(step.EVAL_METRIC_KEYS)
    for name, rtol in EVAL_RTOL.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=rtol, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# What a capture needs of the step
# --------------------------------------------------------------------------

# Operations a CUDA graph's capture refuses: a host tensor made and copied
# to the device (lift_fresh), a device value read on the host, shapes that
# depend on values.
_REFUSED = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
            "aten.masked_select", "aten.unique", "aten.item")


class _Refused(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(_REFUSED):
            self.seen.append(name)
        if name.startswith("aten.index.Tensor") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            self.seen.append(f"{name} with a mask")
        return func(*args, **(kwargs or {}))


SMALL = dict(feature_size=20, latent_size=3, hidden_sizes=(8, 8))
MODELS = {
    "vae-nb": (vae, vae.VAEConfig(
        reconstruction_distribution="negative binomial", **SMALL)),
    "vae-cp": (vae, vae.VAEConfig(
        reconstruction_distribution="constrained poisson", **SMALL)),
    "vae-poisson-cat": (vae, vae.VAEConfig(
        reconstruction_distribution="poisson",
        number_of_reconstruction_classes=3, **SMALL)),
    "gmvae-custom": (gmvae, gmvae.GMVAEConfig(
        number_of_latent_clusters=3, prior_probabilities_method="custom",
        prior_probabilities=(0.2, 0.3, 0.5),
        proportion_of_free_nats_for_y_kl_divergence=0.5, **SMALL)),
    "gmvae-learn": (gmvae, gmvae.GMVAEConfig(
        number_of_latent_clusters=3, prior_probabilities_method="learn",
        **SMALL)),
    "gmvae-uniform": (gmvae, gmvae.GMVAEConfig(
        number_of_latent_clusters=3, prior_probabilities_method="uniform",
        proportion_of_free_nats_for_y_kl_divergence=0.5, **SMALL)),
}


def _model(kind):
    module, config = MODELS[kind]
    x = np.random.RandomState(0).poisson(2.0, (64, 20)).astype(np.float32)
    data = api._append_lgamma_rowsum(device_resident_data(
        build_model_arrays(DataSet("in-memory", values=x),
                           use_count_sum_as_parameter=(
                               config.use_count_sum_as_parameter)),
        device="cpu"), config)
    optimizer = step.make_optimizer(1e-3)
    ts = step.create_train_state(
        *module.init(config, torch.Generator().manual_seed(0)), optimizer)

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return module.loss_fn(config, params, model_state, batch, generator,
                              warm_up_weight=warm_up_weight, shard=shard)

    def evaluate(params, model_state, batch, generator, shard=None):
        return module.elbo_terms(config, params, model_state, batch,
                                 generator, training=False, shard=shard)[0]

    return data, optimizer, ts, loss, evaluate


@pytest.mark.parametrize("kind", list(MODELS))
def test_step_has_no_operation_a_capture_refuses(kind):
    data, optimizer, ts, loss, evaluate = _model(kind)
    perm = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    train_epoch = step.make_train_epoch(loss, optimizer)
    eval_epoch = step.make_eval_epoch(evaluate)
    generator = torch.Generator().manual_seed(0)
    train_epoch(ts, data, perm, generator, 0.5)  # the first call binds
    eval_epoch(ts.params, ts.model_state, data, perm, generator)
    for epoch in (train_epoch, eval_epoch):
        epoch._index.zero_()
        with _Refused() as refused:
            epoch._body()  # what a capture records
        assert refused.seen == [], (kind, refused.seen)


def test_warm_up_weight_tensor_gives_the_float_loss():
    data, optimizer, ts, loss, _ = _model("gmvae-learn")
    batch = step.cast_batch_to_f32(step.gather_batch(
        data, torch.arange(32, dtype=torch.int32)))
    for weight in (0.0, 0.25, 1 / 3, 1.0):
        losses = [loss(ts.params, ts.model_state, batch,
                       torch.Generator().manual_seed(1), w)[0]
                  for w in (weight, torch.tensor(weight))]
        assert torch.equal(*losses), weight


def test_epoch_refuses_other_state_and_data():
    data, optimizer, ts, loss, _ = _model("vae-nb")
    perm = torch.arange(64, dtype=torch.int32).reshape(2, 32)
    train_epoch = step.make_train_epoch(loss, optimizer)
    generator = torch.Generator().manual_seed(0)
    ts, metrics = train_epoch(ts, data, perm, generator, 1.0)
    assert ts.step == 2 and np.isfinite(float(metrics["lower_bound"]))
    with pytest.raises(ValueError, match="first called with"):
        train_epoch(step.snapshot_state(ts), data, perm, generator, 1.0)
    with pytest.raises(ValueError, match="first called with"):
        train_epoch(ts, {k: v.clone() for k, v in data.items()}, perm,
                    generator, 1.0)
    with pytest.raises(ValueError, match="index rows"):
        train_epoch(ts, data, perm.reshape(4, 16), generator, 1.0)
    ts, _ = train_epoch(ts, data, perm.flip(1), generator, 1.0)
    assert ts.step == 4 and int(ts.opt_state["count"]) == 4


def test_snapshot_state_is_a_copy():
    _, _, ts, _, _ = _model("gmvae-learn")
    copy = step.snapshot_state(ts)
    for a, b in zip(step.tree_leaves(ts.params) + [ts.opt_state["count"]],
                    step.tree_leaves(copy.params)
                    + [copy.opt_state["count"]]):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    ts.opt_state["count"].add_(3)
    assert int(copy.opt_state["count"]) == 0 and copy.step == ts.step


def test_launch_counts_add_replays():
    ops.reset_launch_counts()
    ops.add_launch_counts({"nb_forward": 1, "gather_rows": 2, "other": 5},
                          times=3)
    counts = ops.launch_counts()
    assert counts["nb_forward"] == 3 and counts["gather_rows"] == 6
    assert "other" not in counts
    ops.add_launch_counts({"nb_forward": 1}, times=-3)
    assert ops.launch_counts()["nb_forward"] == 0
    ops.reset_launch_counts()
