"""The deferred metric fetch, the Adam count as a tensor and the
asynchronous checkpoint writes of the port, against its own sync mode and
the JAX package, on the CPU.

* A VAE-NB and a GMVAE with a validation set, 4 epochs through the API with
  ``metrics_fetch="deferred"`` and "sync": the same curves (rtol 1e-6),
  epochs trained, best epoch, and epochs in ``checkpoint.json`` of the run,
  ``best/`` and ``early_stopping/`` (the port of ``tests/test_api.py``'s
  sync-against-deferred test);
* scripted validation curves that improve, degrade and stop early (rounds
  = 2) through both packages' deferred loops: the same history, stop and
  files of each version (epoch and stored parameters);
* a deferred run resumed at epoch 2 gives the curves, parameters and
  optimiser state of an uninterrupted deferred run, bit for bit;
* ``ClipAdam``, whose count is a 0-d int32 tensor, follows
  ``optax.chain(optax.clip(1.0), optax.adam(lr))`` over 5 steps (rtol 1e-6:
  float32 arithmetic in another order), and its checkpoint holds the int32
  ``.count`` that the JAX package restores;
* asynchronous writes leave the files of synchronous ones, take their
  values when queued, and raise a failed write when waited for.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scvae_tpu.models import checkpoints as jcheckpoints
from scvae_tpu.models import step as jstep
from scvae_tpu.models import training as jtraining
from scvae_tpu_torch import (
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import checkpoints, step, training

F, LATENT, HIDDEN, B = 14, 3, [10, 8], 16
VERSIONS = ("", "best", "early_stopping")


def _counts(n, seed=0):
    return np.random.RandomState(seed).poisson(2.0, (n, F)).astype(np.float32)


def _model(kind, directory):
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  learning_rate=1e-3, log_directory=str(directory))
    if kind == "vae":
        return VariationalAutoencoder(
            reconstruction_distribution="negative binomial", **common)
    return GaussianMixtureVariationalAutoencoder(
        reconstruction_distribution="negative binomial",
        number_of_latent_clusters=3, prior_probabilities_method="learn",
        **common)


def _stored_epochs(directory):
    return {version: checkpoints.load_metadata(
                os.path.join(directory, version))["epoch"]
            for version in VERSIONS
            if checkpoints.checkpoint_exists(os.path.join(directory,
                                                          version))}


def _flat(train_state):
    return tparams.train_state_to_jax(train_state.params,
                                      train_state.model_state,
                                      train_state.opt_state, train_state.step)


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_deferred_equals_sync(kind, tmp_path):
    x, valid = _counts(64), _counts(24, seed=1)
    runs = {}
    for mode in ("sync", "deferred"):
        model = _model(kind, tmp_path / mode)
        result = model.train(x, valid, number_of_epochs=4, minibatch_size=B,
                             device="cpu", verbose=False, metrics_fetch=mode)
        runs[mode] = (result, _stored_epochs(model.log_directory()),
                      checkpoints.load_learning_curves(model.log_directory()))
    (want, want_files, want_curves), (got, got_files, got_curves) = (
        runs["sync"], runs["deferred"])
    assert got.history.keys() == want.history.keys() == {"training",
                                                          "validation"}
    for kind_ in want.history:
        assert got.history[kind_].keys() == want.history[kind_].keys()
        for name, values in want.history[kind_].items():
            np.testing.assert_allclose(got.history[kind_][name], values,
                                       rtol=1e-6, err_msg=f"{kind_} {name}")
    assert got_curves == got.history and want_curves == want.history
    assert (got.number_of_epochs_trained, got.best_epoch, got.stopped_early) \
        == (want.number_of_epochs_trained, want.best_epoch,
            want.stopped_early) == (4, want.best_epoch, False)
    assert got_files == want_files and got_files[""] == 4
    assert len(got.epoch_seconds) == 4


# Validation curves that improve, degrade and stop early at rounds = 2;
# one ends while degrading, one ends on an improvement.
CURVES = {
    "stops": [-10.0, -9.0, -9.5, -8.0, -8.5, -8.7, -7.0],
    "degrading": [-10.0, -9.0, -9.5, -8.0, -8.5],
    "improving": [-10.0, -10.5, -9.0, -9.2, -8.0],
}
ROUNDS = 2


def _version_files(directory):
    """{version: (epoch, stored w)} of the run's three versions."""
    out = {}
    for version in VERSIONS:
        path = os.path.join(directory, version)
        if os.path.exists(os.path.join(path, "checkpoint.npz")):
            with np.load(os.path.join(path, "checkpoint.npz")) as data:
                w = data[".params['w']"].tolist()
            with open(os.path.join(path, "checkpoint.json")) as f:
                out[version] = (json.load(f)["epoch"], w)
    return out


def _run_jax_loop(curve, directory, fetch_mode):
    def run_epoch(ts, epoch, wuw, rng):
        return jstep.TrainState(
            params={"w": jnp.full((2,), epoch + 1.0)}, model_state={},
            opt_state={}, step=ts.step + 1), {"lower_bound": jnp.float32(-1)}

    def evaluate_validation(ts, rng):
        return {"lower_bound": curve[int(ts.params["w"][0]) - 1]}

    ts = jstep.TrainState(params={"w": jnp.zeros(2)}, model_state={},
                          opt_state={}, step=jnp.zeros((), jnp.int32))
    return jtraining.run_training_loop(
        train_state=ts, run_epoch=run_epoch, evaluate_training=None,
        evaluate_validation=evaluate_validation,
        number_of_epochs=len(curve), rng=jax.random.PRNGKey(0),
        log_directory=directory, early_stopping_rounds=ROUNDS, verbose=False,
        fetch_mode=fetch_mode)


def _run_port_loop(curve, directory, fetch_mode, async_checkpoints=True):
    """The port's loop on a train state updated in place, as the training
    epochs update theirs: a deferred loop that read it instead of its
    snapshot would see the next epoch's parameters."""
    ts = step.TrainState(
        params={"w": torch.zeros(2)}, model_state={},
        opt_state={"mu": {"w": torch.zeros(2)}, "nu": {"w": torch.zeros(2)},
                   "count": torch.zeros((), dtype=torch.int32)}, step=0)

    def run_epoch(ts, epoch, wuw, generator):
        ts.params["w"].fill_(epoch + 1.0)
        ts.opt_state["count"].add_(1)
        ts.step += 1
        return ts, {"lower_bound": torch.tensor(-1.0)}

    def evaluate_validation(ts, generator):
        return {"lower_bound": curve[int(ts.params["w"][0]) - 1]}

    return training.run_training_loop(
        train_state=ts, run_epoch=run_epoch, evaluate_training=None,
        evaluate_validation=evaluate_validation, number_of_epochs=len(curve),
        generator=torch.Generator(), steps_per_epoch=1,
        log_directory=directory, early_stopping_rounds=ROUNDS, verbose=False,
        fetch_mode=fetch_mode, async_checkpoints=async_checkpoints)


@pytest.mark.parametrize("case", list(CURVES))
def test_deferred_loops_match_jax(case, tmp_path):
    curve = CURVES[case]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _run_jax_loop(curve, jdir, "deferred")
    got = _run_port_loop(curve, tdir, "deferred")
    assert (got.stopped_early, got.best_epoch, got.number_of_epochs_trained) \
        == (want.stopped_early, want.best_epoch,
            want.number_of_epochs_trained)
    assert got.history == want.history
    assert _version_files(tdir) == _version_files(jdir)
    if case == "stops":
        assert got.stopped_early and got.number_of_epochs_trained < len(curve)
    sync = _run_port_loop(curve, str(tmp_path / "sync"), "sync")
    assert sync.history == got.history
    assert _version_files(str(tmp_path / "sync")) == _version_files(tdir)


def test_deferred_resume_equals_uninterrupted(tmp_path):
    x, valid = _counts(64), _counts(24, seed=1)
    runs = {}
    for label, epochs in (("whole", (4,)), ("resumed", (2, 4))):
        model = _model("vae", tmp_path / label)
        for number_of_epochs in epochs:
            result = model.train(x, valid, number_of_epochs=number_of_epochs,
                                 minibatch_size=B, device="cpu",
                                 verbose=False, metrics_fetch="deferred")
        runs[label] = (model, result)
    (whole, want), (resumed, got) = runs["whole"], runs["resumed"]
    assert got.history == want.history
    assert len(got.history["validation"]["lower_bound"]) == 4
    a, b = _flat(got.train_state), _flat(want.train_state)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert (_stored_epochs(resumed.log_directory())
            == _stored_epochs(whole.log_directory()))


def test_clip_adam_count_tensor_matches_optax(tmp_path):
    rng = np.random.RandomState(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    optimizer = optax.chain(optax.clip(1.0), optax.adam(1e-2))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = optimizer.init(jparams)
    for g in grads:
        updates, jstate = optimizer.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

    adam = step.make_optimizer(1e-2)
    tparams_ = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt_state = adam.init(tparams_)
    count = opt_state["count"]
    assert count.dtype == torch.int32 and count.dim() == 0
    for g in grads:
        adam.update_(tparams_, [torch.from_numpy(g[k]) for k in tparams_],
                     opt_state)
    assert opt_state["count"] is count and int(count) == 5
    for k in params:
        np.testing.assert_allclose(tparams_[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)

    ts = step.TrainState(params=tparams_, model_state={}, opt_state=opt_state,
                         step=5)
    checkpoints.save_checkpoint(str(tmp_path), ts, epoch=1)
    template = jstep.TrainState(params=jparams, model_state={},
                                opt_state=jstate, step=jnp.zeros((), jnp.int32))
    restored, metadata = jcheckpoints.restore_checkpoint(str(tmp_path),
                                                         template)
    adam_state = restored.opt_state[1][0]
    assert adam_state.count.dtype == jnp.int32 and int(adam_state.count) == 5
    assert int(restored.step) == metadata["step"] == 5
    # and back: the count a tensor again, on the template's device
    back, _ = checkpoints.restore_checkpoint(str(tmp_path), ts)
    assert isinstance(back.opt_state["count"], torch.Tensor)
    assert int(back.opt_state["count"]) == 5 and back.step == 5


@pytest.mark.parametrize("case", ["stops", "improving"])
def test_async_writes_leave_sync_files(case, tmp_path):
    curve = CURVES[case]
    files = {}
    for async_checkpoints in (True, False):
        directory = str(tmp_path / str(async_checkpoints))
        _run_port_loop(curve, directory, "sync", async_checkpoints)
        files[async_checkpoints] = (
            _version_files(directory),
            {version: checkpoints.load_metadata(os.path.join(directory,
                                                             version))
             for version in _version_files(directory)})
    assert files[True] == files[False]


def test_async_write_takes_values_when_queued(tmp_path):
    w = torch.zeros(1000)
    ts = step.TrainState(params={"w": w}, model_state={},
                         opt_state={"mu": {"w": torch.zeros(1000)},
                                    "nu": {"w": torch.zeros(1000)},
                                    "count": torch.zeros((), dtype=torch.int32)},
                         step=0)
    for epoch in range(1, 6):
        w.fill_(float(epoch))
        checkpoints.save_checkpoint(str(tmp_path / str(epoch)), ts,
                                    epoch=epoch, async_write=True)
    w.fill_(-1.0)
    checkpoints.copy_checkpoint_version(str(tmp_path / "5"),
                                        str(tmp_path / "5" / "best"),
                                        async_write=True)
    checkpoints.remove_checkpoint(str(tmp_path / "4"), async_write=True)
    checkpoints.wait_for_pending_writes()
    for epoch in (1, 2, 3, 5):
        with np.load(tmp_path / str(epoch) / "checkpoint.npz") as data:
            assert np.all(data[".params['w']"] == epoch)
    assert _stored_epochs(str(tmp_path / "5")) == {"": 5, "best": 5}
    assert not checkpoints.checkpoint_exists(str(tmp_path / "4"))


def test_failed_async_write_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ts = step.TrainState(params={"w": torch.zeros(2)}, model_state={},
                         opt_state={"mu": {"w": torch.zeros(2)},
                                    "nu": {"w": torch.zeros(2)}, "count": 0})
    checkpoints.save_checkpoint(str(blocker / "run"), ts, epoch=1,
                                async_write=True)
    with pytest.raises(OSError):
        checkpoints.wait_for_pending_writes()
    checkpoints.wait_for_pending_writes()  # the queue is empty again
