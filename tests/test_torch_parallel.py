"""The port's data parallel (``scvae_tpu_torch.parallel``) on two gloo
ranks on the CPU, against the JAX package's two-device mesh and against
one process of the port.

The module starts the two ranks once (``tests/torch_parallel_ranks.py``,
joined through a file store in ``tmp_path``, so that parallel workers
never race for a port) and, while they run, makes the JAX and one-process
references here.  It holds:

(a) the mesh: its shape on two ranks, and with a model axis of 2
    (``{"data": 1, "model": 2}``), the errors (a model axis of 3 does not
    divide two ranks; a mesh of two devices in a world of one, or a model
    axis of 2 there, names ``torchrun``), every parameter replicated, the
    train state whole on the rank's device;
(b) one value and gradient of the VAE (Poisson and NB, batch norm on)
    and of the GMVAE-NB (3 clusters) on a 32-row batch, JAX on
    ``create_mesh(n_devices=2)`` with ``shard_batch``, the port on two
    ranks of 16 rows, both on JAX's weights and JAX's z draws: the loss
    within 1e-6 relative, every gradient within 2e-5 of the largest; the
    same models with dropout on the port's own draws (the masks and z of
    the global batch from one generator) against one process of the port,
    within the same bounds;
(c) two ranks against one process through ``train`` on the golden VAE-NB
    and GMVAE-NB: each rank trains on its block of every row of
    ``epoch_permutation``, the curves agree within rtol 1e-3 and atol 1e-2
    at every epoch (the bound of ``tests/test_multihost.py``), the
    accuracies are equal, both ranks hold the same curves, rank 0 writes
    the files one process writes and rank 1 writes none; the deferred
    fetch gives the sync fetch's curves on two ranks too.  Every training
    run here, on one process or two, zeroes the updates of the elements
    whose gradient is zero in exact arithmetic, as
    ``tests/test_torch_golden.py``'s frozen cases do: Adam takes full-size
    steps on their rounding noise, which the order of the sums decides
    (unfrozen, the VAE's validation lower bound read 4.4e-4, 2.2e-4 and
    1.5e-3 apart over three epochs);
(d) ``evaluate`` of a trained checkpoint on 99 rows in batches of 20 (four
    cut over the ranks, a remainder of 19 whole on each) against one
    process's: the metrics within 1e-6 relative, the latent means, the
    responsibilities and the clusters equal; the reconstruction means
    and standard deviations within 1e-4 relative, because NB's mean
    r·p/(1 − p) multiplies the rounding of p by p/(1 − p), which reaches
    1e8 in this model (the decoder's products over 10 rows and over 20
    round otherwise; they read 2.2e-5 apart at most);
(e) streaming: 810 rows (a remainder batch of 10, cut over the ranks) and
    809 (a remainder of 9, whole on each rank), the curves within the
    bound of (c); each rank's block of a sharded pipeline's CSR wire is
    its rows of the one-process batch, and a remainder batch is whole; a
    batch in which one rank's block overflows the wire goes dense on both;
(f) a one-process checkpoint resumed on two ranks: the earlier epochs'
    curves kept, the resumed epoch within the bound of (c).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from scvae_tpu import parallel as jparallel
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import vae as jvae
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.data.pipeline import BatchPipeline
from scvae_tpu_torch.models import step as tstep
from scvae_tpu_torch.parallel import mesh as parallel

WORLD = 2
RANKS_TIMEOUT = 600
# the bound of tests/test_multihost.py:300-306
CURVE_RTOL, CURVE_ATOL = 1e-3, 1e-2


def _jax_step(case):
    """JAX's inputs (weights, batch-norm state, batch, z draws) and its
    loss and gradients on a two-device mesh."""
    model, kwargs = ranks.step_config(case)
    module = jgmvae if model == "gmvae" else jvae
    config = (jgmvae.GMVAEConfig if model == "gmvae"
              else jvae.VAEConfig)(**kwargs)
    params, state = module.init(config, jax.random.PRNGKey(0))
    # non-trivial offsets and batch-norm running statistics
    wave = lambda s: lambda a: a + s * jnp.cos(  # noqa: E731
        jnp.arange(a.size).reshape(a.shape))
    params = jax.tree_util.tree_map(wave(0.05), params)
    state = jax.tree_util.tree_map(wave(0.1), state)
    x = ranks.step_x()
    key = jax.random.PRNGKey(7)
    # the forward splits its key in three (VAE) or four (GMVAE) and draws
    # z with the third, at the global batch's shape
    if model == "gmvae":
        noise = jax.random.normal(jax.random.split(key, 4)[2], (
            1, ranks.STEP_CLUSTERS, ranks.STEP_ROWS, ranks.STEP_LATENT))
    else:
        noise = jax.random.normal(jax.random.split(key, 3)[2], (
            1, ranks.STEP_ROWS, ranks.STEP_LATENT))
    mesh = jparallel.create_mesh(n_devices=WORLD)
    batch = jparallel.shard_batch({"x": jnp.asarray(x), "t": jnp.asarray(x)},
                                  mesh)

    def loss(p):
        return module.loss_fn(config, p, state, batch, key,
                              warm_up_weight=1.0)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    as_numpy = lambda tree: {  # noqa: E731
        name: leaf.numpy() for name, leaf in tparams.flatten(
            tparams.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           tree))).items()}
    inputs = {f"params/{k}": v for k, v in as_numpy(params).items()}
    inputs |= {f"state/{k}": v for k, v in as_numpy(state).items()}
    inputs |= {"x": x, "noise": np.asarray(noise)}
    return inputs, float(value), as_numpy(grads)


def _pipeline_batches(values):
    """The one-process batches that ``ranks.pipeline_blocks`` cuts."""
    pipeline = BatchPipeline({"x": values, "t": values}, 30, shuffle=True,
                             seed=5, count_dtype=np.int16, wire_format="csr",
                             device="cpu")
    return [tstep.materialize_batch(batch)["x"].numpy()
            for batch in pipeline.epoch()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # one thread, as the ranks run: these shapes gain nothing from more,
    # and the workers of a parallel test run share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _runs(tmp_path_factory.mktemp("parallel"))
    finally:
        torch.set_num_threads(threads)


def _runs(root):
    single = root / "single"
    inputs, jax_steps = {}, {}
    for case in ranks.STEP_CASES:
        case_inputs, value, grads = _jax_step(case)
        inputs |= {f"step/{case}/{k}": v for k, v in case_inputs.items()}
        jax_steps[case] = (value, grads)
    for case in ranks.DROPOUT_CASES:
        jax_steps[case] = ranks.value_and_grad(case)
    np.savez(root / "inputs.npz", **inputs)
    splits = ranks.development_split()
    reference = {}
    frozen = pytest.MonkeyPatch()
    frozen.setattr(tstep, "make_optimizer", ranks.FrozenClipAdam)
    # one process first: the checkpoints that (f) resumes
    for kind in ranks.MODELS:
        trained = single / f"trained-{kind}"
        reference[f"train/{kind}"] = ranks.train_golden(kind, trained, splits)
        for where in (root, single):
            shutil.copytree(trained, where / f"resume-{kind}")
    # the ranks, then the other references while they run
    script = os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    processes = [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(root / "store"),
         str(root / "inputs.npz"), str(root / f"rank{r}.npz")],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    try:
        for n in (810, 809):
            reference[f"stream/{n}"] = ranks.train_streaming(
                "vae", single / f"stream-{n}", splits[0].values[:n])
        for kind in ranks.MODELS:
            reference[f"resume/{kind}"] = ranks.resume(
                kind, single / f"resume-{kind}", splits)
        reference["pipeline"] = _pipeline_batches(splits[0].values[:95])
        codes = [p.wait(timeout=RANKS_TIMEOUT) for p in processes]
    finally:
        frozen.undo()
        for p in processes:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(codes):
        text = "\n".join((root / f"rank{r}.log").read_text()[-4000:]
                         for r in range(WORLD))
        pytest.fail(f"ranks exited with {codes}:\n{text}")
    results = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    # (d) one process evaluates what rank 0 trained
    for kind in ranks.MODELS:
        reference[f"evaluate/{kind}"] = ranks.evaluate_golden(
            kind, root / f"trained-{kind}-rank0", splits[2].values[:99])
    return {"root": root, "single": single, "results": results,
            "reference": reference, "jax": jax_steps}


def _history(results, key):
    return json.loads(str(results[key]))


def _assert_curves_close(got, want):
    assert got.keys() == want.keys()
    for kind in want:
        assert got[kind].keys() == want[kind].keys()
        for name in want[kind]:
            np.testing.assert_allclose(got[kind][name], want[kind][name],
                                       rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                       err_msg=f"{kind} {name}")


def test_mesh_shapes_and_errors(runs):
    for results in runs["results"]:
        assert results["mesh_shape"].tolist() == [WORLD, 1]
        assert results["gene_mesh_shape"].tolist() == [1, WORLD]
        errors = [str(e) for e in results["mesh_errors"]]
        assert len(errors) == 1
        assert errors[0].startswith("3:ValueError:")
        assert results["replicated"].all()
        assert results["train_state_placed"].all()
    # in this process (a world of one), checked before any group is made
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        parallel.create_mesh(n_devices=2, device="cpu")
    with pytest.raises(ValueError,
                       match="not divisible.*torchrun --nproc-per-node 2"):
        parallel.create_mesh(model_parallelism=2, device="cpu")
    assert parallel.resolve_mesh(device="cpu") is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case", list(ranks.STEP_CASES)
                         + list(ranks.DROPOUT_CASES))
def test_one_step_on_two_ranks(runs, case):
    """(b): JAX's two-device mesh for the step cases, one process of the
    port for the dropout cases."""
    value, grads = runs["jax"][case]
    for results in runs["results"]:
        prefix = f"step/{case}/"
        np.testing.assert_allclose(float(results[prefix + "loss"]), value,
                                   rtol=1e-6)
        got = {k[len(prefix + "grad/"):]: v for k, v in results.items()
               if k.startswith(prefix + "grad/")}
        assert got.keys() == grads.keys()
        largest = max(float(np.abs(g).max()) for g in grads.values())
        for name, want in grads.items():
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=2e-5 * largest, err_msg=name)


@pytest.mark.parametrize("kind", list(ranks.MODELS))
def test_train_matches_one_process(runs, kind):
    want, steps = runs["reference"][f"train/{kind}"]
    rank0, rank1 = runs["results"]
    histories = [_history(r, f"train/{kind}/history") for r in (rank0, rank1)]
    assert histories[0] == histories[1]
    for results in (rank0, rank1):
        assert _history(results, f"deferred/{kind}/history") == histories[0]
    _assert_curves_close(histories[0], want)
    if kind == "gmvae":
        for subset in ("training", "validation"):
            assert histories[0][subset]["accuracy"] == want[subset]["accuracy"]
    # each rank's rows: its block of every row of the epoch's permutation
    n, b = 810, ranks.MINIBATCH
    perms = np.concatenate([
        tstep.epoch_permutation(n, b, np.random.RandomState(epoch))
        for epoch in range(ranks.EPOCHS[kind])])
    for r, results in enumerate((rank0, rank1)):
        assert int(results[f"train/{kind}/steps"]) == steps
        block = b // WORLD
        np.testing.assert_array_equal(results[f"train/{kind}/rows"],
                                      perms[:, r * block:(r + 1) * block])
    # rank 0 writes what one process writes; rank 1 writes nothing
    def files(directory):
        return sorted(os.path.relpath(os.path.join(where, name), directory)
                      for where, _, names in os.walk(directory)
                      for name in names)

    assert files(runs["root"] / f"trained-{kind}-rank0") == files(
        runs["single"] / f"trained-{kind}")
    assert not (runs["root"] / f"trained-{kind}-rank1").exists()


@pytest.mark.parametrize("kind", list(ranks.MODELS))
def test_evaluate_with_a_remainder_matches_one_process(runs, kind):
    want = runs["reference"][f"evaluate/{kind}"]
    for results in runs["results"]:
        for key, value in want.items():
            got = results[f"evaluate/{kind}/{key}"]
            if key.startswith("metric/"):
                np.testing.assert_allclose(got, value, rtol=1e-6, err_msg=key)
            elif key in ("reconstructed", "stddev"):
                np.testing.assert_allclose(got, value, rtol=1e-4, err_msg=key)
            else:
                np.testing.assert_array_equal(got, value, err_msg=key)


@pytest.mark.parametrize("n", [810, 809])
def test_streaming_matches_one_process(runs, n):
    for results in runs["results"]:
        _assert_curves_close(_history(results, f"stream/{n}/history"),
                             runs["reference"][f"stream/{n}"])


def test_sharded_pipeline_blocks(runs):
    batches = runs["reference"]["pipeline"]
    assert [b.shape[0] for b in batches] == [30, 30, 30, 5]
    for r, results in enumerate(runs["results"]):
        for i, want in enumerate(batches):
            offset, total = results[f"pipeline/{i}/where"].tolist()
            got = results[f"pipeline/{i}/dense"]
            if want.shape[0] % WORLD:  # the remainder: whole on each rank
                assert (offset, total) == (0, want.shape[0])
                np.testing.assert_array_equal(got, want)
            else:
                rows = total // WORLD
                assert (offset, total) == (r * rows, want.shape[0])
                np.testing.assert_array_equal(got,
                                              want[offset:offset + rows])


def test_sharded_pipeline_overflow_is_decided_for_every_rank(runs):
    """A batch in which one rank's block overflows a block's wire goes
    dense on every rank, so the ranks run the same batch signatures."""
    values = ranks.overflow_values()
    for r, results in enumerate(runs["results"]):
        capacity = int(results["overflow/capacity"])
        entries = [results[f"overflow/{i}/entries"].tolist() for i in (0, 1)]
        # rank 0's block of the first batch overflows, rank 1's does not;
        # the second batch's blocks both fit
        assert entries[0][0] > capacity >= entries[0][1]
        assert max(entries[1]) <= capacity
        assert [bool(results[f"overflow/{i}/wire"]) for i in (0, 1)] == [
            False, True]
        for i in (0, 1):
            want = values[i * 20 + r * 10:i * 20 + (r + 1) * 10].toarray()
            np.testing.assert_array_equal(results[f"overflow/{i}/dense"],
                                          want)


@pytest.mark.parametrize("kind", list(ranks.MODELS))
def test_resume_from_one_process_checkpoint(runs, kind):
    trained, _ = runs["reference"][f"train/{kind}"]
    want = runs["reference"][f"resume/{kind}"]
    epochs = ranks.EPOCHS[kind]
    for results in runs["results"]:
        got = _history(results, f"resume/{kind}/history")
        _assert_curves_close(got, want)
        # the checkpoint's epochs are the one-process run's, as it wrote them
        for subset in trained:
            for name, values in trained[subset].items():
                assert got[subset][name][:epochs] == values
                assert len(got[subset][name]) == epochs + 1
