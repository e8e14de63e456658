"""The port's model axis (the gene split, ``scvae_tpu_torch.parallel`` and
``scvae_tpu_torch.ops.sharded``) on four gloo ranks on the CPU, the
(data 2, model 2) grid, against the JAX package's four-device mesh
``create_mesh(devices=jax.devices()[:4], model_parallelism=2)`` and
against one process of the port.

The module starts the four ranks once (``tests/torch_model_parallel_ranks.py``,
joined through a file store in ``tmp_path``) and, while they run, makes
the JAX and one-process references here.  It holds:

(a) the mesh: the grid's shape and each rank's place on it; the sharded
    wrappers against JAX's ``sharded_fused_log_likelihood`` /
    ``sharded_fused_categorised_log_likelihood`` in interpret mode for
    Poisson, NB, ZINB, CP with the count sum and NB categorised with
    K = 3 on 96 genes, and NB on 97 (heads whole), b = 8, H = 16, S = 2:
    each rank's row sums within rtol 1e-5, its dh and the heads'
    gradients (summed over the data ranks, the gene blocks put together)
    within rtol 2e-4 and atol 1e-5 (JAX's bounds), and the collectives
    each case issued (two model-axis all-reduces a split base family, two
    gathers the constrained Poisson's head, none unsplit);
(b) one value and gradient of VAE-NB, VAE-Poisson-cat (K = 3), VAE-CP
    with the count sum, unfused VAE-NB and GMVAE-NB (3 clusters) on a
    32-row batch of 12 genes, JAX on its mesh, the port on the train state
    cut by ``shard_train_state``, both on JAX's weights and z draws: the
    loss within 1e-6 relative, every gradient (a cut head's the rank's
    block) within 2e-5 of the largest;
(c) ``train`` of the golden VAE-NB and GMVAE-NB, on the development
    set's first 22 of its 25 genes (so that the model axis cuts the heads,
    into blocks of 11 that a model axis of 2 would not cut again), on the
    grid against one process: the curves within rtol 1e-3 and atol 1e-2
    at every epoch (the bound of ``tests/test_multihost.py``) on every
    rank, the accuracies and steps equal; rank 0's checkpoint holds the
    leaves of one process's, whole (Adam moments included), and no other
    rank writes; the state ``train`` returns on every rank is that
    checkpoint's, leaf for leaf; that checkpoint resumed in one process, and a
    one-process checkpoint resumed on the grid, continue the curve of a
    one-process resume within the same bound.  The training runs here and
    on the ranks zero the noise-driven elements' updates, as
    ``tests/test_torch_parallel.py`` does;
(d) ``evaluate`` of rank 0's checkpoint on the grid on 99 rows (batches
    of 20, a remainder of 19) against one process: the metrics within
    1e-6 relative, the latent means, the responsibilities and the
    clusters equal, the reconstruction within 1e-4 relative (as in
    ``tests/test_torch_parallel.py``); streaming on the grid against one
    process within the bound of (c); the two ranks of a model group build
    the same CSR wire, its rows those of their data block, and the two
    data blocks differ;
(e) the command line: ``train`` and ``evaluate`` with
    ``--number-of-devices 4 --model-parallelism 2`` on the ranks, the
    curves within the bound of (c) of one process's.

Last, each rank destroys its world, joins a new one and makes the grid
again: the new mesh's model group is another, and sums over it.
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
from jax.experimental.pallas import tpu as pltpu

import torch_model_parallel_ranks as ranks
import torch_parallel_ranks as base
from scvae_tpu import ops as jops
from scvae_tpu import parallel as jparallel
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import vae as jvae
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.data.pipeline import BatchPipeline
from scvae_tpu_torch.models import step as tstep

WORLD, MODEL = ranks.WORLD, ranks.MODEL
RANKS_TIMEOUT = 600
CURVE_RTOL, CURVE_ATOL = 1e-3, 1e-2


def _mesh4():
    return jparallel.create_mesh(devices=jax.devices()[:WORLD],
                                 model_parallelism=MODEL)


def _jax_wrapper(case, mesh):
    """JAX's row sums and the gradients of Σ w·rows, by the ranks' keys."""
    name, _, k_max = ranks.WRAPPER_CASES[case]
    x = ranks.wrapper_inputs(case)
    heads = {p: {"kernel": jnp.asarray(x[f"{p}/kernel"]),
                 "bias": jnp.asarray(x[f"{p}/bias"])}
             for p in ranks.head_names(name)}
    args = [jnp.asarray(x["h"]), heads]
    if k_max:
        args += [jnp.asarray(x["cat/kernel"]), jnp.asarray(x["cat/bias"])]
    t, w = jnp.asarray(x["t"]), jnp.asarray(x["w"])
    count_sum = (jnp.asarray(x["count_sum"])
                 if name == "constrained poisson" else None)

    def loss(h, heads, *classes):
        if classes:
            rows = jops.sharded_fused_categorised_log_likelihood(
                name, h, heads, *classes, t, mesh=mesh)
        else:
            rows = jops.sharded_fused_log_likelihood(
                name, h, heads, t, mesh=mesh, count_sum=count_sum)
        return jnp.sum(rows * w), rows

    with pltpu.force_tpu_interpret_mode():
        (_, rows), grads = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    out = {"rows": rows, "d/h": grads[0]}
    out |= {f"d/{p}/{k}": grads[1][p][k] for p in heads for k in heads[p]}
    if k_max:
        out |= {"d/cat/kernel": grads[2], "d/cat/bias": grads[3]}
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_step(case, mesh):
    """JAX's inputs (weights, batch-norm state, batch, z draws) and its
    loss and gradients on the (data 2, model 2) mesh: the parameters
    placed by its ``param_shardings``, the batch by ``shard_batch``."""
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
    x = base.step_x()
    key = jax.random.PRNGKey(7)
    # the forward splits its key in three (VAE) or four (GMVAE) and draws
    # z with the third, at the global batch's shape
    if model == "gmvae":
        noise = jax.random.normal(jax.random.split(key, 4)[2], (
            1, base.STEP_CLUSTERS, base.STEP_ROWS, base.STEP_LATENT))
    else:
        noise = jax.random.normal(jax.random.split(key, 3)[2], (
            1, base.STEP_ROWS, base.STEP_LATENT))
    placed = jax.device_put(params, jparallel.param_shardings(params, mesh))
    batch = jparallel.shard_batch(
        {k: jnp.asarray(v) for k, v in ranks.step_batch(x).items()}, mesh)

    def loss(p):
        return module.loss_fn(config, p, state, batch, key,
                              warm_up_weight=1.0)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(placed)
    as_numpy = lambda tree: {  # noqa: E731
        name: leaf.numpy() for name, leaf in tparams.flatten(
            tparams.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           tree))).items()}
    inputs = {f"params/{k}": v for k, v in as_numpy(params).items()}
    inputs |= {f"state/{k}": v for k, v in as_numpy(state).items()}
    inputs |= {"x": x, "noise": np.asarray(noise)}
    return inputs, float(value), as_numpy(grads)


def _pipeline_batches(values):
    """The one-process batches that ``base.pipeline_blocks`` cuts."""
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
        yield _runs(tmp_path_factory.mktemp("model_parallel"))
    finally:
        torch.set_num_threads(threads)


def _runs(root):
    single = root / "single"
    mesh = _mesh4()
    inputs, jax_steps = {}, {}
    for case in ranks.STEP_CASES:
        case_inputs, value, grads = _jax_step(case, mesh)
        inputs |= {f"step/{case}/{k}": v for k, v in case_inputs.items()}
        jax_steps[case] = (value, grads)
    np.savez(root / "inputs.npz", **inputs)
    splits = base.development_split(ranks.GENES)
    reference = {}
    frozen = pytest.MonkeyPatch()
    frozen.setattr(tstep, "make_optimizer", base.FrozenClipAdam)
    # one process first: the checkpoints that the ranks resume, and the
    # command line's data cache, which the ranks then read
    for kind in base.MODELS:
        trained = single / f"trained-{kind}"
        reference[f"train/{kind}"] = base.train_golden(kind, trained, splits)
        for where in (root, single):
            shutil.copytree(trained, where / f"resume-{kind}")
    reference["cli"] = ranks.run_cli(root, single / "cli-models",
                                     single / "cli-analyses")
    frozen.undo()
    script = os.path.join(os.path.dirname(__file__),
                          "torch_model_parallel_ranks.py")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    processes = [subprocess.Popen(
        [sys.executable, script, str(r), str(WORLD), str(root / "store"),
         str(root / "inputs.npz"), str(root / f"rank{r}.npz")],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    frozen = pytest.MonkeyPatch()
    frozen.setattr(tstep, "make_optimizer", base.FrozenClipAdam)
    try:
        jax_wrappers = {case: _jax_wrapper(case, mesh)
                        for case in ranks.WRAPPER_CASES}
        reference["stream"] = base.train_streaming(
            "vae", single / "stream", splits[0].values[:810])
        for kind in base.MODELS:
            reference[f"resume/{kind}"] = base.resume(
                kind, single / f"resume-{kind}", splits)
        reference["pipeline"] = _pipeline_batches(splits[0].values[:95])
        codes = [p.wait(timeout=RANKS_TIMEOUT) for p in processes]
        if not any(codes):
            for kind in base.MODELS:
                # the grid's checkpoint, resumed in one process
                resumed = root / f"grid-resumed-{kind}"
                shutil.copytree(root / f"trained-{kind}-rank0", resumed)
                reference[f"grid-resumed/{kind}"] = base.resume(
                    kind, resumed, splits)
                # (d) one process evaluates what the grid trained
                reference[f"evaluate/{kind}"] = base.evaluate_golden(
                    kind, root / f"trained-{kind}-rank0",
                    splits[2].values[:99])
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
    return {"root": root, "single": single, "results": results,
            "reference": reference, "jax_steps": jax_steps,
            "jax_wrappers": jax_wrappers}


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


def _place(r):
    """(data index, model index) of rank ``r`` on the grid."""
    return divmod(r, MODEL)


def test_grid(runs):
    for r, results in enumerate(runs["results"]):
        assert results["mesh"].tolist() == [WORLD // MODEL, MODEL,
                                            *_place(r)]


@pytest.mark.parametrize("case", list(ranks.WRAPPER_CASES))
def test_wrappers_match_jax(runs, case):
    """(a): each rank's rows and dh, and the heads' gradients summed over
    the data ranks and put together over the gene blocks."""
    want = runs["jax_wrappers"][case]
    name, f, _ = ranks.WRAPPER_CASES[case]
    rows = ranks.WRAPPER_ROWS // (WORLD // MODEL)
    prefix = f"wrapper/{case}/"
    results = runs["results"]
    for r, got in enumerate(results):
        mine = slice(_place(r)[0] * rows, (_place(r)[0] + 1) * rows)
        np.testing.assert_allclose(got[prefix + "rows"],
                                   want["rows"][:, mine], rtol=1e-5)
        np.testing.assert_allclose(got[prefix + "d/h"],
                                   want["d/h"][:, mine], rtol=2e-4,
                                   atol=1e-5)
    split = f % MODEL == 0
    for key in want:
        if key in ("rows", "d/h"):
            continue
        blocks = [sum(results[d * MODEL + j][prefix + key]
                      for d in range(WORLD // MODEL))
                  for j in range(MODEL)]
        got = np.concatenate(blocks, -1) if split else blocks[0]
        if not split:
            np.testing.assert_array_equal(blocks[1], blocks[0])
        np.testing.assert_allclose(got, want[key], rtol=2e-4, atol=1e-5,
                                   err_msg=key)
    # the collectives: all_gather, all_reduce, all_reduce_sum
    issued = {"constrained poisson": [2, 0, 0]}.get(name, [0, 0, 2])
    for got in results:
        assert got[prefix + "collectives"].tolist() == (
            issued if split else [0, 0, 0])


@pytest.mark.parametrize("case", list(ranks.STEP_CASES))
def test_one_step_matches_jax(runs, case):
    """(b): the loss on every rank, and every gradient: a cut head's on
    each rank its gene block of JAX's."""
    value, grads = runs["jax_steps"][case]
    largest = max(float(np.abs(g).max()) for g in grads.values())
    prefix = f"step/{case}/"
    cut = set()
    for r, results in enumerate(runs["results"]):
        np.testing.assert_allclose(float(results[prefix + "loss"]), value,
                                   rtol=1e-6)
        got = {k[len(prefix + "grad/"):]: v for k, v in results.items()
               if k.startswith(prefix + "grad/")}
        assert got.keys() == grads.keys()
        for name, want in grads.items():
            if got[name].shape != want.shape:
                cut.add(name)
                width = want.shape[-1] // MODEL
                j = _place(r)[1]
                want = want[..., j * width:(j + 1) * width]
            np.testing.assert_allclose(got[name], want, rtol=0,
                                       atol=2e-5 * largest, err_msg=name)
    # every reconstruction and class head leaf is cut, nothing else
    assert cut == {name for name in grads
                   if "reconstruction" in name or "categorised" in name}


@pytest.mark.parametrize("kind", list(base.MODELS))
def test_train_matches_one_process(runs, kind):
    want, steps = runs["reference"][f"train/{kind}"]
    histories = [_history(r, f"train/{kind}/history")
                 for r in runs["results"]]
    for history, results in zip(histories, runs["results"]):
        assert history == histories[0]
        assert int(results[f"train/{kind}/steps"]) == steps
    _assert_curves_close(histories[0], want)
    if kind == "gmvae":
        for subset in ("training", "validation"):
            assert histories[0][subset]["accuracy"] == want[subset]["accuracy"]


@pytest.mark.parametrize("kind", list(base.MODELS))
def test_checkpoint_is_whole(runs, kind):
    """Rank 0 writes the leaves of one process's checkpoint, whole, in each
    version of the run; no other rank writes."""
    root, single = runs["root"], runs["single"]

    def layouts(directory):
        return {os.path.relpath(where, directory): ranks.checkpoint_layout(
                    where)
                for where, _, names in os.walk(directory)
                if "checkpoint.npz" in names}

    got = layouts(root / f"trained-{kind}-rank0")
    assert got and got == layouts(single / f"trained-{kind}")
    for r in range(1, WORLD):
        assert not (root / f"trained-{kind}-rank{r}").exists()


@pytest.mark.parametrize("kind", list(base.MODELS))
def test_returned_state_is_whole(runs, kind):
    """The state that ``train`` returns on every rank is whole: rank 0's
    last checkpoint, leaf for leaf, in one process's layout."""
    root, single = runs["root"], runs["single"]

    def last(directory):  # the run's checkpoint, not best/'s
        return next(where for where, _, names in os.walk(directory)
                    if "checkpoint.npz" in names
                    and os.path.basename(where) not in ("best",
                                                        "early_stopping"))

    with np.load(os.path.join(last(root / f"trained-{kind}-rank0"),
                              "checkpoint.npz")) as data:
        want = dict(data)
    assert ranks.checkpoint_layout(last(single / f"trained-{kind}")) == {
        name: value.shape for name, value in want.items()}
    prefix = f"train/{kind}/state/"
    for results in runs["results"]:
        got = {k[len(prefix):]: v for k, v in results.items()
               if k.startswith(prefix)}
        assert got.keys() == want.keys()
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("kind", list(base.MODELS))
def test_resume_both_ways(runs, kind):
    """The grid's checkpoint resumed in one process, and one process's
    resumed on the grid, against one process's resumed in one process."""
    trained, _ = runs["reference"][f"train/{kind}"]
    want = runs["reference"][f"resume/{kind}"]
    epochs = base.EPOCHS[kind]
    _assert_curves_close(runs["reference"][f"grid-resumed/{kind}"], want)
    for results in runs["results"]:
        got = _history(results, f"resume/{kind}/history")
        _assert_curves_close(got, want)
        for subset in trained:
            for name, values in trained[subset].items():
                assert got[subset][name][:epochs] == values
                assert len(got[subset][name]) == epochs + 1


@pytest.mark.parametrize("kind", list(base.MODELS))
def test_evaluate_matches_one_process(runs, kind):
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


def test_streaming_matches_one_process(runs):
    for results in runs["results"]:
        _assert_curves_close(_history(results, "stream/history"),
                             runs["reference"]["stream"])


def test_model_group_builds_one_wire(runs):
    """The two ranks of a model group build the same blocks (their data
    index's rows of each batch), the two data indices' blocks differ; a
    remainder that the data axis does not divide is whole on every rank."""
    batches = runs["reference"]["pipeline"]
    results = runs["results"]
    data = WORLD // MODEL
    for r, got in enumerate(results):
        d = _place(r)[0]
        for i, want in enumerate(batches):
            offset, total = got[f"pipeline/{i}/where"].tolist()
            dense = got[f"pipeline/{i}/dense"]
            np.testing.assert_array_equal(
                dense, results[d * MODEL][f"pipeline/{i}/dense"])
            if want.shape[0] % data:
                assert (offset, total) == (0, want.shape[0])
                np.testing.assert_array_equal(dense, want)
            else:
                rows = total // data
                assert (offset, total) == (d * rows, want.shape[0])
                np.testing.assert_array_equal(dense,
                                              want[offset:offset + rows])
    assert not np.array_equal(results[0]["pipeline/0/dense"],
                              results[MODEL]["pipeline/0/dense"])


def test_command_line_on_the_grid(runs):
    for results in runs["results"]:
        _assert_curves_close(_history(results, "cli/history"),
                             runs["reference"]["cli"])


def test_world_made_again(runs):
    """A world destroyed and made again in a process gets groups of its
    own: each rank's model group is a new one, and sums its two ranks."""
    for r, results in enumerate(runs["results"]):
        d = _place(r)[0]
        assert results["again"].tolist() == [
            1.0, float(sum(range(d * MODEL, (d + 1) * MODEL)))]
