"""The runs of ``tests/test_torch_model_parallel.py``: each function runs one
scenario of the port on a (data, model) mesh of gloo processes (or, with
``devices=None``, in one process) and returns what the test compares.
Run as a script, it is one rank of a world of four gloo processes on the
(data 2, model 2) grid:

    python tests/torch_model_parallel_ranks.py RANK WORLD STORE INPUTS OUTPUT

joins the group through the file ``STORE``, runs every scenario on the
mesh with the inputs the test wrote to ``INPUTS`` (``.npz``) and writes
its results to ``OUTPUT`` (``.npz``; histories as JSON strings).  It
imports no JAX."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_parallel_ranks as base  # noqa: E402
from scvae_tpu_torch import cli, ops  # noqa: E402
from scvae_tpu_torch import params as tparams  # noqa: E402
from scvae_tpu_torch.models import gmvae as tgmvae  # noqa: E402
from scvae_tpu_torch.models import step as tstep  # noqa: E402
from scvae_tpu_torch.models import vae as tvae  # noqa: E402
from scvae_tpu_torch.ops.fused_likelihood import FAMILIES  # noqa: E402
from scvae_tpu_torch.parallel import mesh as parallel  # noqa: E402

CPU = base.CPU
WORLD, MODEL = 4, 2
# the golden configurations on the development set's first 22 of its 25
# genes: a model axis of 2 cuts 22 (25 would leave the heads whole) into
# blocks of 11, whose width a model axis of 2 does not divide: a block's
# width does not tell whether it was cut
GENES = 22
# the wrappers against JAX's sharded wrappers: (likelihood, genes, classes)
# on 8 rows, decoder width 16, 2 samples; 97 genes are not cut
WRAPPER_CASES = {
    "poisson": ("poisson", 96, 0),
    "nb": ("negative binomial", 96, 0),
    "zinb": ("zero-inflated negative binomial", 96, 0),
    "cp": ("constrained poisson", 96, 0),
    "nb-cat": ("negative binomial", 96, 3),
    "nb-97": ("negative binomial", 97, 0),
}
WRAPPER_ROWS, WRAPPER_HIDDEN, WRAPPER_SAMPLES = 8, 16, 2
# one step against JAX's (data 2, model 2) mesh: (model, likelihood,
# classes, other configuration arguments) on PR 22's 32-row batch
STEP_CASES = {
    "vae-nb": ("vae", "negative binomial", 0, {}),
    "vae-poisson-cat": ("vae", "poisson", 3, {}),
    "vae-cp": ("vae", "constrained poisson", 0, {}),
    "vae-nb-unfused": ("vae", "negative binomial", 0,
                       {"fused_likelihood": False}),
    "gmvae-nb": ("gmvae", "negative binomial", 0, {}),
}
# the command line: the development set, 400 rows, its 22 most variable
# genes; evaluate's analyses, the metrics alone
CLI_MODEL = ["-m", "VAE", "-r", "poisson", "-l", "2", "-H", "16", "-B", "64"]


def head_names(name):
    return ("lambda",) if name == "constrained poisson" else (
        FAMILIES[name].heads)


def wrapper_inputs(case):
    """The numpy inputs of a wrapper case, from ``RandomState(11)``: h (S,
    B, H), t (B, F), the heads' kernels and biases, the class heads (K+1,
    H, F) and (K+1, F), the row sums' cotangent w (S, B) and the count sum
    (B, 1)."""
    name, f, k_max = WRAPPER_CASES[case]
    rng = np.random.RandomState(11)
    s, b, hidden = WRAPPER_SAMPLES, WRAPPER_ROWS, WRAPPER_HIDDEN
    x = {"h": rng.normal(size=(s, b, hidden)).astype(np.float32),
         "t": rng.poisson(2.0, size=(b, f)).astype(np.float32)}
    for p in head_names(name):
        x[f"{p}/kernel"] = rng.normal(scale=0.1, size=(hidden, f)).astype(
            np.float32)
        x[f"{p}/bias"] = rng.normal(scale=0.1, size=(f,)).astype(np.float32)
    if k_max:
        x["cat/kernel"] = rng.normal(scale=0.1, size=(k_max + 1, hidden, f)
                                     ).astype(np.float32)
        x["cat/bias"] = rng.normal(scale=0.1, size=(k_max + 1, f)).astype(
            np.float32)
    x["w"] = rng.normal(size=(s, b)).astype(np.float32)
    x["count_sum"] = x["t"].sum(1, keepdims=True) + 1.0
    return x


def wrapper_case(case, mesh):
    """The rank's row sums (S, B/2) of its rows, and the gradients of
    Σ w·rows for its rows: dh of its rows, and each head's (its gene block
    where the split cuts the genes)."""
    name, f, k_max = WRAPPER_CASES[case]
    x = wrapper_inputs(case)
    rows = WRAPPER_ROWS // mesh.shape["data"]
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    genes = mesh.genes

    def held(key):
        value = torch.from_numpy(x[key])
        if genes.splits(f):
            value = genes.block(value).clone()
        return value.requires_grad_(True)

    leaves = {"h": torch.from_numpy(x["h"][:, mine]).requires_grad_(True)}
    leaves |= {key: held(key) for key in x
               if key.endswith(("/kernel", "/bias"))}
    heads = {p: {"kernel": leaves[f"{p}/kernel"], "bias": leaves[f"{p}/bias"]}
             for p in head_names(name)}
    t = torch.from_numpy(x["t"][mine])
    if k_max:
        out = ops.sharded_fused_categorised_log_likelihood(
            name, leaves["h"], heads, leaves["cat/kernel"],
            leaves["cat/bias"], t, genes=genes)
    else:
        out = ops.sharded_fused_log_likelihood(
            name, leaves["h"], heads, t, genes=genes,
            count_sum=torch.from_numpy(x["count_sum"][mine]))
    loss = torch.sum(out * torch.from_numpy(x["w"][:, mine]))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    result = {"rows": out.detach().numpy()}
    result |= {f"d/{key}": g.numpy() for key, g in zip(leaves, grads)}
    return result


def step_config(case):
    """(model, configuration keyword arguments) of a step case."""
    model, name, k_max, options = STEP_CASES[case]
    kwargs = dict(feature_size=base.STEP_FEATURES,
                  latent_size=base.STEP_LATENT,
                  hidden_sizes=base.STEP_HIDDEN,
                  reconstruction_distribution=name,
                  number_of_reconstruction_classes=k_max,
                  minibatch_normalisation=True, **options)
    if model == "gmvae":
        kwargs["number_of_latent_clusters"] = base.STEP_CLUSTERS
    return model, kwargs


def step_batch(x):
    """The global batch of a step case: x, t and the count sum."""
    return {"x": x, "t": x, "count_sum": x.sum(1, keepdims=True)}


def step_value_and_grad(case, params, state, x, noise, mesh):
    """The port's loss and gradients (by JAX's leaf names) of a step case on
    JAX's weights and z draws: the train state cut to the rank's gene
    blocks (``shard_train_state``), the rank's rows of the batch, then the
    gradients and the loss averaged over the data group, as the step
    averages them.  A cut leaf's gradient is the rank's block."""
    model, kwargs = step_config(case)
    module = tgmvae if model == "gmvae" else tvae
    config = (tgmvae.GMVAEConfig if model == "gmvae"
              else tvae.VAEConfig)(**kwargs)
    state = tparams.params_from_jax(state)
    whole = tstep.create_train_state(tparams.params_from_jax(params), state,
                                     tstep.make_optimizer(1e-3))
    params = parallel.shard_train_state(whole, mesh).params
    named = tparams.flatten(params)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    batch = parallel.shard_batch(
        {k: torch.from_numpy(v) for k, v in step_batch(x).items()}, mesh)
    loss, _ = module.loss_fn(
        config, params, state, batch, torch.Generator().manual_seed(3),
        warm_up_weight=1.0, noise=torch.from_numpy(noise), shard=batch.shard,
        genes=mesh.genes)
    grads = list(torch.autograd.grad(loss, leaves))
    *grads, loss = batch.shard.average(grads + [loss.detach()])
    return float(loss), {name: g.numpy() for name, g in zip(named, grads)}


def state_leaves(train_state):
    """{checkpoint leaf name: array} of a train state."""
    return tparams.train_state_to_jax(train_state.params,
                                      train_state.model_state,
                                      train_state.opt_state, train_state.step)


def checkpoint_layout(directory):
    """{leaf name: shape} of a run's ``checkpoint.npz``."""
    with np.load(os.path.join(directory, "checkpoint.npz")) as data:
        return {name: data[name].shape for name in data.files}


def cli_data(root):
    return ["development", "-D", str(root / "data") if hasattr(
        root, "joinpath") else os.path.join(root, "data"), "-E", "random",
        "400", "-F", "keep_highest_variances", str(GENES),
        "--split-data-set"]


def run_cli(root, models, analyses, devices=None, model_parallelism=None):
    """``train`` then ``evaluate`` through the command line into
    ``models`` (the metrics analysis into ``analyses``); the learning
    curves of the run."""
    from scvae_tpu_torch.models.checkpoints import load_learning_curves

    mesh = []
    if devices is not None:
        mesh = ["--number-of-devices", str(devices), "--model-parallelism",
                str(model_parallelism)]
    model = [*CLI_MODEL, "-M", str(models), *mesh]
    for command, more in (("train", ["-e", "2"]),
                          ("evaluate", ["-A", str(analyses),
                                        "--included-analyses", "metrics"])):
        code = cli.main([command, *cli_data(root), *model, *more],
                        device=CPU)
        if code:
            raise RuntimeError(f"{command} exited with {code}")
    run = next(os.path.join(where, "")
               for where, _, names in os.walk(models)
               if "learning_curves.json" in names
               and os.path.basename(where) not in ("best", "early_stopping"))
    return load_learning_curves(run)


def main(rank, world, store, inputs, output):
    tstep.make_optimizer = base.FrozenClipAdam
    parallel.distributed_initialize(
        device=CPU, init_method=f"file://{store}", world_size=world,
        rank=rank)
    given = dict(np.load(inputs, allow_pickle=False))
    results = {}
    mesh = parallel.create_mesh(model_parallelism=MODEL, device=CPU)
    results["mesh"] = np.array([mesh.shape["data"], mesh.shape["model"],
                                mesh.data_index, mesh.model_index])

    # (a) the wrappers; (b) one step against JAX's
    for case in WRAPPER_CASES:
        before = parallel.collective_counts()
        for key, value in wrapper_case(case, mesh).items():
            results[f"wrapper/{case}/{key}"] = value
        after = parallel.collective_counts()
        results[f"wrapper/{case}/collectives"] = np.array(
            [after[k] - before[k] for k in sorted(after)])
    for case in STEP_CASES:
        prefix = f"step/{case}/"
        taken = lambda part: {  # noqa: E731
            k[len(prefix + part):]: v for k, v in given.items()
            if k.startswith(prefix + part)}
        loss, grads = step_value_and_grad(
            case, taken("params/"), taken("state/"), given[prefix + "x"],
            given[prefix + "noise"], mesh)
        results[prefix + "loss"] = np.array(loss)
        for name, g in grads.items():
            results[prefix + "grad/" + name] = g

    root = os.path.dirname(output)
    splits = base.development_split(GENES)
    # (c) train on the grid; rank 0 writes the run, the others nothing
    for kind in base.MODELS:
        own = os.path.join(root, f"trained-{kind}-rank{rank}")
        trained = base.train_result(kind, own, splits, devices=world,
                                    model_parallelism=MODEL)
        results[f"train/{kind}/history"] = np.array(
            json.dumps(trained.history))
        results[f"train/{kind}/steps"] = np.array(trained.train_state.step)
        for name, leaf in state_leaves(trained.train_state).items():
            results[f"train/{kind}/state/{name}"] = leaf
        # (d) evaluate rank 0's checkpoint
        shared = os.path.join(root, f"trained-{kind}-rank0")
        for key, value in base.evaluate_golden(
                kind, shared, splits[2].values[:99], devices=world,
                model_parallelism=MODEL).items():
            results[f"evaluate/{kind}/{key}"] = np.asarray(value)
        # a one-process checkpoint resumed on the grid
        history = base.resume(kind, os.path.join(root, f"resume-{kind}"),
                              splits, devices=world, model_parallelism=MODEL)
        results[f"resume/{kind}/history"] = np.array(json.dumps(history))
    history = base.train_streaming("vae", os.path.join(root, "stream"),
                                   splits[0].values[:810], devices=world,
                                   model_parallelism=MODEL)
    results["stream/history"] = np.array(json.dumps(history))
    for i, (offset, total, dense) in enumerate(
            base.pipeline_blocks(splits[0].values[:95], mesh)):
        results[f"pipeline/{i}/where"] = np.array([offset, total])
        results[f"pipeline/{i}/dense"] = dense
    # (e) the command line
    history = run_cli(root, os.path.join(root, "cli-models"),
                      os.path.join(root, f"cli-analyses-rank{rank}"), world,
                      MODEL)
    results["cli/history"] = np.array(json.dumps(history))
    torch.distributed.destroy_process_group()
    # a world made again in this process makes and uses groups of its own
    parallel.distributed_initialize(
        device=CPU, init_method=f"file://{store}-again", world_size=world,
        rank=rank)
    again = parallel.create_mesh(model_parallelism=MODEL, device=CPU)
    total = again.genes.sum(torch.tensor([float(rank)]))
    results["again"] = np.array([again.model_group is not mesh.model_group,
                                 float(total)])
    np.savez(output, **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    main(rank, world, sys.argv[3], sys.argv[4], sys.argv[5])
