"""The runs of ``tests/test_torch_parallel.py``: each function runs one
scenario of the port, on a mesh of ``devices`` processes (gloo, on the CPU)
or, with ``devices=None``, in one process, and returns what the test
compares.  Run as a script, it is one rank of a world of gloo processes:

    python tests/torch_parallel_ranks.py RANK WORLD STORE INPUTS OUTPUT

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

from scvae_tpu_torch import (  # noqa: E402
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams  # noqa: E402
from scvae_tpu_torch.data import create_development_data_set  # noqa: E402
from scvae_tpu_torch.data import processing  # noqa: E402
from scvae_tpu_torch.data.parsing import DATA_SET_CATALOGUE  # noqa: E402
from scvae_tpu_torch.data.pipeline import BatchPipeline, CSRWire  # noqa: E402
from scvae_tpu_torch.data.sparse import SparseRowMatrix  # noqa: E402
from scvae_tpu_torch.models import gmvae as tgmvae  # noqa: E402
from scvae_tpu_torch.models import step as tstep  # noqa: E402
from scvae_tpu_torch.models import vae as tvae  # noqa: E402
from scvae_tpu_torch.parallel import mesh as parallel  # noqa: E402

CPU = "cpu"
# the golden configurations of tests/test_golden.py
COMMON = dict(feature_size=25, latent_size=2, hidden_sizes=[32],
              reconstruction_distribution="negative binomial")
MODELS = {
    "vae": (VariationalAutoencoder, dict(number_of_warm_up_epochs=5)),
    "gmvae": (GaussianMixtureVariationalAutoencoder,
              dict(number_of_latent_clusters=3)),
}
EPOCHS = {"vae": 3, "gmvae": 2}
MINIBATCH = 100
# step-level parity with JAX: (model, likelihood) on a 32-row batch
STEP_CASES = {"vae-poisson": ("vae", "poisson"),
              "vae-nb": ("vae", "negative binomial"),
              "gmvae-nb": ("gmvae", "negative binomial")}
STEP_ROWS, STEP_FEATURES, STEP_LATENT, STEP_HIDDEN = 32, 12, 3, (10, 8)
STEP_CLUSTERS = 3
# a step with dropout (keep h, x, z) on the port's own weights and draws
DROPOUT_CASES = {"vae-nb-dropout": ("vae", "negative binomial"),
                 "gmvae-nb-dropout": ("gmvae", "negative binomial")}
KEEP = (0.8, 0.9, 0.85)


def development_split(features=None):
    """The development set, 1,000 rows kept at random and split 0.9 at
    random, built in memory as ``DataSet("development", example_filter=
    ["random", 1000]).split(method="random", fraction=0.9)`` builds it;
    with ``features``, its first ``features`` genes alone."""
    import scipy.sparse

    raw = create_development_data_set()
    values, names, labels, _ = processing.filter_examples(
        {"original": raw["values"]}, raw["example names"], "random", [1000],
        labels=raw["labels"])
    genes = slice(features)
    data_set = DataSet(
        "development", specifications=DATA_SET_CATALOGUE["development"],
        values=SparseRowMatrix(scipy.sparse.csr_matrix(
            values["original"][:, genes])),
        labels=labels, example_names=names,
        feature_names=raw["feature names"][genes],
        example_filter=["random", 1000])
    return data_set.split(method="random", fraction=0.9)


def step_config(case):
    """(model, configuration keyword arguments) of a step case."""
    model, name = {**STEP_CASES, **DROPOUT_CASES}[case]
    common = dict(feature_size=STEP_FEATURES, latent_size=STEP_LATENT,
                  hidden_sizes=STEP_HIDDEN, reconstruction_distribution=name,
                  minibatch_normalisation=True)
    if case in DROPOUT_CASES:
        common["dropout_keep_probabilities"] = KEEP
    if model == "gmvae":
        return model, common | dict(number_of_latent_clusters=STEP_CLUSTERS)
    return model, common


def step_x():
    return np.random.RandomState(0).poisson(
        2.0, (STEP_ROWS, STEP_FEATURES)).astype(np.float32)


def value_and_grad(case, params=None, state=None, x=None, noise=None,
                   mesh=None):
    """The port's loss and its gradients (by the JAX package's leaf names)
    of a step case: on JAX's weights and JAX's z draws (``noise``, the
    global batch's) when given, else on the port's weights from seed 0
    and draws from a generator seeded 3; on a ``mesh`` on the rank's
    block of ``x`` (``shard_batch``), then the gradients and the loss
    averaged over the ranks, as the training step averages them."""
    model, kwargs = step_config(case)
    module = tgmvae if model == "gmvae" else tvae
    config = (tgmvae.GMVAEConfig if model == "gmvae"
              else tvae.VAEConfig)(**kwargs)
    if params is None:
        params, state = module.init(config, torch.Generator().manual_seed(0))
        x = step_x()
    else:
        params = tparams.params_from_jax(params)
        state = tparams.params_from_jax(state)
    named = tparams.flatten(params)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    x = torch.from_numpy(x)
    batch, shard = {"x": x, "t": x}, None
    if mesh is not None:
        batch = parallel.shard_batch(batch, mesh)
        shard = batch.shard
    loss, _ = module.loss_fn(
        config, params, state, batch, torch.Generator().manual_seed(3),
        warm_up_weight=1.0,
        noise=None if noise is None else torch.from_numpy(noise),
        shard=shard)
    grads = list(torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    if shard is not None:
        *grads, loss = parallel.average(grads + [loss])
    return float(loss), {name: g.numpy() for name, g in zip(named, grads)}


def noise_driven(key: str, shape) -> np.ndarray:
    """The elements of a golden configuration's parameter leaf whose
    gradient is zero in exact arithmetic (``tests/test_torch_golden.py``
    ``_noise_driven``): the biases before batch norm, the VAE's posterior
    mean bias (while the KL weight is 0), the GMVAE's one-hot-y rows of
    q(z|x, y)'s first kernel."""
    mask = np.zeros(shape, bool)
    if (("['layers']" in key and key.endswith("['bias']"))
            or key == "['posterior']['mu']['bias']"):
        mask[...] = True
    elif key == "['q_z']['encoder']['layers'][0]['kernel']":
        clusters = MODELS["gmvae"][1]["number_of_latent_clusters"]
        mask[shape[0] - clusters:] = True
    return mask


class FrozenClipAdam(tstep.ClipAdam):
    """Clip and Adam with the noise-driven elements' updates zeroed: Adam
    takes full-size steps on their rounding noise, which the order of a
    sum decides, so two runs that sum in other orders part there."""

    def update_(self, params, grads, opt_state):
        masks = {id(leaf): torch.from_numpy(noise_driven(key,
                                                         tuple(leaf.shape)))
                 for key, leaf in tparams.flatten(params).items()}
        grads = [grad.masked_fill(masks[id(leaf)], 0.0)
                 for leaf, grad in zip(tstep.tree_leaves(params), grads)]
        super().update_(params, grads, opt_state)


def model(kind, log_directory, features=COMMON["feature_size"]):
    model_class, kwargs = MODELS[kind]
    return model_class(**{**COMMON, "feature_size": features}, **kwargs,
                       log_directory=str(log_directory))


def record_training_rows(rows):
    """Patch ``step.gather_batch`` to append the row indices of each
    training step (the epochs' gathers pass ``dtype_overrides``) to
    ``rows``."""
    original = tstep.gather_batch

    def gather_batch(data, idx, dtype_overrides=None, **kwargs):
        rows.append(idx.tolist())
        return original(data, idx, dtype_overrides, **kwargs)

    def patched(data, idx, *args, **kwargs):
        if args or "dtype_overrides" in kwargs:
            return gather_batch(data, idx, *args, **kwargs)
        return original(data, idx, *args, **kwargs)

    tstep.gather_batch = patched


def train_result(kind, log_directory, splits, devices=None,
                 metrics_fetch="sync", model_parallelism=None):
    """The result of ``train`` of the golden configuration for
    ``EPOCHS[kind]`` epochs on the development split (as wide as its
    genes)."""
    training_set, validation_set, _ = splits
    return model(kind, log_directory, training_set.number_of_features).train(
        training_set, validation_set, number_of_epochs=EPOCHS[kind],
        minibatch_size=MINIBATCH, learning_rate=1e-3, seed=0, verbose=False,
        metrics_fetch=metrics_fetch, number_of_devices=devices,
        model_parallelism=model_parallelism, device=CPU)


def train_golden(kind, log_directory, splits, devices=None,
                 metrics_fetch="sync", model_parallelism=None):
    """(history, steps) of :func:`train_result`."""
    result = train_result(kind, log_directory, splits, devices,
                          metrics_fetch, model_parallelism)
    return result.history, result.train_state.step


def evaluate_golden(kind, log_directory, values, devices=None,
                    model_parallelism=None):
    """The metrics and per-row outputs of ``evaluate`` on ``values`` with a
    minibatch of 20."""
    evaluated = model(kind, log_directory, values.shape[1])
    transformed, reconstructed, latent = evaluated.evaluate(
        values, minibatch_size=20, seed=3, verbose=False,
        number_of_devices=devices, model_parallelism=model_parallelism,
        device=CPU)
    metrics = evaluated._last_evaluation_metrics
    out = {f"metric/{name}": np.array(metrics[name]) for name in metrics}
    out |= {"reconstructed": reconstructed.values,
           "stddev": reconstructed.total_standard_deviations.toarray()}
    if kind == "gmvae":
        out |= {"z": latent["z"].values, "y": latent["y"].values,
                "clusters": transformed.predicted_cluster_ids}
    else:
        out["z"] = latent.values
    return out


def train_streaming(kind, log_directory, values, devices=None,
                    model_parallelism=None):
    """The history of ``kind`` streamed for two epochs on ``values``."""
    result = model(kind, log_directory, values.shape[1]).train(
        values, values[:90], number_of_epochs=2, minibatch_size=MINIBATCH,
        learning_rate=1e-3, seed=1, verbose=False,
        data_placement="streaming", number_of_devices=devices,
        model_parallelism=model_parallelism, device=CPU)
    return result.history


def resume(kind, log_directory, splits, devices=None,
           model_parallelism=None):
    """The history of a run resumed from its checkpoint to ``EPOCHS[kind]
    + 1`` epochs."""
    training_set, validation_set, _ = splits
    result = model(kind, log_directory,
                   training_set.number_of_features).train(
        training_set, validation_set, number_of_epochs=EPOCHS[kind] + 1,
        minibatch_size=MINIBATCH, learning_rate=1e-3, seed=0, verbose=False,
        number_of_devices=devices, model_parallelism=model_parallelism,
        device=CPU)
    return result.history


def pipeline_blocks(values, mesh):
    """Each batch of a sharded pipeline over ``values`` (CSR wire, B = 30),
    densified: (offset, total, dense rows) of a rank's block, (0, rows,
    dense rows) of a whole batch."""
    out = []
    pipeline = BatchPipeline({"x": values, "t": values}, 30, shuffle=True,
                             seed=5, sharding=parallel.batch_sharding(mesh),
                             count_dtype=np.int16, wire_format="csr",
                             device=CPU)
    for batch in pipeline.epoch():
        shard = getattr(batch, "shard", None)
        dense = tstep.materialize_batch(batch)["x"].numpy()
        if shard is None:
            out.append((0, dense.shape[0], dense))
        else:
            out.append((shard.offset, shard.total, dense))
    return out


def overflow_values():
    """40 rows of 1,000 counts: rows 0-9 full, the rest one entry each.  In
    unshuffled batches of 20 on two ranks, rank 0's block of the first
    batch (10,000 entries) overflows a block's wire and rank 1's (10)
    does not."""
    import scipy.sparse

    dense = np.zeros((40, 1000), np.float32)
    dense[:10] = 1 + np.arange(1000) % 5
    dense[np.arange(10, 40), np.arange(10, 40)] = 2
    return scipy.sparse.csr_matrix(dense)


def pipeline_overflow(mesh):
    """(the block capacity, and for each batch of a sharded pipeline over
    ``overflow_values`` whether its field ``x`` came as a wire, each
    block's stored entries and its densified rows)."""
    values = overflow_values()
    pipeline = BatchPipeline({"x": values, "t": values}, 20, shuffle=False,
                             sharding=parallel.batch_sharding(mesh),
                             count_dtype=np.int16, wire_format="csr",
                             device=CPU)
    out = []
    for number, batch in enumerate(pipeline.epoch()):
        rows = np.arange(number * 20, (number + 1) * 20)
        entries = np.diff(values.indptr)[rows].reshape(2, -1).sum(1)
        out.append((isinstance(batch["x"], CSRWire), entries,
                    tstep.materialize_batch(batch)["x"].numpy()))
    return pipeline._block_capacity["x"], out


def main(rank, world, store, inputs, output):
    tstep.make_optimizer = FrozenClipAdam
    parallel.distributed_initialize(
        device=CPU, init_method=f"file://{store}", world_size=world,
        rank=rank)
    given = dict(np.load(inputs, allow_pickle=False))
    results = {}
    mesh = parallel.create_mesh(device=CPU)
    results["mesh_shape"] = np.array([mesh.shape["data"],
                                      mesh.shape["model"]])
    genes = parallel.create_mesh(model_parallelism=2, device=CPU)
    results["gene_mesh_shape"] = np.array([genes.shape["data"],
                                           genes.shape["model"]])
    errors = []
    try:
        parallel.create_mesh(model_parallelism=3, device=CPU)
    except ValueError as exc:
        errors.append(f"3:{type(exc).__name__}:{exc}")
    results["mesh_errors"] = np.array(errors)
    placements = parallel.param_shardings({"a": [torch.zeros(2)],
                                           "b": torch.zeros(3)}, mesh)
    results["replicated"] = np.array(
        [not p.rows for p in (placements["a"][0], placements["b"])])
    state = tstep.create_train_state({"w": torch.ones(3)}, {},
                                     tstep.make_optimizer(1e-3))
    placed = parallel.shard_train_state(state, mesh)
    results["train_state_placed"] = np.array(
        [leaf.device == mesh.device and bool(torch.equal(leaf, want))
         for leaf, want in zip(tstep.tree_leaves(placed.params)
                               + tstep.tree_leaves(placed.opt_state),
                               tstep.tree_leaves(state.params)
                               + tstep.tree_leaves(state.opt_state))])

    # (b) one value and gradient against JAX's; with dropout against one
    # process of the port
    for case in {**STEP_CASES, **DROPOUT_CASES}:
        prefix = f"step/{case}/"
        inputs = {}
        if case in STEP_CASES:
            inputs = dict(
                params={k[len(prefix + "params/"):]: v
                        for k, v in given.items()
                        if k.startswith(prefix + "params/")},
                state={k[len(prefix + "state/"):]: v
                       for k, v in given.items()
                       if k.startswith(prefix + "state/")},
                x=given[prefix + "x"], noise=given[prefix + "noise"])
        loss, grads = value_and_grad(case, mesh=mesh, **inputs)
        results[prefix + "loss"] = np.array(loss)
        for name, g in grads.items():
            results[prefix + "grad/" + name] = g

    splits = development_split()
    root = os.path.dirname(output)
    # (c) train; rank 1 in a directory of its own, which must stay empty
    rows = []
    record_training_rows(rows)
    for kind in MODELS:
        own = os.path.join(root, f"trained-{kind}-rank{rank}")
        start = len(rows)
        history, steps = train_golden(kind, own, splits, devices=world)
        results[f"train/{kind}/history"] = np.array(json.dumps(history))
        results[f"train/{kind}/rows"] = np.array(rows[start:])
        results[f"train/{kind}/steps"] = np.array(steps)
        deferred, _ = train_golden(
            kind, os.path.join(root, f"deferred-{kind}"), splits,
            devices=world, metrics_fetch="deferred")
        results[f"deferred/{kind}/history"] = np.array(json.dumps(deferred))
        # (d) evaluate rank 0's checkpoint, with a remainder of 19 rows
        shared = os.path.join(root, f"trained-{kind}-rank0")
        test_values = splits[2].values[:99]
        for key, value in evaluate_golden(kind, shared, test_values,
                                          devices=world).items():
            results[f"evaluate/{kind}/{key}"] = np.asarray(value)
    # (e) streaming: 810 rows (a remainder of 10, sharded) and 809 (9, whole)
    for n in (810, 809):
        values = splits[0].values[:n]
        history = train_streaming("vae", os.path.join(root, f"stream-{n}"),
                                  values, devices=world)
        results[f"stream/{n}/history"] = np.array(json.dumps(history))
    for i, (offset, total, dense) in enumerate(
            pipeline_blocks(splits[0].values[:95], mesh)):
        results[f"pipeline/{i}/where"] = np.array([offset, total])
        results[f"pipeline/{i}/dense"] = dense
    capacity, batches = pipeline_overflow(mesh)
    results["overflow/capacity"] = np.array(capacity)
    for i, (wire, entries, dense) in enumerate(batches):
        results[f"overflow/{i}/wire"] = np.array(wire)
        results[f"overflow/{i}/entries"] = entries
        results[f"overflow/{i}/dense"] = dense
    # (f) resume the one-process checkpoint that the test wrote
    for kind in MODELS:
        history = resume(kind, os.path.join(root, f"resume-{kind}"), splits,
                         devices=world)
        results[f"resume/{kind}/history"] = np.array(json.dumps(history))
    np.savez(output, **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    main(rank, world, sys.argv[3], sys.argv[4], sys.argv[5])
