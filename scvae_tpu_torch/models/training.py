"""The training loop (the port of ``scvae_tpu/models/training.py``).

``run_training_loop`` runs epochs: the KL warm-up weight, one epoch through
the runner (``device_epoch_runner`` over device-resident data, or
``streaming_epoch_runner`` over batches streamed from the host, with
``evaluate_on_pipeline`` for the full passes), the NaN abort, the training
metrics (a full evaluation pass when an evaluator is given) and the
validation metrics, an optional callback, and with a log directory the
learning curves, the per-epoch vectors, a checkpoint each epoch and its
``best/`` and ``early_stopping/`` versions.  Early stopping follows the validation lower bound
(``EARLY_STOPPING_ROUNDS`` epochs without improvement).  Checkpoint files
are written by the checkpoints module's background worker unless
``async_checkpoints`` is off; the loop waits for them before it returns.

``fetch_mode="deferred"`` pipelines the host one epoch behind the device,
as the JAX package's does: epoch e + 1 is dispatched before epoch e's
metrics are fetched and processed, so the fetch and the evaluation's
dispatch overlap the next epoch's compute.  The port updates parameters
and optimiser state in place, so before epoch e + 1 is dispatched the
loop takes a device-to-device snapshot of epoch e's whole train state and
the training generator's state; epoch e's evaluations, callback,
checkpoint and stored generator state read the snapshot.  Curves,
checkpoints and early-stopping decisions are those of the sync mode; each
happens one epoch later, and a run that stops early has dispatched one
epoch more than it records (the returned train state is that epoch's, as
in the JAX package).

Random numbers: the run's generator draws the training steps' numbers
only.  Each epoch's training and validation evaluators draw from
generators of their own, seeded from the run generator's initial seed,
the epoch and the evaluator (the counterpart of the JAX package's split
of ``epoch_rng``, ``sub_t`` and ``sub_v``), so both fetch modes draw the
same numbers.  Each checkpoint stores the run generator's state after its
epoch (``generator_state`` in ``checkpoint.json``).  A run resumed at
epoch e rebuilds the early-stopping state from the stored validation curve
and sets the generator to the stored state, so it draws what an
uninterrupted run would draw from epoch e on: the counterpart of the JAX
package's replay of its key splits (``_fast_forward_rng``).

Under a mesh whose model axis cuts the heads (``placements``, those of
the whole parameters), the runner and the evaluators work on each rank's
gene block, and every rank rebuilds the whole train state
(``parallel.unshard_train_state``) for the callback and the checkpoint of
each epoch where there is one (an all-gather over the model group of
every cut head and its Adam moments), and for the state the loop
returns: the checkpoints hold whole arrays, in the JAX package's format.

Spans (``utils/tracing.py``, recorded only while the recorder is on): each
epoch is an ``epoch`` span with the children ``epoch.train`` (the interval
of ``epoch_seconds``, from the dispatch to the fetch of the lower bound;
recorded at the fetch in the deferred mode, where it begins before its
``epoch`` span), ``epoch.evaluate`` (``split``: training or validation),
``epoch.callback``, ``epoch.record`` (the learning curves) and
``epoch.checkpoint`` (the checkpoint's host copy and queued write, and
the version copies and removals).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from scvae_tpu_torch.models import checkpoints
from scvae_tpu_torch.models.objectives import EarlyStopping, warm_up_weight
from scvae_tpu_torch.models.step import (
    EVAL_METRIC_KEYS,
    TrainState,
    epoch_permutation,
    snapshot_state,
    tree_finite,
)
from scvae_tpu_torch.parallel.mesh import batch_rows, unshard_train_state
from scvae_tpu_torch.utils import tracing

EARLY_STOPPING_ROUNDS = 10

EpochRunner = Callable[[TrainState, int, float, torch.Generator], tuple[TrainState, dict]]
Evaluator = Callable[[TrainState, torch.Generator], dict[str, Any]]


@dataclasses.dataclass
class TrainingResult:
    train_state: TrainState
    number_of_epochs_trained: int
    stopped_early: bool
    best_epoch: int | None
    history: dict[str, dict[str, list[float]]]
    # Wall seconds of each epoch's training pass (evaluation excluded).
    # Sync: from its dispatch to the host fetch of its lower bound.
    # Deferred: from its dispatch to the same fetch, which follows the
    # dispatch of the next epoch, so it includes that dispatch's host time.
    epoch_seconds: list[float]
    steps_per_epoch: int


def generator_state(generator: torch.Generator) -> str:
    """The generator's state as a hex string for ``checkpoint.json``."""
    return generator.get_state().numpy().tobytes().hex()


def set_generator_state(generator: torch.Generator, state: str) -> None:
    generator.set_state(torch.frombuffer(bytearray.fromhex(state),
                                         dtype=torch.uint8))


def evaluation_generator(generator: torch.Generator, epoch: int,
                         evaluator: int) -> torch.Generator:
    """The generator of an epoch's evaluator (0: training, 1: validation),
    on the run generator's device, seeded from the run generator's initial
    seed, the epoch and the evaluator."""
    seed = np.random.SeedSequence(
        (generator.initial_seed(), epoch, evaluator)).generate_state(
            1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(seed))


def evaluate_on_pipeline(eval_step: Callable[..., dict[str, Any]],
                         train_state: TrainState, pipeline,
                         generator: torch.Generator, *,
                         scalar_keys=None) -> dict[str, Any]:
    """Full-pass evaluation over a :class:`~scvae_tpu_torch.data.pipeline.
    BatchPipeline` (JAX ``evaluate_on_pipeline``): each batch's metrics
    stay on the device until the pass ends, then are weighted by the
    batch's rows in float64 in batch order, as JAX sums them (a rank's
    block of a global batch by the global batch's rows: its metrics are the
    global batch's); vector metrics (the per-neuron KL) are averaged
    elementwise."""
    if scalar_keys is None:
        scalar_keys = EVAL_METRIC_KEYS
    kept: dict[str, list[torch.Tensor]] = {k: [] for k in scalar_keys}
    sizes: list[int] = []
    for batch in pipeline.epoch():
        metrics = eval_step(train_state.params, train_state.model_state,
                            batch, generator)
        for k in scalar_keys:
            if k in metrics:
                kept[k].append(metrics[k].detach().clone())
        sizes.append(batch_rows(batch))
    if not sizes:
        return {k: float("nan") for k in scalar_keys}
    totals: dict[str, Any] = {k: 0.0 for k in scalar_keys}
    for k, values in kept.items():
        if values:
            for value, b in zip(torch.stack(values).cpu().numpy(), sizes):
                totals[k] = totals[k] + np.asarray(value, np.float64) * b
    n_total = sum(sizes)
    out = {}
    for k, v in totals.items():
        v = v / n_total
        out[k] = float(v) if np.ndim(v) == 0 else np.asarray(v)
    return out


def streaming_epoch_runner(train_step: Callable,
                           make_training_pipeline: Callable[[int], Any]
                           ) -> EpochRunner:
    """Runner for data streamed from the host (JAX
    ``streaming_epoch_runner``): the epoch's pipeline from
    ``make_training_pipeline(epoch)``, one step per batch.  Each step's
    lower bound stays on the device and all are fetched once when the
    epoch ends, so the host builds the next batch while the card runs the
    step; the epoch's lower bound is their mean in float64, JAX's value."""

    def run_epoch(train_state, epoch, wuw, generator):
        bounds = []
        for batch in make_training_pipeline(epoch).epoch():
            train_state, metrics = train_step(train_state, batch, generator,
                                              wuw)
            bounds.append(metrics["lower_bound"].detach().clone())
        values = torch.stack(bounds).cpu().numpy().astype(np.float64)
        return train_state, {"lower_bound": float(np.mean(values))}

    return run_epoch


def device_epoch_runner(train_epoch: Callable, data: dict[str, torch.Tensor],
                        n_examples: int, batch_size: int, seed: int, *,
                        lazy: bool = False) -> EpochRunner:
    """Runner for device-resident data: the epoch's shuffled (n_batches, B)
    permutation is made on the host from ``seed + epoch`` (as in the JAX
    package) and copied to the device once.  The epoch's lower bound comes
    back as a float, or with ``lazy`` as the device scalar, unfetched (what
    ``fetch_mode="deferred"`` needs)."""
    device = next(iter(data.values())).device

    def run_epoch(train_state, epoch, wuw, generator):
        perm = epoch_permutation(
            n_examples, batch_size, np.random.RandomState(seed + epoch)
        )
        perm = torch.from_numpy(perm).to(device)
        train_state, metrics = train_epoch(
            train_state, data, perm, generator, wuw
        )
        if lazy:
            return train_state, {"lower_bound": metrics["lower_bound"]}
        return train_state, {"lower_bound": float(metrics["lower_bound"])}

    return run_epoch


def _record(epoch_metrics, history, log_directory) -> dict[str, dict[str, float]]:
    """Scalars into the history (returned for the learning curves); vectors
    (the per-neuron KL) into the run's array series."""
    scalars: dict[str, dict[str, float]] = {}
    for kind, metrics in epoch_metrics.items():
        kind_history = history.setdefault(kind, {})
        kind_scalars = scalars.setdefault(kind, {})
        for name, value in metrics.items():
            if np.ndim(value) > 0:
                if log_directory:
                    checkpoints.append_array_series(log_directory,
                                                    f"{name}-{kind}", value)
                continue
            kind_history.setdefault(name, []).append(float(value))
            kind_scalars[name] = float(value)
    return scalars


def _keep_versions(log_directory, status, async_write) -> None:
    """``early_stopping/`` snapshots the last epoch before degradation;
    ``best/`` follows each improvement and invalidates that snapshot."""
    if status["start_degrading"]:
        checkpoints.copy_checkpoint_version(
            log_directory, os.path.join(log_directory, "early_stopping"),
            async_write=async_write)
    if status["improved"]:
        checkpoints.copy_checkpoint_version(
            log_directory, os.path.join(log_directory, "best"),
            async_write=async_write)
        checkpoints.remove_checkpoint(
            os.path.join(log_directory, "early_stopping"),
            async_write=async_write)


def run_training_loop(
    *,
    train_state: TrainState,
    run_epoch: EpochRunner,
    evaluate_training: Evaluator | None,
    evaluate_validation: Evaluator | None = None,
    number_of_epochs: int,
    generator: torch.Generator,
    steps_per_epoch: int,
    number_of_warm_up_epochs: int = 0,
    log_directory: str | None = None,
    early_stopping_rounds: int = EARLY_STOPPING_ROUNDS,
    start_epoch: int = 0,
    verbose: bool = True,
    epoch_callback: Callable[[int, TrainState, dict], None] | None = None,
    async_checkpoints: bool = True,
    fetch_mode: str = "sync",
    placements=None,
) -> TrainingResult:
    """Run epochs ``start_epoch`` to ``number_of_epochs`` (see the module
    docstring).  ``fetch_mode="deferred"`` needs a runner whose lower bound
    comes back unfetched (``device_epoch_runner(..., lazy=True)``) to
    overlap anything; with a float it runs the same pipeline without
    gain."""
    if fetch_mode not in ("sync", "deferred"):
        raise ValueError(f"Unknown fetch_mode {fetch_mode!r}")
    early = EarlyStopping(rounds=early_stopping_rounds)
    history: dict[str, dict[str, list[float]]] = {}
    if log_directory:
        curves = checkpoints.load_learning_curves(log_directory)
        validation_curve = curves.get("validation", {}).get("lower_bound", [])
        for epoch, value in enumerate(validation_curve[:start_epoch]):
            early.update(value, epoch)
        history = {kind: dict(values) for kind, values in curves.items()}

    epoch_seconds: list[float] = []
    outcome = {"stopped_early": False, "epochs": start_epoch}

    def fetch(train_metrics: dict, started: float) -> float:
        """The training pass's lower bound, fetched: the pass ends here."""
        lower_bound = float(train_metrics["lower_bound"])
        epoch_seconds.append(time.perf_counter() - started)
        return lower_bound

    def process(epoch: int, state: TrainState, train_metrics: dict,
                lower_bound: float, stored_generator: str) -> bool:
        """Record one epoch's results; True: stop training."""
        if not np.isfinite(lower_bound):
            raise ArithmeticError(
                f"The lower bound became NaN/inf at epoch {epoch + 1}."
            )
        if evaluate_training is not None:
            with tracing.span("epoch.evaluate", split="training"):
                training_metrics = evaluate_training(
                    state, evaluation_generator(generator, epoch, 0))
        else:
            training_metrics = {k: float(v) for k, v in train_metrics.items()}
        epoch_metrics = {"training": training_metrics}
        if evaluate_validation is not None:
            with tracing.span("epoch.evaluate", split="validation"):
                epoch_metrics["validation"] = evaluate_validation(
                    state, evaluation_generator(generator, epoch, 1))
        if epoch_callback is not None or log_directory:
            # on every rank alike: the callback and the checkpoint read it
            state = unshard_train_state(state, placements)
        # before the records, so that the callback may add metrics
        if epoch_callback is not None:
            with tracing.span("epoch.callback"):
                epoch_callback(epoch, state, epoch_metrics)
        with tracing.span("epoch.record"):
            scalars = _record(epoch_metrics, history, log_directory)
            if log_directory:
                checkpoints.append_learning_curves(log_directory, scalars)
        if verbose:
            pieces = [f"Epoch {epoch + 1}/{number_of_epochs} "
                      f"({epoch_seconds[-1]:.3g} s)",
                      f"ELBO(train): "
                      f"{epoch_metrics['training']['lower_bound']:.6g}"]
            if "validation" in epoch_metrics:
                pieces.append(f"ELBO(valid): "
                              f"{epoch_metrics['validation']['lower_bound']:.6g}")
            print("  ".join(pieces))
        outcome["epochs"] = epoch + 1

        status = None
        if "validation" in epoch_metrics:
            status = early.update(epoch_metrics["validation"]["lower_bound"],
                                  epoch)
        if log_directory:
            with tracing.span("epoch.checkpoint"):
                checkpoints.save_checkpoint(
                    log_directory, state, epoch=epoch + 1,
                    extra_metadata={"generator_state": stored_generator},
                    async_write=async_checkpoints)
                if status is not None:
                    _keep_versions(log_directory, status, async_checkpoints)
                else:  # no validation set: the best is the latest
                    checkpoints.copy_checkpoint_version(
                        log_directory, os.path.join(log_directory, "best"),
                        async_write=async_checkpoints)
        if status is not None and status["stop"]:
            outcome["stopped_early"] = True
            if verbose:
                print(f"Stopping early: no validation improvement for "
                      f"{early_stopping_rounds} epochs.")
            return True
        return False

    def process_deferred(epoch: int, state: TrainState, train_metrics: dict,
                         stored_generator: str, started: float,
                         started_ns: int) -> bool:
        """Fetch and record an epoch dispatched before the current one: its
        training span began before its ``epoch`` span."""
        with tracing.span("epoch", epoch=epoch):
            lower_bound = fetch(train_metrics, started)
            tracing.record("epoch.train", started_ns, time.time_ns(),
                           epoch=epoch)
            return process(epoch, state, train_metrics, lower_bound,
                           stored_generator)

    pending = None  # deferred: (epoch, snapshot, metrics, generator, starts)
    for epoch in range(start_epoch, number_of_epochs):
        wuw = warm_up_weight(epoch, number_of_warm_up_epochs)
        if fetch_mode == "sync":
            with tracing.span("epoch", epoch=epoch):
                started = time.perf_counter()
                with tracing.span("epoch.train", epoch=epoch):
                    train_state, train_metrics = run_epoch(
                        train_state, epoch, wuw, generator)
                    lower_bound = fetch(train_metrics, started)
                if process(epoch, train_state, train_metrics, lower_bound,
                           generator_state(generator)):
                    break
            continue
        started, started_ns = time.perf_counter(), time.time_ns()
        train_state, train_metrics = run_epoch(train_state, epoch, wuw,
                                               generator)
        dispatched = (epoch, snapshot_state(train_state), train_metrics,
                      generator_state(generator), started, started_ns)
        if pending is not None and process_deferred(*pending):
            pending = None
            break
        pending = dispatched
    if pending is not None:
        process_deferred(*pending)
    if fetch_mode == "sync" and not outcome["stopped_early"]:
        outcome["epochs"] = number_of_epochs  # as JAX's, on any resume

    checkpoints.wait_for_pending_writes()
    train_state = unshard_train_state(train_state, placements)
    if not tree_finite(train_state.params):
        raise ArithmeticError("Model parameters became non-finite.")
    return TrainingResult(
        train_state=train_state,
        number_of_epochs_trained=outcome["epochs"],
        stopped_early=outcome["stopped_early"],
        best_epoch=early.best_epoch,
        history=history,
        epoch_seconds=epoch_seconds,
        steps_per_epoch=steps_per_epoch,
    )


def resume_start_epoch(log_directory: str) -> int:
    """The epoch to resume from: the stored checkpoint's epoch, else 0."""
    checkpoints.wait_for_pending_writes()
    if checkpoints.checkpoint_exists(log_directory):
        return int(checkpoints.load_metadata(log_directory)["epoch"])
    return 0
