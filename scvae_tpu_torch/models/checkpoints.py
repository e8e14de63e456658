"""Checkpoints in the JAX package's format, learning curves and the other
per-run files (the port's copy of ``scvae_tpu/models/checkpoints.py``).

A checkpoint is ``checkpoint.npz``, the leaves of the whole train state
named as the JAX package names them (``params.train_state_to_jax``), plus
``checkpoint.json`` with the epoch and step: a checkpoint that either
package writes restores in the other.  A run keeps three versions: its
directory (end of training), ``best/`` (the best validation lower bound)
and ``early_stopping/`` (the epoch before degradation began).  Learning
curves, the GMVAE's per-epoch prior centroids and per-epoch vectors (the
per-neuron KL) are JSON files beside them.  Every write is atomic (a
temporary file, then a rename).  With ``async_write`` the checkpoint
writers (``save_checkpoint``, ``copy_checkpoint_version``,
``remove_checkpoint``) queue their file work on one background worker, as
the JAX package's do: the operations run in the order they were queued,
and ``save_checkpoint`` copies the tensors to the host before it queues
the write, so training may go on updating them.  ``wait_for_pending_writes``
blocks until the queue is empty and raises the first failed write.  The
worker's writes and version copies are the spans ``checkpoint.write`` and
``checkpoint.copy_version`` (``utils/tracing.py``), on its own thread.
Under ``torch.distributed`` the ranks share one view of the run directory
and only rank 0 writes (:func:`is_write_process`); every rank reads.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models.step import TrainState
from scvae_tpu_torch.utils import tracing

CHECKPOINT_FILE = "checkpoint.npz"
METADATA_FILE = "checkpoint.json"
LEARNING_CURVES_FILE = "learning_curves.json"
CENTROIDS_FILE = "centroids.json"
ARRAY_SERIES_FILE = "array_series.json"


# One worker: queued writes run in order, relative to each other and to the
# version copies and removals queued the same way.  Made on first use.
_executor: concurrent.futures.ThreadPoolExecutor | None = None
_executor_lock = threading.Lock()
_pending: list[concurrent.futures.Future] = []


def _submit(fn, *args) -> None:
    global _executor
    with _executor_lock:
        if _executor is None:
            _executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoints")
        _pending.append(_executor.submit(fn, *args))
        done = [future for future in _pending if future.done()]
        for future in done:
            _pending.remove(future)
    for future in done:  # surface a failed write
        future.result()


def wait_for_pending_writes() -> None:
    """Block until every queued checkpoint operation has finished; raise
    the error of one that failed."""
    while True:
        with _executor_lock:
            if not _pending:
                return
            future = _pending.pop(0)
        future.result()


def is_write_process() -> bool:
    """True unless this process is a rank other than 0 of a process group:
    the ranks of a data-parallel run share one run directory, and rank 0
    writes it (JAX ``_is_write_process``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _write_json(path: str, value: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)


def _read_json(path: str, default: Any) -> Any:
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def _write_checkpoint(directory: str, flat: dict[str, np.ndarray],
                      metadata: dict[str, Any]) -> None:
    with tracing.span("checkpoint.write", epoch=metadata["epoch"]) as span:
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, CHECKPOINT_FILE + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
            span.annotate(bytes=f.tell())
        os.replace(tmp, os.path.join(directory, CHECKPOINT_FILE))
        tmp = os.path.join(directory, METADATA_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(metadata, f, indent=2)
        os.replace(tmp, os.path.join(directory, METADATA_FILE))


def save_checkpoint(directory: str, train_state: TrainState, *, epoch: int,
                    extra_metadata: dict[str, Any] | None = None,
                    async_write: bool = False) -> None:
    """Persist ``train_state`` and its metadata (the epoch and the step)
    into ``directory``; with ``async_write`` the host copy is made here and
    the files are written by the background worker.  The state is whole:
    under a gene split every rank rebuilds it first
    (``parallel.unshard_train_state``, as the training loop does), since
    only rank 0 gets past the test below."""
    if not is_write_process():
        return
    flat = tparams.train_state_to_jax(train_state.params,
                                      train_state.model_state,
                                      train_state.opt_state, train_state.step)
    metadata = {"epoch": int(epoch), "step": int(train_state.step),
                **(extra_metadata or {})}
    if async_write:
        _submit(_write_checkpoint, directory, flat, metadata)
    else:
        _write_checkpoint(directory, flat, metadata)


def checkpoint_exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, CHECKPOINT_FILE))


def load_metadata(directory: str) -> dict[str, Any]:
    with open(os.path.join(directory, METADATA_FILE)) as f:
        return json.load(f)


def restore_checkpoint(directory: str,
                       template: TrainState) -> tuple[TrainState, dict]:
    """The train state stored in ``directory``, in the structure, dtypes
    and devices of ``template`` (shapes must match), and its metadata."""
    with np.load(os.path.join(directory, CHECKPOINT_FILE)) as data:
        flat = dict(data)
    params, model_state, opt_state, step = tparams.train_state_from_jax(
        flat, template.params, template.model_state, template.opt_state)
    return (TrainState(params=params, model_state=model_state,
                       opt_state=opt_state, step=step),
            load_metadata(directory))


def _copy_version(source_directory: str, target_directory: str) -> None:
    with tracing.span("checkpoint.copy_version",
                      version=os.path.basename(target_directory)) as span:
        os.makedirs(target_directory, exist_ok=True)
        copied = 0
        for filename in (CHECKPOINT_FILE, METADATA_FILE):
            source = os.path.join(source_directory, filename)
            if os.path.exists(source):
                shutil.copyfile(source,
                                os.path.join(target_directory, filename))
                copied += os.path.getsize(source)
        span.annotate(bytes=copied)


def copy_checkpoint_version(source_directory: str, target_directory: str, *,
                            async_write: bool = False) -> None:
    """Snapshot the checkpoint of ``source_directory`` into a version
    directory (``best/`` or ``early_stopping/``)."""
    if not is_write_process():
        return
    if async_write:
        _submit(_copy_version, source_directory, target_directory)
    else:
        _copy_version(source_directory, target_directory)


def _remove(directory: str) -> None:
    for filename in (CHECKPOINT_FILE, METADATA_FILE):
        path = os.path.join(directory, filename)
        if os.path.exists(path):
            os.remove(path)


def remove_checkpoint(directory: str, *, async_write: bool = False) -> None:
    if not is_write_process():
        return
    if async_write:
        _submit(_remove, directory)
    else:
        _remove(directory)


# --------------------------------------------------------------------------
# The GMVAE's prior centroids per epoch
# --------------------------------------------------------------------------


def append_centroids(directory: str, centroids: dict[str, Any]) -> None:
    """Append one epoch's {probabilities, means, covariance_matrices}."""
    if not is_write_process():
        return
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CENTROIDS_FILE)
    history = _read_json(path, [])
    history.append({k: _numpy(v).tolist() for k, v in centroids.items()})
    _write_json(path, history)


def load_centroids(directory: str) -> dict[str, np.ndarray] | None:
    """The centroid history stacked over epochs: name → (E, …) arrays."""
    history = _read_json(os.path.join(directory, CENTROIDS_FILE), [])
    if not history:
        return None
    return {key: np.asarray([epoch[key] for epoch in history])
            for key in history[0]}


def truncate_centroids(directory: str, number_of_epochs: int) -> None:
    if not is_write_process():
        return
    path = os.path.join(directory, CENTROIDS_FILE)
    if os.path.exists(path):
        _write_json(path, _read_json(path, [])[:number_of_epochs])


# --------------------------------------------------------------------------
# Per-epoch vectors (e.g. the per-neuron KL divergence)
# --------------------------------------------------------------------------


def append_array_series(directory: str, name: str, vector: Any) -> None:
    if not is_write_process():
        return
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, ARRAY_SERIES_FILE)
    series = _read_json(path, {})
    series.setdefault(name, []).append(_numpy(vector).tolist())
    _write_json(path, series)


def load_array_series(directory: str, name: str) -> np.ndarray | None:
    """The named series stacked over epochs: (E, …), or None."""
    series = _read_json(os.path.join(directory, ARRAY_SERIES_FILE), {})
    if not series.get(name):
        return None
    return np.asarray(series[name])


def truncate_array_series(directory: str, number_of_epochs: int) -> None:
    if not is_write_process():
        return
    path = os.path.join(directory, ARRAY_SERIES_FILE)
    if os.path.exists(path):
        series = _read_json(path, {})
        _write_json(path, {name: values[:number_of_epochs]
                           for name, values in series.items()})


# --------------------------------------------------------------------------
# Learning curves
# --------------------------------------------------------------------------


def load_learning_curves(directory: str) -> dict[str, dict[str, list[float]]]:
    return _read_json(os.path.join(directory, LEARNING_CURVES_FILE), {})


def append_learning_curves(directory: str,
                           epoch_metrics: dict[str, dict[str, float]]) -> None:
    """``epoch_metrics``: {"training": {"lower_bound": …}, "validation": …}."""
    if not is_write_process():
        return
    os.makedirs(directory, exist_ok=True)
    curves = load_learning_curves(directory)
    for kind, metrics in epoch_metrics.items():
        kind_curves = curves.setdefault(kind, {})
        for name, value in metrics.items():
            kind_curves.setdefault(name, []).append(float(value))
    _write_json(os.path.join(directory, LEARNING_CURVES_FILE), curves)


def truncate_learning_curves(directory: str, number_of_epochs: int) -> None:
    """Keep only the first ``number_of_epochs`` epochs (on resume)."""
    if not is_write_process():
        return
    curves = load_learning_curves(directory)
    _write_json(os.path.join(directory, LEARNING_CURVES_FILE), {
        kind: {name: values[:number_of_epochs]
               for name, values in kind_curves.items()}
        for kind, kind_curves in curves.items()
    })
