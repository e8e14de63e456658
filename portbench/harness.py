"""One run of one cell: the program's ``train`` as a user calls it, a
measured window of whole epochs, then the check that decides ``correct``.

The program is ``scvae_tpu_torch``, the PyTorch and CUDA port; this module
is the only one of the benchmark that imports it.  A run:

1. makes the cell's counts from the seed (``counts.py``) and the model from
   its configuration file;
2. calls ``train`` once, on the device-resident set, evaluating the whole
   training set after every epoch, fetching each epoch's metrics at its
   end, and writing a checkpoint every epoch into a fresh log directory
   under ``TMPDIR``, as users' runs do;
3. at the first epoch's callback keeps the program's state and evaluation
   for the check, and opens the window (with ``--trace 1`` it first
   profiles one whole epoch, and opens the window after it);
4. closes the window at the first callback at least ``seconds`` after it
   opened, keeps that epoch's state and evaluation too, and stops
   ``train`` by raising from that callback: the window holds whole epochs,
   each its training pass, its evaluation, its fetch, its callback and the
   host copy and queued write of a checkpoint;
5. waits for the checkpoint writer, reads the state that the last epoch
   started from out of the checkpoint of the epoch before, frees the
   program, and runs the check (``check.py``) against the reference.

Set-up, ``setup_s``, runs from the process's start to the window's: the
counts, the model, the staging inside ``train``, the first epoch with its
eager step and graph capture (and its kernels' build on a checkout's first
run, into the checkout's ``build/``).  The window reads the host's clock;
each metric's reader (``metrics/<name>.py``) takes its value from the
:class:`Run` record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Any

import torch

import scvae_tpu_torch
from scvae_tpu_torch.models import checkpoints
from scvae_tpu_torch.utils import profiling
from portbench import check, trace as trace_file
from portbench.counts import make_counts
from portbench.spec import Benchmark

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "scvae_tpu")
# A bound on the epochs ``train`` is asked for; the window stops it long
# before.
MAX_EPOCHS = 100_000
CONFIG_META = ("model", "assumed", "published", "notes")


class WindowClosed(Exception):
    """Raised from the epoch callback that closes the window."""


def _host(tree) -> dict[str, torch.Tensor]:
    """Host copies: the program goes on updating its tensors in place."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in flatten(tree).items()}


def _end_of_epoch(epoch: int, train_state, epoch_metrics) -> dict:
    """What the check reads of an epoch's end, as the callback hands it."""
    return {"epoch": epoch,
            "end": {"params": _host(train_state.params),
                    "state": _host(train_state.model_state),
                    "mu": _host(train_state.opt_state["mu"]),
                    "count": int(train_state.opt_state["count"])},
            "eval_lower_bound": float(
                epoch_metrics["training"]["lower_bound"])}


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    workload: str
    spec: dict  # the configuration's sizes
    traffic: dict
    reference: Any  # the configuration's plain reference module
    cells: int
    batch: int
    steps_per_epoch: int
    setup_seconds: float
    first_epoch_seconds: float
    window_seconds: float
    window_epochs: int
    # the program's own seconds of each window epoch's training pass
    # (``TrainingResult.epoch_seconds``)
    window_epoch_seconds: list[float]
    window_peak_bytes: int
    trace: trace_file.Trace | None = None


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested dict / list of tensors as {"a.b.0.c": tensor}."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: dict[str, torch.Tensor] = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _loop_epoch_seconds(tb) -> list[float]:
    """The training loop's ``epoch_seconds`` (what becomes
    ``TrainingResult.epoch_seconds``) from the frames that the window's
    exception unwound: ``train`` returns no result when stopped.  A run
    whose loop holds no such list stops here, rather than report without
    the metrics that read it."""
    found = None
    while tb is not None:
        value = tb.tb_frame.f_locals.get("epoch_seconds")
        if isinstance(value, list) and all(isinstance(v, float)
                                           for v in value):
            found = list(value)
        tb = tb.tb_next
    if found is None:
        raise RuntimeError("the training loop's epoch_seconds was not found "
                           "in the frames that the window closed")
    return found


def _checkpointed_start(log_directory: str, template, epoch: int) -> dict:
    """The state that epoch ``epoch`` (from 0) started from: the program's
    checkpoint of the epoch before, the latest that ``train`` wrote."""
    found = [os.path.dirname(path) for path in glob.glob(
        os.path.join(log_directory, "**", checkpoints.CHECKPOINT_FILE),
        recursive=True) if os.path.basename(os.path.dirname(path)) != "best"]
    if len(found) != 1:
        raise RuntimeError(f"expected one checkpoint under {log_directory}, "
                           f"found {found}")
    state, metadata = checkpoints.restore_checkpoint(found[0], template)
    if metadata["epoch"] != epoch:
        raise RuntimeError(f"the checkpoint is of epoch {metadata['epoch']}, "
                           f"not {epoch}")
    return {"params": _host(state.params), "state": _host(state.model_state),
            "mu": _host(state.opt_state["mu"]),
            "nu": _host(state.opt_state["nu"]),
            "count": int(state.opt_state["count"])}


class Window:
    """The ``epoch_callback``: set-up ends at the first epoch's callback,
    the window at the first callback ``seconds`` after it opened."""

    def __init__(self, seconds: float, device: torch.device,
                 profile_dir: str | None):
        self.seconds = seconds
        self.cuda = device.type == "cuda"
        self.profile_dir = profile_dir
        self._profiling: contextlib.ExitStack | None = None
        self.first_epoch_end: float | None = None
        self.first: dict | None = None  # the first epoch's end
        self.last: dict | None = None  # the end of the epoch that closed it
        self.last_state = None  # its train state, a template to restore
        self.setup_peak = 0
        self.window_peak = 0
        self.start = self.end = None
        self.opened_after_epoch = None
        self.closed_after_epoch = None
        self.trace_seconds = None

    def _memory(self) -> int:
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def _open(self, epoch: int) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.opened_after_epoch = epoch
        self.start = time.perf_counter()

    def __call__(self, epoch: int, train_state, epoch_metrics) -> None:
        now = time.perf_counter()
        if self.first_epoch_end is None:
            self.first_epoch_end = now
            self.first = {**_end_of_epoch(epoch, train_state, epoch_metrics),
                          "start": None}
            self.setup_peak = self._memory()
            if self.profile_dir is not None:
                self._profiling = contextlib.ExitStack()
                self.trace_seconds = now
                self._profiling.enter_context(profiling.trace(
                    self.profile_dir))
                return
            self._open(epoch)
            return
        if self._profiling is not None:
            self._profiling.close()  # synchronises, then writes the trace
            self._profiling = None
            self.trace_seconds = now - self.trace_seconds
            self._open(epoch)
            return
        if now - self.start >= self.seconds:
            self.end = now
            self.closed_after_epoch = epoch
            self.window_peak = self._memory()
            self.last = _end_of_epoch(epoch, train_state, epoch_metrics)
            self.last_state = train_state
            raise WindowClosed


def _model(config: dict, log_directory: str):
    """The configuration's model class of the program, by its name."""
    kwargs = {k: v for k, v in config.items() if k not in CONFIG_META}
    return getattr(scvae_tpu_torch, config["model"])(
        log_directory=log_directory, **kwargs)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", started: float | None = None,
             benchmark: Benchmark | None = None,
             overrides: dict | None = None) -> dict:
    """One run; returns the result line's fields.  ``device="cpu"`` (with
    ``overrides`` of the configuration's and the traffic's keys, at a size
    the CPU holds) rehearses a run for the tests: no device metric."""
    started = time.perf_counter() if started is None else started
    benchmark = benchmark or Benchmark()
    overrides = overrides or {}
    cell = benchmark.workload(workload)
    traffic = {**benchmark.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    config = benchmark.sizes(cell["config"], traffic)
    config = {**config, **overrides.get("config", {})}
    limits = benchmark.limits(workload)
    model_reference = benchmark.reference(cell["config"])
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    counts = make_counts(traffic["cells"], traffic["genes"],
                         traffic["density"], traffic["mean"], seed, device)
    print(f"counts made at {time.perf_counter() - started:.3f} s",
          file=sys.stderr)
    batch = traffic["minibatch_size"]
    log_root = tempfile.mkdtemp(prefix="portbench-")
    window = Window(seconds, device,
                    os.path.join(log_root, "trace") if trace else None)
    models = os.path.join(log_root, "models")
    model = _model(config, models)
    train_called = time.perf_counter()
    try:
        model.train(counts, number_of_epochs=MAX_EPOCHS,
                    minibatch_size=batch, full_train_evaluation=True,
                    data_placement="device", metrics_fetch="sync",
                    seed=seed, verbose=False, epoch_callback=window,
                    reset_training=True, device=device)
        raise RuntimeError("train ended before the window closed")
    except WindowClosed as closed:
        epoch_seconds = _loop_epoch_seconds(closed.__traceback__)
    checkpoints.wait_for_pending_writes()  # outside the window
    last = {**window.last, "start": _checkpointed_start(
        models, window.last_state, window.closed_after_epoch)}
    window.last_state = None
    if device.type == "cuda":
        torch.cuda.synchronize()
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    steps = traffic["cells"] // batch
    window_epochs = window.closed_after_epoch - window.opened_after_epoch
    run = Run(
        workload=workload, spec=config, traffic=traffic,
        reference=model_reference, cells=traffic["cells"], batch=batch,
        steps_per_epoch=steps, setup_seconds=window.start - started,
        first_epoch_seconds=window.first_epoch_end - train_called,
        window_seconds=window.end - window.start,
        window_epochs=window_epochs,
        window_epoch_seconds=epoch_seconds[
            window.opened_after_epoch + 1:window.closed_after_epoch + 1],
        window_peak_bytes=window.window_peak,
    )
    print(f"set-up {run.setup_seconds:.3f} s (first epoch "
          f"{run.first_epoch_seconds:.3f} s); window "
          f"{run.window_seconds:.3f} s, {window_epochs} epochs; epoch "
          f"seconds {epoch_seconds}", file=sys.stderr)
    if trace:
        path = trace_file.newest(window.profile_dir)
        run.trace = trace_file.load(path)
        print(f"trace {os.path.getsize(path)} bytes, profiled epoch "
              f"{window.trace_seconds:.3f} s on the host's clock, "
              f"{len(run.trace.kernels)} kernels",
              file=sys.stderr)

    checked = time.perf_counter()
    counts_device = torch.from_numpy(counts).to(device)
    on_device = lambda tree: {  # noqa: E731
        k: ({n: t.to(device) for n, t in v.items()}
            if isinstance(v, dict) else v) for k, v in tree.items()}
    program = [{**epoch, "end": on_device(epoch["end"]),
                "start": epoch["start"] and on_device(epoch["start"])}
               for epoch in (window.first, last)]
    worst: dict[str, str] = {}
    try:
        values = check.numbers(model_reference, config, counts_device, seed,
                               batch, program, worst=worst)
    except ValueError as err:  # the program's state is not the model's
        print(f"check failed: {err}", file=sys.stderr)
        values = {name: math.inf for name in check.NUMBERS}
    correct = check.verdict(values, limits)
    print(f"check took {time.perf_counter() - checked:.3f} s; worst leaves "
          f"{worst}", file=sys.stderr)
    shutil.rmtree(log_root, ignore_errors=True)

    result: dict[str, Any] = {"correct": correct,
                              "attempted": window_epochs * steps,
                              "failed": 0}
    if device.type == "cuda":
        key = "per_layer" if trace else "end_to_end"
        metrics = {}
        for entry in benchmark.metrics(workload, key):
            value = benchmark.reader(entry["name"]).read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        result["metrics"] = metrics
        result["device"] = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": max(window.setup_peak, window.window_peak),
        }
        if trace:
            result["device"]["busy_s"] = trace_file.busy_seconds(
                run.trace.device)
            result["device"]["window_s"] = trace_file.span(run.trace.device)
            result["breakdown"] = {
                "device_ops": trace_file.top_kernels(run.trace),
                "idle_gaps": trace_file.idle_by_host(run.trace),
            }
    # last in the line: each number compared, beside its limit (a number
    # that is not finite is written as the largest float, which JSON holds)
    result["checks"] = {
        name: {"value": values[name] if math.isfinite(values[name])
               else sys.float_info.max, "limit": limits[name]}
        for name in check.NUMBERS}
    return result


def written_bytes() -> dict[str, int]:
    """What this process has written (``/proc/self/io``): ``wchar``, the
    bytes it handed to write calls, and ``write_bytes``, those that reached
    storage (none where the files are in memory)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def main(argv: list[str] | None = None, started: float | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    benchmark = Benchmark()
    chips = benchmark.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), started=started, benchmark=benchmark)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that the run may not load were loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(f"written {written_bytes()}", file=sys.stderr)
    for name, entry in result["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
