#!/usr/bin/env python3
"""One benchmark run of a cell with the port's span recorder on, and the
training loop's phases that its spans show:

    python3 tools/span_breakdown.py --workload NAME --seed N --seconds S \\
        --trace 0|1 [--out FILE]

The run is ``portbench/run.py``'s (``harness.run_cell``, the clock started
at the process's start), with ``scvae_tpu_torch.utils.tracing`` enabled
before anything else runs, so its ``train_cells_per_s`` and ``setup_s``
against ``portbench/run.py``'s on the same seed are the recorder's cost.
It prints the run's result line, then one JSON line of what the spans give
(also written to FILE):

* over the window's epochs (the window's ends taken on the spans' clock):
  Σ ``epoch.train`` against the loop's ``epoch_seconds``; the
  ``epoch.evaluate``, ``epoch.checkpoint``, ``epoch.callback`` and
  ``epoch.record`` milliseconds an epoch; the checkpoint writer thread's
  milliseconds an epoch; the graph captures counted after the window
  opened;
* over set-up: the ``train.stage`` span and its children, the
  ``step.eager`` and ``step.capture`` spans, and the seconds of
  ``train``'s first epoch before ``train.stage`` and between it and the
  first ``epoch`` span, which no span covers;
* over the run: its ``epoch.evaluate`` spans against the evaluation
  passes the counters ``eval.fused_passes`` and ``eval.unfused_passes``
  counted;
* with ``--trace 1``, over the profiled epoch: the device time of the
  operations whose launching runtime call (matched by the trace's
  ``correlation``) starts inside its ``epoch.train`` span, a step, and
  inside its ``epoch.evaluate`` span; the share of kernel time launched
  inside no span; each span against its ``user_annotation`` event
  (``ts`` × 1000 + ``baseTimeNanoseconds``).

Needs one CUDA device; the card's name is in the result line.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scvae_tpu_torch.utils import tracing  # noqa: E402

tracing.enable()

from portbench import harness  # noqa: E402
from portbench import trace as trace_file  # noqa: E402

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")
PHASES = ("epoch.train", "epoch.evaluate", "epoch.callback", "epoch.record",
          "epoch.checkpoint")


class Marks:
    """The window's ends on the spans' clock, the runs and the raw trace,
    taken around the harness's own code."""

    def __init__(self):
        self.first_callback_ns = self.open_ns = self.close_ns = None
        self.captures_at_open = 0
        self.runs: list[harness.Run] = []
        self.raw: dict | None = None

    def install(self) -> None:
        window_open, window_call = harness.Window._open, harness.Window.__call__
        make_run, load = harness.Run, trace_file.load
        marks = self

        def opened(window, epoch):
            window_open(window, epoch)
            marks.open_ns = time.time_ns()
            marks.captures_at_open = tracing.counters().get(
                "step.graph_captures", 0)

        def called(window, epoch, train_state, epoch_metrics):
            if marks.first_callback_ns is None:
                marks.first_callback_ns = time.time_ns()
            try:
                return window_call(window, epoch, train_state, epoch_metrics)
            except harness.WindowClosed:
                marks.close_ns = time.time_ns()
                raise

        def run(**fields):
            made = make_run(**fields)
            marks.runs.append(made)
            return made

        def loaded(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                marks.raw = json.load(f)
            return load(path)

        harness.Window._open = opened
        harness.Window.__call__ = called
        harness.Run = run
        trace_file.load = loaded


def _ms(seconds: float) -> float:
    return seconds * 1e3


def window_phases(spans, marks: Marks, run) -> dict:
    """Milliseconds an epoch of each phase over the window's epochs."""
    inside = [s for s in spans if marks.open_ns <= s.start_ns < marks.close_ns]
    out = {}
    for name in PHASES:
        out[f"{name}_ms_per_epoch"] = _ms(sum(
            s.seconds for s in inside if s.name == name)) / run.window_epochs
    writer = [s for s in inside if s.name.startswith("checkpoint.")
              and s.thread != "MainThread"]
    out["checkpoint.writer_ms_per_epoch"] = _ms(
        sum(s.seconds for s in writer)) / run.window_epochs
    trained = [s.seconds for s in inside if s.name == "epoch.train"]
    out["epoch_train_minus_epoch_seconds_ms"] = [
        _ms(a - b) for a, b in zip(trained, run.window_epoch_seconds)]
    out["window_epochs"] = run.window_epochs
    out["outside_ms_per_epoch"] = _ms(
        run.window_seconds - sum(run.window_epoch_seconds)) / run.window_epochs
    out["window_captures"] = (tracing.counters().get("step.graph_captures", 0)
                              - marks.captures_at_open)
    return out


def set_up(spans, marks: Marks, run) -> dict:
    """Set-up's spans, and the parts of ``train``'s first epoch that no
    span covers: before ``train.stage``, and from its end to the first
    ``epoch`` span."""
    before = [s for s in spans if s.end_ns <= marks.open_ns]
    totals: dict[str, float] = collections.defaultdict(float)
    for s in before:
        if s.name.startswith(("train.stage", "stage.", "step.")):
            key = s.name + (f"[{s.attrs['kind']}]" if "kind" in s.attrs
                            else "")
            totals[key] += s.seconds
    out = dict(totals)
    out["setup.capture_s"] = sum(s.seconds for s in before
                                 if s.name in ("step.eager", "step.capture"))
    stage = next(s for s in before if s.name == "train.stage")
    first = min((s for s in spans if s.name == "epoch"),
                key=lambda s: s.start_ns)
    out["before_stage_s"] = run.first_epoch_seconds - (
        marks.first_callback_ns - stage.start_ns) * 1e-9
    out["stage_to_first_epoch_s"] = (first.start_ns - stage.end_ns) * 1e-9
    return out


def profiled(spans, raw: dict, steps: int) -> dict:
    """The profiled epoch's device time by the phase that launched it."""
    base = int(raw["baseTimeNanoseconds"])
    events = [e for e in raw.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e]
    ns = lambda e: float(e["ts"]) * 1e3 + base  # noqa: E731
    first = min(ns(e) for e in events)
    last = max(ns(e) + float(e.get("dur", 0.0)) * 1e3 for e in events)
    inside = [s for s in spans if s.name in PHASES
              and first <= s.start_ns and s.end_ns <= last]
    launched = {e["args"]["correlation"]: ns(e) for e in events
                if e.get("cat") in RUNTIME and "correlation" in e.get(
                    "args", {})}
    by_phase: dict[str, float] = collections.defaultdict(float)
    kernel_seconds = no_span = 0.0
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        seconds = float(e.get("dur", 0.0)) * 1e-6
        at = launched.get(e.get("args", {}).get("correlation"))
        phase = next((s.name for s in inside
                      if at is not None and s.start_ns <= at < s.end_ns),
                     None)
        by_phase[phase or "none"] += seconds
        if e.get("cat") == "kernel":
            kernel_seconds += seconds
            no_span += seconds if phase is None else 0.0
    epochs = sum(s.name == "epoch.train" for s in inside)
    annotations = [e for e in events if e.get("cat") == "user_annotation"]
    worst = 0.0
    unmatched = 0
    for s in inside:
        match = min((e for e in annotations if e["name"] == s.name),
                    key=lambda e: abs(ns(e) - s.start_ns), default=None)
        if match is None:
            unmatched += 1
            continue
        end = ns(match) + float(match["dur"]) * 1e3
        worst = max(worst, abs(ns(match) - s.start_ns), abs(end - s.end_ns))
    return {
        "profiled_epochs": epochs,
        "train.device_ms_per_step": _ms(by_phase["epoch.train"])
        / (epochs * steps) if epochs else None,
        "eval.device_ms_per_epoch": _ms(by_phase["epoch.evaluate"]) / epochs
        if epochs else None,
        "device_ms_by_phase": {k: _ms(v) for k, v in by_phase.items()},
        "kernel_ms": _ms(kernel_seconds),
        "kernel_share_in_no_span": no_span / kernel_seconds
        if kernel_seconds else None,
        "span_vs_annotation_worst_ms": worst * 1e-6,
        "spans_without_annotation": unmatched,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    marks = Marks()
    marks.install()
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), started=STARTED)
    (run,) = marks.runs
    spans = tracing.spans()
    counters = tracing.counters()
    found = {"workload": args.workload, "seed": args.seed,
             "trace": args.trace, "window": window_phases(spans, marks, run),
             "setup": set_up(spans, marks, run),
             "evaluations": {
                 "epoch.evaluate": sum(s.name == "epoch.evaluate"
                                       for s in spans),
                 **{name: counters.get(name, 0) for name in (
                     "eval.fused_passes", "eval.unfused_passes")}}}
    if args.trace:
        found["profiled"] = profiled(spans, marks.raw, run.steps_per_epoch)
    print(json.dumps(result), flush=True)
    print(json.dumps(found), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"result": result, "spans": found}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
