"""The numbers that decide ``correct``, each held against its limit.

The program trains inside ``train`` from the seed; the harness keeps what
the epoch callback hands over at the end of two epochs: the first, before
the window, and the last, whose callback closes the window.  Of each: the
parameters, the batch-norm statistics, Adam's first moment and step count,
and the per-epoch evaluation's lower bound of the training set; of the
last also the state it started from, which the program's checkpoint of
the epoch before holds.  The reference trains each of the two epochs in
float32 (``reference.train_epoch``): the first from the seed, the last
from the program's state before it, the only way to follow the program
that far.  It evaluates the program's state of each epoch over the whole
set (``reference.evaluate``).  Numbers, each the larger of the two epochs'
but ``steps_gap``:

* ``eval_gap``: |program's lower bound − the reference's evaluation of the
  program's own state| over the latter's magnitude (the per-epoch
  evaluation pass, judged on the state it was given);
* ``grad_gap``: over the leaves that count, the largest gap between the
  norms of Adam's first moment after the epoch (the clipped gradients as
  the optimiser holds them), program against reference;
* ``change_gap``: the same for the parameters' change over the epoch;
* ``state_gap``: the same for the batch-norm statistics' change over the
  epoch, over every statistic;
* ``steps_gap``: the step counts' differences, summed (exact: limit 0).

A leaf gap is |‖program‖ − ‖reference‖| over the larger of the reference's
norm of that leaf and its median leaf's.  A parameter counts unless the
reference's first clipped gradient of it in the first epoch is under a
thousandth of the median leaf's: the biases before batch norm, whose
gradient is zero but for rounding, move under Adam by rounding alone.

Imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import reference

NUMBERS = ("eval_gap", "grad_gap", "change_gap", "state_gap", "steps_gap")
NEGLIGIBLE_GRADIENT = 1e-3


def kept_leaves(first_gradient: dict[str, float]) -> list[str]:
    median = float(np.median(list(first_gradient.values())))
    return sorted(k for k, v in first_gradient.items()
                  if v >= NEGLIGIBLE_GRADIENT * median)


def leaf_gaps(program: dict, ref: dict, kept: list[str]) -> dict:
    """Each kept leaf's gap."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    ref_norms = {k: norm(ref[k]) for k in kept}
    median = float(np.median(list(ref_norms.values())))
    return {k: abs(norm(program[k]) - ref_norms[k])
            / max(ref_norms[k], median, 1e-30) for k in kept}


def _same_names(label: str, program: dict, ref: dict) -> None:
    if set(program) != set(ref):
        differ = sorted(set(ref) ^ set(program))
        raise ValueError(f"{label} names differ: {differ[:6]}")


def follow(model, spec: dict, counts: torch.Tensor, seed: int, batch: int,
           epoch: dict) -> dict:
    """The reference's run of one of the program's epochs: ``epoch`` holds
    its number and the state it started from (None for the first)."""
    return reference.train_epoch(
        model, spec, counts, seed, batch, epoch=epoch["epoch"],
        start=epoch["start"], learning_rate=spec["learning_rate"])


def numbers(model, spec: dict, counts: torch.Tensor, seed: int,
            batch: int, program: list[dict], first_ref: dict | None = None,
            worst: dict | None = None) -> dict:
    """The numbers of one run.  ``program`` holds the program's epochs,
    the first from the seed (``start`` None) and the last (``start`` the
    state after the epoch before it): each its ``epoch`` (from 0), ``end``
    (``params``, ``state``, ``mu``: name → tensor, on the counts' device;
    ``count``) and ``eval_lower_bound``.  ``first_ref``: the reference's
    first epoch, computed here when not given.  ``worst``, when given,
    gets each leaf gap's worst leaf and epoch, for the run's log."""
    refs = [first_ref if i == 0 and first_ref is not None else
            follow(model, spec, counts, seed, batch, epoch)
            for i, epoch in enumerate(program)]
    kept = kept_leaves(refs[0]["first_gradient"])
    out = dict.fromkeys(NUMBERS, 0.0)
    for epoch, ref in zip(program, refs):
        end = epoch["end"]
        _same_names("parameter", end["params"], ref["params"])
        _same_names("statistic", end["state"], ref["state"])
        evaluated = reference.evaluate(model, spec, end["params"],
                                       end["state"], counts, seed,
                                       epoch["epoch"], batch)
        start = ref["initial"]
        change = lambda now, before, keys: {  # noqa: E731
            k: now[k] - before[k] for k in keys}
        statistics = sorted(ref["state"])
        leaves = {
            "grad_gap": leaf_gaps(end["mu"], ref["mu"], kept),
            "change_gap": leaf_gaps(
                change(end["params"], start["params"], kept),
                change(ref["params"], start["params"], kept), kept),
            "state_gap": leaf_gaps(
                change(end["state"], start["state"], statistics),
                change(ref["state"], start["state"], statistics),
                statistics),
        }
        gaps = {"eval_gap": abs(epoch["eval_lower_bound"] - evaluated)
                / abs(evaluated),
                **{name: max(v.values()) for name, v in leaves.items()}}
        for name, value in gaps.items():
            value = value if math.isfinite(value) else math.inf
            if value > out[name] or (value == out[name] == math.inf):
                out[name] = value
                if worst is not None and name in leaves:
                    leaf = max(leaves[name], key=leaves[name].get)
                    worst[name] = f"{leaf}, epoch {epoch['epoch']}"
        out["steps_gap"] += float(abs(end["count"] - ref["count"]))
    return out


def as_program(model, spec: dict, counts: torch.Tensor, seed: int,
               batch: int, *, precision: str, eval_precision: str,
               fault: str | None = None) -> list[dict]:
    """The reference put in the program's place: its first two epochs in
    ``precision`` (with a planted ``fault``), each evaluated in
    ``eval_precision``, as the harness hands the program's over (the first
    and the last).  The fault "training_mean" alters the evaluation's
    answer where it is produced: it reports the mean lower bound of the
    epoch's training steps in place of the whole set's evaluation."""
    runs, start = [], None
    for epoch in range(2):
        run = reference.train_epoch(
            model, spec, counts, seed, batch, epoch=epoch, start=start,
            learning_rate=spec["learning_rate"], precision=precision,
            fault=fault)
        lower_bound = (
            run["train_lower_bound"] if fault == "training_mean" else
            reference.evaluate(model, spec, run["params"], run["state"],
                               counts, seed, epoch, batch,
                               precision=eval_precision))
        runs.append({"epoch": epoch, "start": start, "end": run,
                     "eval_lower_bound": lower_bound})
        start = run
    return runs


def verdict(values: dict, limits: dict) -> bool:
    """True when every number is at or under its limit."""
    return all(values[name] <= limits[name] for name in NUMBERS)
