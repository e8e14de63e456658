"""A run of the harness, rehearsed on the CPU at a tiny size (the port in
float32 there), with the timed path sound and with it broken underneath:
``correct`` has to come out true, then false for each fault a training
cell can have (a step that leaves the state unchanged, half of each batch
left out, the evaluation's answer altered where it is produced, the
batch-norm statistics left unchanged, and half of each batch or the
evaluation's answer gone wrong only after the first epoch; one chip, so no
exchange between chips).  Without a card a run fails and prints no
result; without the program too."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import scvae_tpu_torch.models.step as step
from portbench import harness
from portbench.spec import ROOT
from scvae_tpu_torch.models.api import VariationalAutoencoder

SIZES = {"hidden_sizes": [16], "latent_size": 2, "precision": "float32"}
CELLS = {
    "vae_nb.brain1m3.b2048": {"config": SIZES, "traffic": {
        "cells": 410, "genes": 40, "minibatch_size": 64}},
    "vae_nb.pbmc68k.b100": {"config": SIZES, "traffic": {
        "cells": 330, "genes": 48, "minibatch_size": 50}},
}
SEED = 2**31 + 17


def _run(workload):
    return harness.run_cell(workload, SEED, 0.0, False, device="cpu",
                            overrides=CELLS[workload])


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert "metrics" not in result  # no device metric from a CPU run


def _unchanged(monkeypatch):
    monkeypatch.setattr(step.ClipAdam, "update_",
                        lambda self, params, grads, opt_state: None)


def _statistics_unchanged(monkeypatch):
    matching = step.matching_leaves
    monkeypatch.setattr(step, "matching_leaves",
                        lambda tree, like: matching(like, like))


def _half_batch(monkeypatch, after_steps=0):
    gather = step.gather_batch
    steps = [0]

    def halved(data, idx, **kwargs):
        batch = gather(data, idx, **kwargs)
        if "dtype_overrides" not in kwargs:  # an evaluation batch
            return batch
        steps[0] += 1
        if steps[0] <= after_steps:
            return batch
        return {k: v[:v.shape[0] // 2] for k, v in batch.items()}

    monkeypatch.setattr(step, "gather_batch", halved)


def _answer_altered(monkeypatch, after_epochs=0):
    evaluator = VariationalAutoencoder._device_evaluator
    epochs = [0]

    def altered(self, *args, **kwargs):
        evaluate = evaluator(self, *args, **kwargs)

        def wrong(*a):
            out = evaluate(*a)
            epochs[0] += 1
            if epochs[0] <= after_epochs:
                return out
            return {**out, "lower_bound": out["lower_bound"] * (1 + 1e-3)}

        return wrong

    monkeypatch.setattr(VariationalAutoencoder, "_device_evaluator", altered)


def _later_half_batch(monkeypatch):
    _half_batch(monkeypatch, after_steps=410 // 64)


def _later_answer_altered(monkeypatch):
    _answer_altered(monkeypatch, after_epochs=1)


@pytest.mark.parametrize(
    "fault", [_unchanged, _half_batch, _answer_altered,
              _statistics_unchanged, _later_half_batch,
              _later_answer_altered],
    ids=["unchanged", "half_batch", "answer_altered", "statistics_unchanged",
         "later_half_batch", "later_answer_altered"])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_broken_run_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert not result["correct"], result["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(["--workload", "vae_nb.brain1m3.b2048", "--seed",
                         "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "needs 1 CUDA device" in out.err


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "vae_nb.brain1m3.b2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
def test_traced_run_on_the_card(card):
    result = harness.run_cell(
        "vae_nb.pbmc68k.b100", SEED, 0.5, True,
        overrides={"traffic": {"cells": 6000}})
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert {"step.ms", "device.idle_share", "train_mfu"} <= set(
        result["metrics"])
    json.dumps(result)
