"""The control at a size a test run holds: the reference in the program's
place with fp8 operands (its evaluation in TF32), with half of each batch
left out, with its evaluation's answer replaced by the training steps'
mean and with the batch-norm statistics never updated, fails the cell's
limits; the reference in float32 in the program's place passes them."""

import pytest

from portbench import check
from portbench.control import PLANTED, control_readings
from portbench.spec import Benchmark

SIZES = {"hidden_sizes": [32], "latent_size": 2}
CELLS = {
    "vae_nb.brain1m3.b2048": ({"cells": 1240, "genes": 64}, 100),
    "vae_nb.pbmc68k.b100": ({"cells": 1240, "genes": 72}, 50),
}
FAILING = ("control", "half_batch", "training_mean", "statistics_unchanged")


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_fails_the_limits(workload, monkeypatch):
    traffic, batch = CELLS[workload]
    overrides = {"config": SIZES,
                 "traffic": {**traffic, "minibatch_size": batch}}
    monkeypatch.setitem(PLANTED, "float32", {"precision": "float32",
                                             "eval_precision": "float32"})
    bench = Benchmark()
    limits = bench.limits(workload)
    readings = control_readings(bench, workload, 2**31 + 23, device="cpu",
                                overrides=overrides,
                                kinds=("float32",) + FAILING)
    assert check.verdict(readings.pop("float32"), limits)
    for kind, numbers in readings.items():
        assert not check.verdict(numbers, limits), (kind, numbers)
    assert readings["statistics_unchanged"]["state_gap"] == 1.0
