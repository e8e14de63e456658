"""Cells, configurations, traffic mixes and metrics are found by name, and
one more of each is added by adding files and entries only."""

import json
import shutil

import pytest

from portbench.harness import run_cell
from portbench.spec import ROOT, Benchmark

TINY = {"config": {"feature_size": 24, "hidden_sizes": [12, 12],
                   "latent_size": 3, "precision": "float32"},
        "traffic": {"cells": 230, "genes": 24, "minibatch_size": 40}}


def test_every_cell_resolves():
    bench = Benchmark()
    for cell in bench.data["workloads"]:
        traffic = bench.traffic(cell["traffic"])
        config = bench.sizes(cell["config"], traffic)
        assert config["feature_size"] == traffic["genes"]
        assert set(bench.limits(cell["name"])) == {
            "eval_gap", "grad_gap", "change_gap", "state_gap", "steps_gap"}
        reference = bench.reference(cell["config"])
        params, _ = reference.init(config, 1)
        assert params
        for key in ("end_to_end", "per_layer"):
            for metric in bench.metrics(cell["name"], key):
                reader = bench.reader(metric["name"])
                assert callable(reader.read)
                moves = reader.MOVES
                assert moves == metric.get("moves", metric["name"])
    with pytest.raises(KeyError):
        bench.workload("no_such_cell")


def test_a_cell_added_as_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(f"{ROOT}/portbench", root / "portbench")
    shutil.copy(f"{ROOT}/BENCHMARK.json", root / "BENCHMARK.json")
    here = root / "portbench"
    config = json.loads((here / "configs" / "vae_nb.json").read_text())
    config.update(TINY["config"])
    (here / "configs" / "vae_tiny.json").write_text(json.dumps(config))
    shutil.copy(here / "configs" / "vae_nb.py",
                here / "configs" / "vae_tiny.py")
    traffic = {**json.loads((here / "traffic" / "pbmc68k.b100.json")
                            .read_text()), **TINY["traffic"]}
    (here / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (here / "limits" / "vae_tiny.tiny.json").write_text(
        (here / "limits" / "vae_nb.pbmc68k.b100.json").read_text())
    (here / "metrics" / "epochs.window.py").write_text(
        'MOVES = "train_cells_per_s"\n\n\ndef read(run):\n'
        '    return float(run.window_epochs)\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vae_tiny", "source": "test",
                             "file": "portbench/configs/vae_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "vae_tiny.tiny", "config": "vae_tiny",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "epochs.window", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "train_cells_per_s",
                               "workloads": ["vae_tiny.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    added = Benchmark(str(root))
    assert added.workload("vae_tiny.tiny")["traffic"] == "tiny"
    assert added.traffic("tiny")["cells"] == 230
    assert [m["name"] for m in added.metrics("vae_tiny.tiny", "per_layer")] \
        == ["epochs.window"]
    assert added.reader("epochs.window").read(
        type("Run", (), {"window_epochs": 3})) == 3.0
    result = run_cell("vae_tiny.tiny", 2**31 + 9, 0.0, False, device="cpu",
                      benchmark=added)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 230 // 40
