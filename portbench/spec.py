"""Finding a cell's parts by name, from ``BENCHMARK.json`` and the files
beside it: nothing here knows a cell, a configuration, a traffic mix or a
metric.

* a configuration: ``BENCHMARK.json``'s entry, the file it names (the
  model's sizes and options; the genes come with the traffic's data set),
  and its plain reference, the Python file of
  the same name beside it (``configs/vae_nb.json`` → ``configs/vae_nb.py``);
* a traffic mix: ``traffic/<name>.json`` (the data set's shape, the counts'
  law, the minibatch);
* a cell's correctness limits: ``limits/<workload>.json``;
* a metric's reader: ``metrics/<name>.py``, with ``MOVES`` (the end-to-end
  metric it should move) and ``read(run)`` (the value, or None when the
  run holds nothing to read it from).

Every path is under ``root``, the checkout (the parent of this package).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.basename(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    if name in sys.modules:
        return sys.modules[name]
    loader = importlib.util.spec_from_file_location(name, path)
    if loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(loader)
    sys.modules[name] = module
    loader.loader.exec_module(module)
    return module


def _unique(label: str, path: str) -> str:
    """A module name for a file loaded by path: one per file."""
    return (f"{PACKAGE}_{label.replace('.', '_')}_"
            f"{abs(hash(os.path.abspath(path))):x}")


class Benchmark:
    """``BENCHMARK.json`` under ``root`` and the files it leads to."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def _here(self, *parts: str) -> str:
        return os.path.join(self.root, PACKAGE, *parts)

    def workload(self, name: str) -> dict:
        for entry in self.data["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> tuple[dict, dict]:
        """(the configuration's entry, its file's contents)."""
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return entry, _json(os.path.join(self.root, entry["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def sizes(self, name: str, traffic: dict) -> dict:
        """The configuration as a cell runs it: its file's keys, and the
        traffic's data set's genes as its ``feature_size`` (scVAE's input
        width is the data set's)."""
        _, config = self.config(name)
        return {**config, "feature_size": traffic["genes"]}

    def reference(self, name: str) -> ModuleType:
        """The configuration's plain reference, beside its file."""
        entry, _ = self.config(name)
        path = os.path.splitext(os.path.join(self.root, entry["file"]))[0]
        return _module(path + ".py", _unique(f"reference_{name}", path))

    def traffic(self, name: str) -> dict:
        return _json(self._here("traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return _json(self._here("limits", f"{workload}.json"))

    def metrics(self, workload: str, key: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
        return [m for m in self.data[key]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        path = self._here("metrics", f"{metric}.py")
        return _module(path, _unique(f"metric_{metric}", path))
