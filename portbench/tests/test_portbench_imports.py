"""What the benchmark loads: nothing under ``portbench/`` loads JAX or the
JAX package, and its reference side loads nothing of the port.  Module
names are compared by their top-level name, whole: the port's name begins
with the JAX package's."""

import json
import os
import subprocess
import sys

from portbench.spec import ROOT, Benchmark

REFERENCE_SIDE = ["portbench.plain", "portbench.reference", "portbench.check",
                  "portbench.counts", "portbench.roofline", "portbench.trace",
                  "portbench.spec", "portbench.control",
                  "portbench.configs.vae_nb"]
HARNESS_SIDE = REFERENCE_SIDE + ["portbench.harness"]


def _loaded(modules: list[str], metrics: bool) -> set[str]:
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for name in {modules!r}:\n"
        "    __import__(name)\n"
        "if " + repr(metrics) + ":\n"
        "    from portbench.spec import Benchmark\n"
        "    bench = Benchmark()\n"
        "    for key in ('end_to_end', 'per_layer'):\n"
        "        for m in bench.data[key]:\n"
        "            bench.reader(m['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package():
    loaded = _loaded(HARNESS_SIDE, metrics=True)
    assert "scvae_tpu_torch" in loaded  # the program is loaded, whole name
    assert not loaded & {"jax", "jaxlib", "flax", "scvae_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(REFERENCE_SIDE, metrics=False)
    assert "torch" in loaded
    assert not loaded & {"scvae_tpu_torch", "scvae_tpu", "jax", "jaxlib"}


def test_every_metric_file_is_named_in_the_benchmark():
    bench = Benchmark()
    named = {m["name"] for key in ("end_to_end", "per_layer")
             for m in bench.data[key]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == named
