"""The readings that a cell's correctness limits are set from, at the
cell's own size, on the card:

    python3 portbench/control.py --workload NAME --program-seeds S ... \\
        --control-seeds S ...

For each program seed, one run of the program through the harness, with a
window of ``--seconds`` (0, the default: its first epoch and one more), and
the numbers of its check.  For each control seed, the reference put in
the program's place for two epochs, and the same numbers: ``control``
computes its epochs with fp8 matmul operands (the precision below the bf16
operands the configurations state) and its evaluations in TF32 (the
precision below the float32 they state for them); ``tf32_evaluation``
trains with the stated bf16 operands and evaluates in TF32, the
evaluation's lower precision by itself; ``half_batch`` trains each step
on half of its rows; ``training_mean`` alters the evaluation's answer
where it is produced, reporting the mean lower bound of the epoch's
training steps in its place; ``statistics_unchanged`` never updates the
batch-norm statistics.  A step that leaves the state unchanged reads 1 by
the check's measure and needs no run.  One JSON line a reading on standard output.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import check  # noqa: E402
from portbench.counts import make_counts  # noqa: E402
from portbench.spec import Benchmark  # noqa: E402

PLANTED = {
    "control": {"precision": "fp8", "eval_precision": "tf32"},
    "tf32_evaluation": {"precision": "bfloat16", "eval_precision": "tf32"},
    "half_batch": {"precision": "bfloat16", "eval_precision": "float32",
                   "fault": "half_batch"},
    "training_mean": {"precision": "bfloat16", "eval_precision": "float32",
                      "fault": "training_mean"},
    "statistics_unchanged": {"precision": "bfloat16",
                             "eval_precision": "float32",
                             "fault": "statistics_unchanged"},
}


def control_readings(benchmark: Benchmark, workload: str, seed: int,
                     device: str = "cuda", overrides: dict | None = None,
                     kinds=tuple(PLANTED)) -> dict[str, dict]:
    """{kind: the check's numbers} of the reference in the program's place
    on one seed."""
    overrides = overrides or {}
    cell = benchmark.workload(workload)
    traffic = {**benchmark.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    config = {**benchmark.sizes(cell["config"], traffic),
              **overrides.get("config", {})}
    model = benchmark.reference(cell["config"])
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = torch.from_numpy(make_counts(
        traffic["cells"], traffic["genes"], traffic["density"],
        traffic["mean"], seed, device)).to(device)
    batch = traffic["minibatch_size"]
    ref = check.follow(model, config, counts, seed, batch,
                       {"epoch": 0, "start": None})
    out = {}
    for kind in kinds:
        planted = check.as_program(model, config, counts, seed, batch,
                                   **PLANTED[kind])
        worst: dict[str, str] = {}
        out[kind] = check.numbers(model, config, counts, seed, batch,
                                  planted, first_ref=ref, worst=worst)
        print(f"{kind} seed {seed}: worst leaves {worst}", file=sys.stderr)
    return out


def main() -> int:
    import argparse

    from portbench.harness import run_cell

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--kinds", nargs="*", default=list(PLANTED),
                        choices=list(PLANTED))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device; found none", file=sys.stderr)
        return 2
    benchmark = Benchmark()
    for seed in args.program_seeds:
        started = time.perf_counter()
        result = run_cell(args.workload, seed, args.seconds, False,
                          benchmark=benchmark)
        print(json.dumps({"workload": args.workload, "kind": "program",
                          "seed": seed,
                          "numbers": {k: v["value"] for k, v in
                                      result["checks"].items()},
                          "seconds": time.perf_counter() - started}),
              flush=True)
        # a run's tensors sit in reference cycles (the stopped ``train``'s
        # frames) until a collection: free them before the next staging
        del result
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        started = time.perf_counter()
        for kind, numbers in control_readings(benchmark, args.workload, seed,
                                              kinds=args.kinds).items():
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - started}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
