#!/usr/bin/env python3
"""Time K1's launch shapes at the headline gather on one GPU, in three
states of the L2 cache.

    python3 tools/gather_sweep.py

B = 2,048 rows of a 68,579 x 2,048 int16 count matrix (random counts,
seed 0) to bf16, as every training step gathers them.  Each launch shape of
``ops/csrc/gather.cu`` below (its path and grid; every result checked bit
for bit against ``index_select`` + ``.to``) and two PyTorch yardsticks:
``index_select`` + ``.to``, and the contiguous cast ``.to(bf16)`` of 2,048
rows, the same bytes without the gather.  States of
the L2 cache before each launch: "dirty" (96 MB written, as
``chip_smoke.time_ms`` flushes, so the launch's misses also write back
dirty lines), "clean" (96 MB read) and "none" (what the last launch left).
Median device time of 50 launches (CUDA events, the device held while the
host queues the call).  Prints the card's name and power limit and one JSON
line of times in ms.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from scvae_tpu_torch.ops import extension, gather

    extension.load_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    counts = torch.randint(0, 5, (cs.N_CELLS, cs.N_GENES), generator=gen,
                           device=dev).to(torch.int16)
    idx = torch.randperm(cs.N_CELLS, generator=gen, device=dev)[
        :cs.BATCH].to(torch.int32)
    b, f = cs.BATCH, cs.N_GENES
    want = counts.index_select(0, idx).to(torch.bfloat16)
    out = torch.empty_like(want)

    def time_state(fn, state, reps=50):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            if state == "dirty":
                flush.zero_()
            elif state == "clean":
                flush.sum(dtype=torch.int32)
            torch.cuda._sleep(cs.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    planned = gather.gather_plan(b, f, True)
    shapes = {f"vector as planned (grid {planned['grid']})": planned}
    for grid in (132, 264, 1056):
        shapes[f"vector grid {grid}"] = dict(planned, grid=grid)
    shapes["element (grid 2,112)"] = dict(gather.gather_plan(b, f, False),
                                          grid=2112)
    calls = {}
    for label, plan in shapes.items():
        out.zero_()
        gather.launch(counts, idx, out, plan)
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: not bit-exact")
        calls[label] = lambda plan=plan: gather.launch(counts, idx, out, plan)
    rows = counts[:b].contiguous()
    calls["index_select + .to"] = (
        lambda: counts.index_select(0, idx).to(torch.bfloat16))
    calls["contiguous .to(bf16) of the same bytes"] = (
        lambda: rows.to(torch.bfloat16))
    ms = {label: {state: time_state(fn, state)
                  for state in ("dirty", "clean", "none")}
          for label, fn in calls.items()}
    bound, by = cs.bound(b * f * 4 + b * 4, 0.0, cs.BF16_FLOPS)
    print(cs.card_line(), flush=True)
    print(json.dumps({"bound_ms": bound, "bound_by": by, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
