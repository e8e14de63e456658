#!/usr/bin/env python3
"""Phase 3's grouped checks and times alone, on one GPU.

    python3 tools/grouped_checks.py

Builds the kernels, then runs ``chip_smoke.check_grouped`` for every base
family at the GMVAE's shapes (G = 10 groups of 2,048 rows, decoder width
256, with its times; then the cap G = 16): K4 and K5 in bf16 and float32
kernel by kernel against their plain versions, timed beside the flat
kernels over the same rows, with the float32 gradient kernel's sweep of W
slots.  The inputs are made as ``chip_smoke.py`` makes them, from seed 0.
Prints each family's seconds, the card's name and power limit, and one
JSON line of the kernels' times; fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_checks: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, REPO)
    from scvae_tpu_torch.ops import extension

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    extension.load_kernels()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    x = torch.from_numpy(cs.make_counts(cs.BATCH, cs.N_GENES).toarray()).to(
        dev, torch.bfloat16)
    results = {}
    for name in cs.BASE_FAMILIES:
        start = time.perf_counter()
        results.update(cs.check_grouped(name, x, gen, flush, cs.CLUSTERS))
        middle = time.perf_counter()
        cs.check_grouped(name, x, gen, flush, cs.GROUP_CAP)
        print(f"{name}: G={cs.CLUSTERS} {middle - start:.1f} s, "
              f"G={cs.GROUP_CAP} {time.perf_counter() - middle:.1f} s",
              flush=True)
    print(cs.card_line(), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
