#!/usr/bin/env python3
"""Read the precision and time of the bf16 backward's products against the
depth that one split sums, with and without promoted sums, on one GPU.

    python3 tools/product_precision.py [--seeds 0 1 2] [--out PATH]

For each seed, the products of real gradients (the tensor-core gradient
kernels' bf16 da), with inputs made as ``chip_smoke.py`` makes them:

- Poisson-cat (K = 30, 32 heads): dh over 65,536 deep at chip_smoke.py's
  2,048 rows x 2,048 genes, and over 64,000 deep at the shape of
  ``tests/test_torch_cuda.py``'s categorised test (300 rows over 30 cycled
  targets x 2,000 genes);
- ZINB-cat (K = 10, 14 heads): dh over 28,672 deep at 2,048 rows;
- NB over GMVAE-NB's 20,480 rows (2,048 cycled targets): dW over 20,480
  deep.

Each product runs in 1, 2, 3, 4, 6 and 8 splits (planned by
``fused_likelihood.tc_splits``), with its sums kept inside the tensor cores
and promoted.  For each it reads the max abs error over the largest value
of the plain float32 product of the same bf16 operands, and the median
device time (``chip_smoke.time_ms``, L2 flushed); also the planner's own
plan.  Prints the card's name and power limit, one line per case and
seed, and writes every reading as JSON to ``--out`` (default
``build/product_precision.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "product_precision.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("product_precision: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import extension
    from scvae_tpu_torch.ops import fused_likelihood as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    extension.load_kernels()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    counts = torch.from_numpy(cs.make_counts(cs.BATCH, cs.N_GENES).toarray())
    counts = counts.to(dev, bf16)

    def categorised(gen, name, k_max, m, m_t, f):
        x = cs.categorised_targets(counts[:m_t, :f].contiguous(), k_max, gen)
        n_base = len(ops.FAMILIES[name].heads)
        h = torch.relu(torch.randn(m, cs.HIDDEN, generator=gen, device=dev))
        g = torch.randn(m, generator=gen, device=dev) / m_t
        ws, bs = cs.head_weights(gen, n_base + k_max + 1, cs.HIDDEN, f, dev)
        heads = (ws[:n_base], bs[:n_base], torch.stack(ws[n_base:]),
                 torch.stack(bs[n_base:]), x)
        _, lse = ops.categorised_forward(name, h, *heads, compute_dtype=bf16)
        return fl.cat_tc_gradient(name, g, h, *heads, lse)

    def cycled(gen):
        m = cs.CLUSTERS * cs.BATCH
        h = torch.relu(torch.randn(m, cs.HIDDEN, generator=gen, device=dev))
        g = torch.randn(m, generator=gen, device=dev) / cs.BATCH
        ws, bs = cs.head_weights(gen, 2, cs.HIDDEN, cs.N_GENES, dev)
        return fl.tc_gradient("negative binomial", g, h, ws, bs, counts)

    dh = ("dh_splits", fl.tc_dh, fl.reference_tc_dh, 1)
    dw = ("dw_splits", lambda grad: fl.tc_dw_stacked(grad)[0],
          lambda grad: fl.reference_tc_dw_stacked(grad)[0], 0)
    cases = {
        "Poisson-cat dh, 2,048 rows": (
            lambda gen: categorised(gen, "poisson", 30, cs.BATCH, cs.BATCH,
                                    cs.N_GENES), dh),
        "Poisson-cat dh, 300 rows over 30 targets, F = 2,000": (
            lambda gen: categorised(gen, "poisson", 30, 300, 30, 2000), dh),
        "ZINB-cat dh, 2,048 rows": (
            lambda gen: categorised(gen, "zero-inflated negative binomial",
                                    10, cs.BATCH, cs.BATCH, cs.N_GENES), dh),
        "NB dW, 20,480 rows": (cycled, dw),
    }
    print(cs.card_line(), flush=True)
    readings = []
    for label, (make, (key, product, plain, depth_axis)) in cases.items():
        for seed in args.seeds:
            grad = make(torch.Generator(device=dev).manual_seed(seed))
            want = plain(grad)
            scale = float(want.abs().max())

            def read(swept):
                splits, per, promote = swept.plan[key]
                return {"splits": splits,
                        "depth": per * fl.TC_PRODUCT_DEPTH,
                        "promote": promote,
                        "err": cs.max_err(product(swept), want) / scale,
                        "ms": cs.time_ms(lambda: product(swept), reps=10,
                                         flush=flush)}

            variants = [read(cs.forced_splits(grad, splits, promote))
                        for promote in (False, True) for splits in SPLITS]
            row = {"case": label, "seed": seed,
                   "depth": grad.da.shape[depth_axis],
                   "planned": read(grad), "variants": variants}
            readings.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        json.dump({"card": cs.card_line(), "readings": readings}, out,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
