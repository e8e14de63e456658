#!/usr/bin/env python3
"""Read the error of the constrained Poisson's split-bf16 products against
the number of bf16 terms, from their plain versions.

    python3 tools/cp_split_precision.py [--seeds 0 1 2] [--terms 1 2 3]
        [--device cpu|cuda] [--out PATH]

The bf16 kernels of the constrained Poisson (``ops/csrc/cp_likelihood_tc.cu``
and the products of ``tc_product.cu``) multiply float32 W and da as sums of
``fused_likelihood.CP_TERMS`` bf16 terms (``fused_likelihood.split_bf16``).
For each seed and term count this computes that design with its own split
of any number of terms (:func:`split`, ``split_bf16``'s loop): a as h times
each W term summed in term order, then b; ll and lse from a; da from a and
lse, split; dh over the pairs (da_i, W_j) with i + j < terms, dW over
each da_i once, db from the unrounded da.  It runs at the headline
shape of ``chip_smoke.py`` (2,048 rows, decoder width 256, 2,048 genes;
h with bf16 values, Glorot-uniform W, biases 0.1·N(0, 1), counts of ~7%
density, Poisson(3) + 1 where nonzero, row cotangents N(0, 1) / 2,048,
made with numpy from the seed) and reads ll, lse, dh, dW and db as the
kernel checks do: the max abs error over the largest |value| of the float32
plain versions (``reference_cp_forward``, ``reference_cp_dh``,
``reference_cp_dw``), whose limit there is 2e-5.  The backward takes each
side's own lse.  The float32 plain versions' own error, against a float64
computation, is read beside them.  The products here sum in float32, not
in the tensor cores: the kernels' own summation is held by the card's
checks.  Prints one line per seed and term count and writes every reading
as JSON to ``--out`` (default ``build/cp_split_precision.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, HIDDEN, F = 2_048, 256, 2_048
LIMIT = 2e-5
PARTS = ("ll", "lse", "dh", "dW", "db")


def inputs(seed: int, device: torch.device):
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.standard_normal((M, HIDDEN)), 0.0).astype(np.float32)
    limit = (6.0 / (HIDDEN + F)) ** 0.5
    w = rng.uniform(-limit, limit, (HIDDEN, F)).astype(np.float32)
    b = (0.1 * rng.standard_normal(F)).astype(np.float32)
    t = np.zeros((M, F), np.float32)
    per_row = int(F * 0.07)
    rows = np.repeat(np.arange(M), per_row)
    cols = rng.randint(0, F, size=rows.shape[0])
    t[rows, cols] = rng.poisson(3.0, size=rows.shape[0]) + 1.0
    g = (rng.standard_normal(M) / M).astype(np.float32)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    tensors = [torch.from_numpy(x) for x in (w, b, t, g)]
    return [hb.to(device)] + [x.to(device) for x in tensors]


def split(x, terms: int) -> list[torch.Tensor]:
    """``terms`` bf16 tensors whose float32 sum approximates x, as
    ``fused_likelihood.split_bf16`` makes CP_TERMS of them."""
    rest = x.float()
    out = [rest.to(torch.bfloat16)]
    for _ in range(terms - 1):
        rest = rest - out[-1]  # exact: float32 less its own bf16 rounding
        out.append(rest.to(torch.bfloat16))
    return out


def split_design(hb, w, b, t, g, n, terms: int) -> dict:
    """ll, lse, dh, dW and db of the split design with ``terms`` bf16 terms
    of W and of da, every product summed in float32."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    hf = hb.float()
    w_terms = [x.float() for x in split(w, terms)]
    a = 0.0
    for w_j in w_terms:
        a = a + hf @ w_j
    a = a + b
    lse = torch.logsumexp(a, dim=-1)
    da = g[:, None] * (t - t.sum(-1, keepdim=True)
                       * torch.exp(a - lse[:, None]))
    da_terms = [x.float() for x in split(da, terms)]
    dh = 0.0
    for i in range(terms):
        for j in range(terms - i):
            dh = dh + da_terms[i] @ w_terms[j].T
    return {"ll": fl._constrained_poisson_ll_rows(a, t, n[:, None]),
            "lse": lse, "dh": dh, "dW": hf.T @ sum(da_terms),
            "db": da.sum(0)}


def float64_versions(h, w, b, t, g, n) -> dict:
    """ll, lse, dh, dW and db computed in float64 (the plain versions'
    formulas; the plain versions themselves compute in float32)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    h, w, b, t, g, n = (x.double() for x in (h, w, b, t, g, n))
    a = h @ w + b
    lse = torch.logsumexp(a, dim=-1)
    da = g[:, None] * (t - t.sum(-1, keepdim=True)
                       * torch.exp(a - lse[:, None]))
    return {"ll": fl._constrained_poisson_ll_rows(a, t, n[:, None]),
            "lse": lse, "dh": da @ w.T, "dW": h.T @ da, "db": da.sum(0)}


def relative(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--terms", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "cp_split_precision.json"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from scvae_tpu_torch.ops import fused_likelihood as fl

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    readings = []
    for seed in args.seeds:
        hb, w, b, t, g = inputs(seed, device)
        n = t.sum(-1)
        hf = hb.float()
        ll, lse = fl.reference_cp_forward(hf, w, b, t, n)
        plain = {"ll": ll, "lse": lse,
                 "dh": fl.reference_cp_dh(g, hf, w, b, t, lse)}
        plain["dW"], plain["db"] = fl.reference_cp_dw(g, hf, w, b, t, lse)
        exact = float64_versions(hf, w, b, t, g, n)
        floor = {p: relative(plain[p], exact[p]) for p in PARTS}
        print(f"seed {seed}: float32 plain against float64: "
              + ", ".join(f"{p} {v:.3g}" for p, v in floor.items()),
              flush=True)
        for terms in args.terms:
            design = split_design(hb, w, b, t, g, n, terms)
            errs = {p: relative(design[p], plain[p]) for p in PARTS}
            worst = max(errs.values())
            readings.append({"seed": seed, "terms": terms,
                             "pairs": terms * (terms + 1) // 2,
                             "error": errs, "float32_floor": floor,
                             "within_limit": worst <= LIMIT})
            print(f"seed {seed}, {terms} terms: "
                  + ", ".join(f"{p} {v:.3g}" for p, v in errs.items())
                  + f" of the largest value (limit {LIMIT:g}: "
                  + ("within" if worst <= LIMIT else "beyond") + ")",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        json.dump({"device": str(device), "shape": [M, HIDDEN, F],
                   "limit": LIMIT, "readings": readings}, out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
