#!/usr/bin/env python3
"""Read the error of the float32 K2/K3 on split-bf16 products against the
number of bf16 terms, from plain versions.

    python3 tools/f32_split_precision.py [--seeds 0 1 2]
        [--designs 1/1/1 2/2/2 3/3/2 3/3/3] [--families ...]
        [--device cpu|cuda] [--out PATH]

``--families`` takes base families by name or counter prefix ("nb"),
categorised instances as "cat_<prefix>:K" (``cat_zinb:10``: ZINB with K =
10, 14 heads; ``cat_poisson:30``: 32 heads) and the constrained Poisson as
"cp"; by default the four bases.

The float32 K2/K3 (``ops/csrc/count_likelihood_tc.cu`` and
``categorised_likelihood_tc.cu``) and the constrained Poisson's float32
K6/K7 (``cp_likelihood_tc.cu``), then the products of ``tc_product.cu``,
multiply float32 h, W and da as sums of bf16 terms
(``fused_likelihood.split_bf16``).  A design "A/B/C" here splits h into A
terms and W into B for the activations, and da into C terms for the dh and
dW products (whose h and W take min(A, C) and min(B, C) terms); a product
of an x in X terms by a y in Y terms takes the pairs (i, j) with i < X,
j < Y and i + j < max(X, Y), summed in float32.  For each seed, family and
design this computes the row sums of ll, dh, dW and db of the design and
reads them as the kernel checks do: the max abs error over the largest
|value| of the float32 plain versions (``reference_forward``,
``reference_backward``; categorised: ``reference_categorised_forward``,
``_dh`` and ``_dw``, the classes' dW and db stacked, the class softmax of
both from the float32 plain forward's lse; the constrained Poisson:
``reference_cp_forward``'s ll and lse, ``reference_cp_dh`` and ``_dw``,
each side's backward from its own lse), whose limit there is 2e-5.
The float32 plain versions' own error against float64 is read beside
them.

Two cases, made with numpy from the seed: "headline", the shape of
``chip_smoke.py`` (2,048 rows, decoder width 256, 2,048 genes, h ReLU of
N(0, 1), Glorot-uniform heads, biases 0.1·N(0, 1), counts of ~7% density,
Poisson(3) + 1 where nonzero, row cotangents N(0, 1) / 2,048); and
"steep", the odd shapes of ``tests/test_torch_cuda.py`` (64 rows over 32
target rows, width 256, 100 genes; heads three times Glorot, biases
0.3·N(0, 1), Poisson(2) counts, cotangents N(0, 1)), where the activations
reach the exponentials' clip and every error in a grows by the
exponential; for the constrained Poisson, whose softmax over the genes has
no clip, "steep" is a wide spread of a across each row's genes (a of
standard deviation about 2.5: the largest gene of a row sits some 8 above
its mean, and exp(a − lse) spans many binades).  The constrained Poisson
takes one head and count sums n = Σt of each row's targets.  A
categorised instance adds K + 1 class heads (the same
scales) and targets as ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
make them: headline, every other row drawn as Poisson(K); steep,
Poisson(K) with every other row a third of that.  The products here sum
in float32, not in the tensor cores:
the kernels' own summation is held by the card's checks.  Prints one line
per case, seed, family and design, and writes every reading as JSON to
``--out`` (default ``build/f32_split_precision.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 2e-5
CASES = {  # rows, target rows, width, genes, head scale, bias scale
    "headline": (2_048, 2_048, 256, 2_048, 1.0, 0.1),
    "steep": (64, 32, 256, 100, 3.0, 0.3),
}


CP = "constrained poisson"


def parse_family(spec: str) -> tuple[str, int]:
    """(family name, K) of a ``--families`` entry; K = 0 for a base or the
    constrained Poisson."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    prefixes = {fam.prefix: name for name, fam in fl.FAMILIES.items()}
    prefixes["cp"] = CP
    if spec.startswith("cat_"):
        prefix, k = spec[len("cat_"):].split(":")
        return prefixes[prefix], int(k)
    return prefixes.get(spec, spec), 0


def inputs(case: str, name: str, k_max: int, seed: int,
           device: torch.device):
    """h, every head's W and b (the base heads, then K + 1 class heads),
    targets and row cotangents."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    m, m_t, hidden, f, scale, bias = CASES[case]
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.standard_normal((m, hidden)), 0.0)
    limit = scale * (6.0 / (hidden + f)) ** 0.5
    k = (1 if name == CP else len(fl.FAMILIES[name].heads)) + (
        k_max + 1 if k_max else 0)
    ws = [rng.uniform(-limit, limit, (hidden, f)) for _ in range(k)]
    bs = [bias * rng.standard_normal(f) for _ in range(k)]
    if case == "headline":
        t = np.zeros((m_t, f))
        per_row = int(f * 0.07)
        rows = np.repeat(np.arange(m_t), per_row)
        cols = rng.randint(0, f, size=rows.shape[0])
        t[rows, cols] = rng.poisson(3.0, size=rows.shape[0]) + 1.0
        if k_max:
            t[1::2] = rng.poisson(float(k_max), t[1::2].shape)
        g = rng.standard_normal(m) / m
    else:
        t = rng.poisson(float(k_max) if k_max else 2.0, (m_t, f))
        if k_max:
            t[1::2] = np.floor(t[1::2] / 3)
        g = rng.standard_normal(m)

    def tensor(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return (tensor(h), [tensor(w) for w in ws], [tensor(b) for b in bs],
            tensor(t), tensor(g))


def split(x, terms: int) -> list[torch.Tensor]:
    """``terms`` bf16 terms of x as float32 tensors (``split_bf16``)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    return [y.float() for y in fl.split_bf16(x, terms)]


def product(x_terms, y_terms, mm):
    """Σ mm(x_i, y_j) over the pairs i + j < max(X, Y), by i then j."""
    n = max(len(x_terms), len(y_terms))
    out = 0.0
    for i, x in enumerate(x_terms):
        for j, y in enumerate(y_terms):
            if i + j < n:
                out = out + mm(x, y)
    return out


def count_sums(h, t):
    """The constrained Poisson's n: Σt of each row's (cycled) targets."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    return fl._cycle_rows(t, h.shape[0]).sum(-1)


def plain_outputs(name, k_max, h, ws, bs, t, g):
    """The float32 plain versions' ll row sums, dh, dW and db (categorised:
    the classes' dW and db stacked; the constrained Poisson: lse after ll),
    and the row sums in float64."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    if name == CP:
        args = (ws[0], bs[0], t)
        n = count_sums(h, t)
        ll, lse = fl.reference_cp_forward(h, *args, n)
        a = h.double() @ ws[0].double() + bs[0].double()  # the plain
        # version computes in float32 whatever it is given
        exact = fl._constrained_poisson_ll_rows(
            a, fl._cycle_rows(t.double(), h.shape[0]), n.double()[:, None])
        return [ll, lse, fl.reference_cp_dh(g, h, *args, lse),
                *fl.reference_cp_dw(g, h, *args, lse)], exact

    if not k_max:
        exact = fl.reference_forward(
            name, h.double(), [w.double() for w in ws],
            [b.double() for b in bs], t.double())
        return [fl.reference_forward(name, h, ws, bs, t),
                *fl.reference_backward(name, g, h, ws, bs, t)], exact
    n_base = len(fl.FAMILIES[name].heads)
    heads = (ws[:n_base], bs[:n_base], torch.stack(ws[n_base:]),
             torch.stack(bs[n_base:]), t)
    ll, lse = fl.reference_categorised_forward(name, h, *heads)
    exact, _ = fl.reference_categorised_forward(
        name, h.double(), *([x.double() for x in part] for part in heads[:2]),
        *(x.double() for x in heads[2:]))
    return [ll, fl.reference_categorised_dh(name, g, h, *heads, lse),
            *fl.reference_categorised_dw(name, g, h, *heads, lse)], exact


def design_outputs(name, k_max, h, ws, bs, t, g, h_terms, w_terms,
                   da_terms):
    """ll row sums, dh, dW and db of one design, every product in float32
    (categorised: the classes' dW and db stacked, their softmax from the
    design's own lse)."""
    from scvae_tpu_torch.ops import fused_likelihood as fl

    tt = fl._cycle_rows(t, h.shape[0])
    hs = split(h, h_terms)
    acts = [product(hs, split(w, w_terms), lambda x, y: x @ y) + b
            for w, b in zip(ws, bs)]
    hp = hs[:min(h_terms, da_terms)]
    if name == CP:
        (a,), (w,) = acts, ws
        n = count_sums(h, t)
        lse = torch.logsumexp(a, -1)
        ll = fl._constrained_poisson_ll_rows(a, tt, n[:, None])
        da = g[:, None] * (tt - tt.sum(-1, keepdim=True)
                           * torch.exp(a - lse[:, None]))
        d_terms = split(da, da_terms)
        wp = split(w, min(w_terms, da_terms))
        return [ll, lse, product(d_terms, wp, lambda x, y: x @ y.T),
                product(hp, d_terms, lambda x, y: x.T @ y), da.sum(0)]
    fam = fl.FAMILIES[name]
    n_base = len(fam.heads)
    if k_max:
        ll, lse = fl._categorised_ll_lse(name, acts[:n_base], acts[n_base:],
                                         tt)
        gs = fl.categorised_grads(name, k_max)(acts, tt, lse)
    else:
        ll = fam.ll(*acts, tt) - fl.lgamma(1.0 + tt)
        gs = fam.grads(*acts, tt)
    das = [gr * g[:, None] for gr in gs]
    dh, grads = 0.0, []
    for w, da in zip(ws, das):
        d_terms = split(da, da_terms)
        wp = split(w, min(w_terms, da_terms))
        dh = dh + product(d_terms, wp, lambda x, y: x @ y.T)
        grads.append((product(hp, d_terms, lambda x, y: x.T @ y), da.sum(0)))
    base = [x for pair in grads[:n_base] for x in pair]
    classes = ([torch.stack([dw for dw, _ in grads[n_base:]]),
                torch.stack([db for _, db in grads[n_base:]])]
               if k_max else [])
    return [ll.sum(-1), dh, *base, *classes]


def relative(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--designs", nargs="+",
                        default=["1/1/1", "2/2/2", "3/3/2", "3/3/3"])
    parser.add_argument("--families", nargs="+", default=None)
    parser.add_argument("--cases", nargs="+", default=list(CASES))
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "f32_split_precision.json"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from scvae_tpu_torch.ops import fused_likelihood as fl

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    families = args.families or list(fl.FAMILIES)
    readings = []
    for case in args.cases:
        for seed in args.seeds:
            for spec in families:
                name, k_max = parse_family(spec)
                h, ws, bs, t, g = inputs(case, name, k_max, seed, device)
                plain, exact = plain_outputs(name, k_max, h, ws, bs, t, g)
                floor = relative(plain[0], exact)
                if name == CP:
                    parts = ["ll", "lse", "dh", "dW", "db"]
                else:
                    parts = ["ll", "dh"] + [
                        f"{p}_{head}" for head in fl.FAMILIES[name].heads
                        for p in ("dW", "db")]
                if k_max:
                    parts += ["dW_classes", "db_classes"]
                label = f"{name} K={k_max}" if k_max else name
                for design in args.designs:
                    terms = [int(x) for x in design.split("/")]
                    got = design_outputs(name, k_max, h, ws, bs, t, g,
                                         *terms)
                    errs = {p: relative(a, b)
                            for p, a, b in zip(parts, got, plain,
                                               strict=True)}
                    worst = max(errs.values())
                    readings.append({
                        "case": case, "seed": seed, "family": label,
                        "design": design, "error": errs,
                        "ll_float32_floor": floor,
                        "within_limit": worst <= LIMIT})
                    print(f"{case} seed {seed} {label} {design}: worst "
                          f"{worst:.3g} ("
                          + ", ".join(f"{p} {v:.3g}" for p, v in errs.items())
                          + f"; float32 ll against float64 {floor:.3g}); "
                          + ("within" if worst <= LIMIT else "beyond")
                          + f" {LIMIT:g}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as out:
        json.dump({"device": str(device), "cases": CASES, "limit": LIMIT,
                   "readings": readings}, out, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
