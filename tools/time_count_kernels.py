#!/usr/bin/env python3
"""Time the likelihood kernels of a checkout of the port on one GPU.

    python3 tools/time_count_kernels.py [ROOT]

Imports ``scvae_tpu_torch`` from ROOT (default: this checkout), builds its
kernels there, and times with ``chip_smoke.time_ms`` of this checkout (the
device held while the host queues each call, the L2 cache flushed before
each):

- the public calls of NB's bf16 fused likelihood at the headline VAE's
  shapes (2,048 rows, decoder width 256, 2,048 genes) and over GMVAE-NB's
  20,480 decoder rows against 2,048 cycled target rows: ``fused_forward``,
  and ``fused_backward``, and the backward's bare products ``tc_dh`` /
  ``tc_dw`` of one gradient;
- the bf16 categorised forward ``categorised_forward`` and backward at the
  headline shapes for VAE-ZINB-cat (K = 10, 14 heads) and VAE-Poisson-cat
  (K = 30, 32 heads), the backward from the forward's lse:
  ``categorised_backward`` where the checkout has it, else its two passes
  ``categorised_backward_dh`` and ``categorised_backward_dw`` in one call;
- the constrained Poisson's K6 and K7 as the VAE-CP training step calls
  them, at the headline shapes: ``cp_forward`` of h with bf16 values (a
  bf16 tensor, which a checkout without the bf16 kernels multiplies in
  float32 on its CUDA-core kernels) against float32 W, and the backward
  from the forward's lse: ``cp_backward`` where the checkout has it, else
  ``cp_backward_dh`` and ``cp_backward_dw`` in one call;
- K1, ``gather_rows`` of 2,048 rows of the headline int16 count matrix
  (68,579 x 2,048) to bf16, as every training step calls it;
- NB's bf16 grouped backward K5 at the GMVAE's shapes (G = 10 groups of
  2,048 rows, decoder width 256) from row weights as uneven as q(y|x):
  ``grouped_backward`` where the checkout has it, else
  ``grouped_backward_dh`` and ``grouped_backward_dw`` in one call;
- every base family's grouped K4 and K5 at those shapes, bf16 and float32
  (no compute dtype): ``grouped_forward`` and ``grouped_backward``, each
  call's device time by kernel from ``torch.profiler`` (float32 alone
  with ``--float32``);
- the float32 K2/K3 of every base family at the headline shapes, as a
  VAE trained with ``precision="float32"`` calls them: ``fused_forward``
  and ``fused_backward`` with no compute dtype; and of the categorised
  instances of VAE-ZINB-cat and VAE-Poisson-cat likewise:
  ``categorised_forward`` and ``categorised_backward`` (from the forward's
  lse) with no compute dtype; and the constrained Poisson's as a VAE-CP
  trained with ``precision="float32"`` calls them: ``cp_forward`` of
  float32 h and ``cp_backward`` from its lse; each call's device time by
  kernel from ``torch.profiler`` (alone with ``--float32``).

The inputs are made as ``chip_smoke.py`` makes them, from seed 0.  Prints
the card's name and power limit and one JSON line of times in ms.

To compare two checkouts, run it on each in one call, in the order parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_bf16(cs, ops, fl, x, gen, flush) -> dict:
    """The bf16 calls, K1 and CP's (see the module docstring)."""
    name, bf16, dev = "negative binomial", torch.bfloat16, x.device
    times = {}
    for rows, reps in ((cs.BATCH, 25), (cs.CLUSTERS * cs.BATCH, 10)):
        h = torch.relu(torch.randn(rows, cs.HIDDEN, generator=gen, device=dev))
        g = torch.randn(rows, generator=gen, device=dev) / cs.BATCH
        ws, bs = cs.head_weights(gen, 2, cs.HIDDEN, cs.N_GENES, dev)
        args = (name, h, ws, bs, x)
        bwd = (name, g, h, ws, bs, x)
        calls = {
            "fused_forward": lambda: ops.fused_forward(
                *args, compute_dtype=bf16, include_lgamma_const=False),
            "fused_backward": lambda: ops.fused_backward(
                *bwd, compute_dtype=bf16),
        }
        grad = fl.tc_gradient(*bwd)
        calls["tc_dh"] = lambda: fl.tc_dh(grad)
        calls["tc_dw"] = lambda: fl.tc_dw(grad)
        times[rows] = {label: cs.time_ms(fn, reps=reps, flush=flush)
                       for label, fn in calls.items()}

    h = torch.relu(torch.randn(cs.BATCH, cs.HIDDEN, generator=gen,
                               device=dev))
    g = torch.randn(cs.BATCH, generator=gen, device=dev) / cs.BATCH
    categorised, categorised_forward = {}, {}
    for name, k_max in cs.CATEGORISED:
        t = cs.categorised_targets(x, k_max, gen)
        n_base = len(ops.FAMILIES[name].heads)
        ws, bs = cs.head_weights(gen, n_base + k_max + 1, cs.HIDDEN,
                                 cs.N_GENES, dev)
        heads = (ws[:n_base], bs[:n_base], torch.stack(ws[n_base:]),
                 torch.stack(bs[n_base:]), t)

        def forward(name=name, heads=heads):
            return ops.categorised_forward(name, h, *heads,
                                           compute_dtype=bf16)

        categorised_forward[f"{name} K={k_max}"] = cs.time_ms(
            forward, reps=10, flush=flush)
        _, lse = forward()
        args = (name, g, h, *heads, lse)
        if hasattr(ops, "categorised_backward"):
            def backward(args=args):
                return ops.categorised_backward(*args, compute_dtype=bf16)
        else:
            def backward(args=args):
                return (ops.categorised_backward_dh(*args, compute_dtype=bf16),
                        *ops.categorised_backward_dw(*args,
                                                     compute_dtype=bf16))
        categorised[f"{name} K={k_max}"] = cs.time_ms(backward, reps=10,
                                                      flush=flush)
    (w,), (b,) = cs.head_weights(gen, 1, cs.HIDDEN, cs.N_GENES, dev)
    hb, n = h.to(bf16), x.float().sum(-1)
    _, lse = ops.cp_forward(hb, w, b, x, n)
    if hasattr(ops, "cp_backward"):
        def cp_backward():
            return ops.cp_backward(g, hb, w, b, x, lse)
    else:
        def cp_backward():
            return (ops.cp_backward_dh(g, hb, w, b, x, lse),
                    *ops.cp_backward_dw(g, hb, w, b, x, lse))
    constrained = {
        "cp_forward": cs.time_ms(lambda: ops.cp_forward(hb, w, b, x, n),
                                 flush=flush),
        "cp_backward": cs.time_ms(cp_backward, flush=flush),
    }

    counts = torch.from_numpy(cs.make_counts(cs.N_CELLS, cs.N_GENES)
                              .toarray().astype("int16")).to(dev)
    idx = torch.randperm(cs.N_CELLS, generator=gen, device=dev)[
        :cs.BATCH].to(torch.int32)
    gather_ms = cs.time_ms(lambda: ops.gather_rows(counts, idx, bf16),
                           flush=flush, reps=50)
    del counts
    name = "negative binomial"
    hg = torch.relu(torch.randn(cs.CLUSTERS, cs.BATCH, cs.HIDDEN,
                                generator=gen, device=dev))
    gg = torch.softmax(2 * torch.randn(cs.CLUSTERS, cs.BATCH, generator=gen,
                                       device=dev), dim=0) / cs.BATCH
    ws, bs = cs.head_weights(gen, 2, cs.HIDDEN, cs.N_GENES, dev)
    grouped_args = (name, gg, hg, ws, bs, x)
    if hasattr(ops, "grouped_backward"):
        def grouped_backward():
            return ops.grouped_backward(*grouped_args, compute_dtype=bf16)
    else:
        def grouped_backward():
            return (ops.grouped_backward_dh(*grouped_args, compute_dtype=bf16),
                    *ops.grouped_backward_dw(*grouped_args,
                                             compute_dtype=bf16))
    grouped_ms = cs.time_ms(grouped_backward, flush=flush, reps=10)
    return {"ms": times, "categorised_forward_ms": categorised_forward,
            "categorised_backward_ms": categorised,
            "constrained_poisson_ms": constrained,
            "gather_rows_ms": gather_ms, "nb_grouped_backward_ms": grouped_ms}


def kernel_ms(fn, flush, calls=10) -> dict:
    """Device time per call (ms) of each kernel that ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls with the L2 cache flushed before
    each (the flush's own kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0
                or "FillFunctor" in e.key):
            continue
        name = e.key.replace("scvae::(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        times[name] = times.get(name, 0.0) + (
            e.self_device_time_total / 1e3 / calls)
    return times


def time_float32(cs, ops, x, gen, flush) -> dict:
    """Every base family's float32 ``fused_forward`` and ``fused_backward``
    at the headline shapes, the categorised instances' float32
    ``categorised_forward`` and ``categorised_backward``, the constrained
    Poisson's float32 ``cp_forward`` and ``cp_backward``, and each call's
    device time by kernel."""
    dev = x.device
    h = torch.relu(torch.randn(cs.BATCH, cs.HIDDEN, generator=gen,
                               device=dev))
    g = torch.randn(cs.BATCH, generator=gen, device=dev) / cs.BATCH
    float32 = {}
    for name in ops.FAMILIES:
        ws, bs = cs.head_weights(gen, len(ops.FAMILIES[name].heads),
                                 cs.HIDDEN, cs.N_GENES, dev)
        args = (name, h, ws, bs, x)
        calls = {
            "fused_forward": lambda args=args: ops.fused_forward(
                *args, include_lgamma_const=False),
            "fused_backward": lambda args=args: ops.fused_backward(
                args[0], g, *args[1:]),
        }
        float32[name] = {label: cs.time_ms(fn, flush=flush)
                         for label, fn in calls.items()}
        float32[name]["kernels"] = {label: kernel_ms(fn, flush)
                                    for label, fn in calls.items()}
    for name, k_max in cs.CATEGORISED:
        t = cs.categorised_targets(x, k_max, gen)
        n_base = len(ops.FAMILIES[name].heads)
        ws, bs = cs.head_weights(gen, n_base + k_max + 1, cs.HIDDEN,
                                 cs.N_GENES, dev)
        heads = (ws[:n_base], bs[:n_base], torch.stack(ws[n_base:]),
                 torch.stack(bs[n_base:]), t)
        _, lse = ops.categorised_forward(name, h, *heads)
        calls = {
            "categorised_forward": lambda heads=heads, name=name: (
                ops.categorised_forward(name, h, *heads)),
            "categorised_backward": lambda heads=heads, name=name, lse=lse: (
                ops.categorised_backward(name, g, h, *heads, lse)),
        }
        label = f"{name} K={k_max}"
        float32[label] = {label_: cs.time_ms(fn, reps=10, flush=flush)
                          for label_, fn in calls.items()}
        float32[label]["kernels"] = {label_: kernel_ms(fn, flush)
                                     for label_, fn in calls.items()}
    (w,), (b,) = cs.head_weights(gen, 1, cs.HIDDEN, cs.N_GENES, dev)
    n = x.float().sum(-1)
    _, lse = ops.cp_forward(h, w, b, x, n)
    calls = {"cp_forward": lambda: ops.cp_forward(h, w, b, x, n),
             "cp_backward": lambda: ops.cp_backward(g, h, w, b, x, lse)}
    label = "constrained poisson"
    float32[label] = {label_: cs.time_ms(fn, flush=flush)
                      for label_, fn in calls.items()}
    float32[label]["kernels"] = {label_: kernel_ms(fn, flush)
                                 for label_, fn in calls.items()}
    return float32


def time_grouped(cs, ops, x, gen, flush, dtypes) -> dict:
    """Every base family's ``grouped_forward`` and ``grouped_backward`` at
    the GMVAE's shapes for each compute dtype of ``dtypes``, and each
    call's device time by kernel."""
    dev = x.device
    h = torch.relu(torch.randn(cs.CLUSTERS, cs.BATCH, cs.HIDDEN,
                               generator=gen, device=dev))
    g = torch.softmax(2 * torch.randn(cs.CLUSTERS, cs.BATCH, generator=gen,
                                      device=dev), dim=0) / cs.BATCH
    grouped = {}
    for name in cs.BASE_FAMILIES:
        ws, bs = cs.head_weights(gen, len(ops.FAMILIES[name].heads),
                                 cs.HIDDEN, cs.N_GENES, dev)
        for cdt in dtypes:
            kw = dict(compute_dtype=cdt)
            calls = {
                "grouped_forward": lambda ws=ws, bs=bs, kw=kw, name=name: (
                    ops.grouped_forward(name, h, ws, bs, x, **kw)),
                "grouped_backward": lambda ws=ws, bs=bs, kw=kw, name=name: (
                    ops.grouped_backward(name, g, h, ws, bs, x, **kw)),
            }
            label = f"{name} {'float32' if cdt is None else 'bf16'}"
            grouped[label] = {label_: cs.time_ms(fn, reps=10, flush=flush)
                              for label_, fn in calls.items()}
            grouped[label]["kernels"] = {label_: kernel_ms(fn, flush)
                                         for label_, fn in calls.items()}
    return grouped


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", nargs="?", default=REPO)
    parser.add_argument("--float32", action="store_true",
                        help="time only the float32 calls")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    if not torch.cuda.is_available():
        print("time_count_kernels: no CUDA device is available",
              file=sys.stderr)
        return 2
    # this checkout's timing and inputs, the other checkout's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from scvae_tpu_torch import ops
    from scvae_tpu_torch.ops import extension
    from scvae_tpu_torch.ops import fused_likelihood as fl

    if not ops.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {ops.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    extension.load_kernels()

    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    x = torch.from_numpy(cs.make_counts(cs.BATCH, cs.N_GENES).toarray()).to(
        dev, bf16)
    times = {} if args.float32 else time_bf16(cs, ops, fl, x, gen, flush)
    times["float32_ms"] = time_float32(cs, ops, x, gen, flush)
    times["grouped_ms"] = time_grouped(
        cs, ops, x, gen, flush, (None,) if args.float32 else (bf16, None))
    print(cs.card_line(), flush=True)
    print(json.dumps({"root": root, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
