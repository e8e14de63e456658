#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``scvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (a failure raises and exits non-zero):

1. card    — the GPU's name and power limit, torch and CUDA versions;
2. build   — compile the kernels of ``scvae_tpu_torch/ops/csrc`` for sm_90a;
3. kernels — every kernel of the training path against its plain PyTorch
             version on the same inputs at the headline shapes (68,579 cells ×
             2,048 genes, minibatch 2,048, decoder width 256), with its time,
             the plain version's time and the least time the card could take;
4. slice   — one training loss and its gradients on the CPU (plain versions)
             and on the GPU (kernels) from the same small input, then
             ``VariationalAutoencoder(...).train(...)`` at the headline width
             for two epochs: a finite, rising ELBO, and every kernel launched
             on every training step.

Prints the kernels JSON line, the card line and, last, the ok JSON line.
Exits non-zero without a result when no CUDA device is present or the
package is missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_CELLS, N_GENES, HIDDEN, LATENT, BATCH = 68_579, 2_048, 256, 100, 2_048
EPOCHS = 2

# Published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Tolerances of the kernel checks against the plain versions: the max abs
# error over the largest |value| of the plain output.  Forward: float32 sums
# taken in another order (reads ~2e-7).  Backward with bf16 rounding: also da
# values that the other order rounds to a neighbouring bf16 value (dW reads
# ~1.3e-4; a kernel that leaves da or h unrounded reads 1.1e-3 to 2.6e-3).
# Float32 backward against autograd, and the small step on the GPU against
# the CPU (gradients over the largest gradient of the model): summation
# order alone (reads up to 2e-6).
FORWARD_RTOL = 2e-5
BACKWARD_RTOL = 4e-4
AUTOGRAD_RTOL = 2e-5


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_counts(n_cells: int, n_genes: int, density: float = 0.07):
    """Synthetic sparse counts with PBMC-like sparsity (~93% zeros), made as
    ``bench.py`` makes them (seed 0)."""
    import scipy.sparse

    rng_np = np.random.RandomState(0)
    n_nonzero_per_row = max(1, int(n_genes * density))
    rows = np.repeat(np.arange(n_cells), n_nonzero_per_row)
    cols = rng_np.randint(0, n_genes, size=rows.shape[0])
    vals = rng_np.poisson(3.0, size=rows.shape[0]).astype(np.float32) + 1.0
    return scipy.sparse.csr_matrix(
        (vals, (rows, cols)), shape=(n_cells, n_genes)
    )


def time_ms(fn, reps=25, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    with the L2 cache flushed before each launch when ``flush`` is given."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, rtol, scale=None) -> float:
    """Max abs error of ``got`` against ``want``; fails above ``rtol`` times
    ``scale`` (by default the largest |value| of ``want``)."""
    err = max_err(got, want)
    if scale is None:
        scale = float(want.float().abs().max())
    log(f"check {name}: max abs error {err:.3g}, "
        f"{err / scale if scale else float('nan'):.3g} of {scale:.4g} "
        f"(limit {rtol:g})")
    if not np.isfinite(err) or err > rtol * scale:
        raise AssertionError(
            f"{name}: max abs error {err} exceeds {rtol} x {scale}"
        )
    return err


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


GRAD_NAMES = ("dh", "dW_p", "db_p", "dW_r", "db_r")


def phase_kernels(counts_dev):
    """Each kernel against its plain version at the headline shapes."""
    from scvae_tpu_torch import ops

    dev = counts_dev.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    n, f = counts_dev.shape
    m, h_dim = BATCH, HIDDEN
    idx = torch.randperm(n, generator=gen, device=dev)[:m].to(torch.int32)
    results = {}

    # K1 — row gather: bit-exact with index_select + cast, at the headline
    # shapes, a ragged F and a float32 source, to bf16 and to float32.
    x = ops.gather_rows(counts_dev, idx, bf16)
    x_ref = ops.reference_gather(counts_dev, idx, bf16)
    f32_src = counts_dev[:4096].float()
    cases = [(x, x_ref)] + [
        (ops.gather_rows(src, rows, dtype), ops.reference_gather(src, rows, dtype))
        for src, rows in ((counts_dev, idx),
                          (counts_dev[:, :2000].contiguous(), idx),
                          (f32_src, idx % 4096))
        for dtype in (bf16, torch.float32)
    ]
    for got, want in cases:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError("gather_rows is not bit-exact")
    gather_bytes = m * f * (counts_dev.element_size() + 2) + m * 4
    t_bound, by = bound(gather_bytes, 0.0, BF16_FLOPS)
    results["gather_rows"] = {
        "max_abs_err": max_err(x, x_ref),
        "ms": time_ms(lambda: ops.gather_rows(counts_dev, idx, bf16),
                      flush=flush),
        "plain_ms": time_ms(lambda: ops.reference_gather(
            counts_dev, idx, bf16), flush=flush),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": time_ms(lambda: torch.index_select(
            counts_dev, 0, idx).to(bf16), flush=flush),
    }

    # K2 / K3 operands: decoder output, glorot head weights, gathered targets.
    h = torch.relu(torch.randn(m, h_dim, generator=gen, device=dev))
    limit = (6.0 / (h_dim + f)) ** 0.5
    w_p, w_r = ((torch.rand(h_dim, f, generator=gen, device=dev) * 2 - 1) * limit
                for _ in range(2))
    b_p, b_r = (0.1 * torch.randn(f, generator=gen, device=dev) for _ in range(2))
    g = torch.randn(m, generator=gen, device=dev) / m
    heads = (h, w_p, b_p, w_r, b_r)

    def ragged(cols):
        return (h, w_p[:, :cols].contiguous(), b_p[:cols].contiguous(),
                w_r[:, :cols].contiguous(), b_r[:cols].contiguous())

    # K2 — forward: the main path (bf16 inputs, staged lgamma constant),
    # ragged F, float32 inputs, the in-kernel lgamma constant, f32 targets.
    fwd_cases = [
        (heads, x, bf16, False),
        (ragged(2000), x[:, :2000].contiguous(), bf16, False),
        (heads, x, None, True),
        (heads, x.float(), bf16, True),
    ]
    for args, t, cdt, const in fwd_cases:
        got = ops.nb_forward(*args, t, compute_dtype=cdt, include_lgamma_const=const)
        want = ops.reference_nb_log_likelihood(
            *args, t, compute_dtype=cdt, include_lgamma_const=const)
        err = check_close(f"nb_forward F={t.shape[1]} {cdt} t={t.dtype} "
                          f"const={const}", got, want, FORWARD_RTOL)
        if cdt is bf16 and not const and args is heads:
            fwd_err = err
    fwd_flops = 2 * 2 * m * h_dim * f
    fwd_bytes = (m * h_dim * 4 + 2 * (h_dim * f + f) * 4 + m * f * 2 + m * 4)
    t_bound, by = bound(fwd_bytes, fwd_flops, BF16_FLOPS)
    results["nb_forward"] = {
        "max_abs_err": fwd_err,
        "ms": time_ms(lambda: ops.nb_forward(
            *heads, x, compute_dtype=bf16, include_lgamma_const=False),
            flush=flush),
        "plain_ms": time_ms(lambda: ops.reference_nb_log_likelihood(
            *heads, x, compute_dtype=bf16, include_lgamma_const=False),
            flush=flush),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
    }

    # K3 — backward, both passes: against the plain backward with the same
    # rounding (bf16, and ragged F), and in float32 against autograd through
    # the plain forward.
    for args, t in ((heads, x), (ragged(2000), x[:, :2000].contiguous())):
        got = (ops.nb_backward_dh(g, *args, t, compute_dtype=bf16),
               *ops.nb_backward_dw(g, *args, t, compute_dtype=bf16))
        want = ops.reference_nb_backward(g, *args, t, compute_dtype=bf16)
        errs = [check_close(f"nb_backward {part} F={t.shape[1]}", a, b,
                            BACKWARD_RTOL)
                for part, a, b in zip(GRAD_NAMES, got, want)]
        if args is heads:
            dh_err, dw_err = errs[0], max(errs[1:])
    leaves = [a.clone().requires_grad_(True) for a in heads]
    ll = ops.reference_nb_log_likelihood(*leaves, x, include_lgamma_const=False)
    want = torch.autograd.grad(ll, leaves, grad_outputs=g)  # dh, dW_p, db_p, ...
    got = (ops.nb_backward_dh(g, *heads, x), *ops.nb_backward_dw(g, *heads, x))
    for part, a, b in zip(GRAD_NAMES, got, want):
        check_close(f"nb_backward float32 {part} vs autograd", a, b,
                    AUTOGRAD_RTOL)
    bwd_flops = 2 * fwd_flops  # recompute + one gradient product
    dh_bytes = fwd_bytes + m * h_dim * 4
    dw_bytes = fwd_bytes + 2 * (h_dim * f + f) * 4
    for name, err, nbytes, fn, plain in (
        ("nb_backward_dh", dh_err, dh_bytes, ops.nb_backward_dh,
         ops.reference_nb_dh),
        ("nb_backward_dw", dw_err, dw_bytes, ops.nb_backward_dw,
         ops.reference_nb_dw),
    ):
        t_bound, by = bound(nbytes, bwd_flops, BF16_FLOPS)
        results[name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda fn=fn: fn(
                g, *heads, x, compute_dtype=bf16), flush=flush),
            "plain_ms": time_ms(lambda plain=plain: plain(
                g, *heads, x, compute_dtype=bf16), flush=flush),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        }
    torch.cuda.synchronize()
    return results


def phase_small_step():
    """One training loss and its gradients from the same small input on the
    CPU (plain versions) and on the GPU (kernels), float32."""
    from scvae_tpu_torch.models import step, vae
    from scvae_tpu_torch.ops import lgamma

    config = vae.VAEConfig(
        feature_size=300, latent_size=8, hidden_sizes=(32, 32),
        reconstruction_distribution="negative binomial", precision="float32",
    )
    rng = np.random.RandomState(0)
    x = rng.poisson(1.5, size=(64, 300)).astype(np.float32)
    noise = rng.standard_normal((1, 64, 8)).astype(np.float32)
    params, state = vae.init(config, torch.Generator().manual_seed(0))
    results = []
    for device in ("cpu", "cuda"):
        p = step.tree_map(
            lambda a: a.detach().to(device).requires_grad_(True), params)
        s = step.tree_map(lambda a: a.to(device), state)
        xt = torch.from_numpy(x).to(device)
        batch = {"x": xt, "t": xt,
                 "t_lgamma_rowsum": torch.sum(lgamma(1.0 + xt), dim=-1)}
        loss, _ = vae.loss_fn(config, p, s, batch, None,
                              noise=torch.from_numpy(noise).to(device))
        grads = torch.autograd.grad(loss, step.tree_leaves(p))
        results.append([loss.detach().cpu()] + [gr.cpu() for gr in grads])
    (cpu_loss, *cpu_grads), (gpu_loss, *gpu_grads) = results
    check_close("small step loss", gpu_loss, cpu_loss, AUTOGRAD_RTOL)
    largest = max(float(g.abs().max()) for g in cpu_grads)
    for i, (a, b) in enumerate(zip(gpu_grads, cpu_grads)):
        check_close(f"small step gradient [{i}]", a, b, AUTOGRAD_RTOL,
                    scale=largest)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    from scvae_tpu_torch import VariationalAutoencoder, ops
    from scvae_tpu_torch.ops import extension

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    start = time.perf_counter()
    extension.load_kernels()
    print(f"build: {time.perf_counter() - start:.1f} s", flush=True)

    # 3. kernels
    counts = make_counts(N_CELLS, N_GENES)
    counts_dev = torch.from_numpy(counts.toarray().astype(np.int16)).cuda()
    kernels = phase_kernels(counts_dev)
    del counts_dev
    print("kernels: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
        f"{v['bound_ms']:.4f}, err {v['max_abs_err']:.3g})"
        for k, v in kernels.items()), flush=True)

    # 4. slice
    phase_small_step()
    model = VariationalAutoencoder(
        feature_size=N_GENES, latent_size=LATENT, hidden_sizes=[HIDDEN, HIDDEN],
        reconstruction_distribution="negative binomial",
    )
    ops.reset_launch_counts()
    result = model.train(counts, number_of_epochs=EPOCHS, minibatch_size=BATCH,
                         seed=0, device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    steps = result.steps_per_epoch * EPOCHS
    for name in ("nb_forward", "nb_backward_dh", "nb_backward_dw"):
        if launches[name] != steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} training steps")
    if launches["gather_rows"] < steps:
        raise AssertionError(f"gather_rows launched {launches['gather_rows']} "
                             f"times in {steps} training steps")
    elbo = result.history["training"]["lower_bound"]
    if not (np.all(np.isfinite(elbo)) and elbo[-1] > elbo[0]):
        raise AssertionError(f"training ELBO not finite and rising: {elbo}")
    seconds = result.epoch_seconds[-1]
    print(f"slice: ELBO {elbo}; epoch {EPOCHS}: "
          f"{result.steps_per_epoch / seconds:.6g} steps/s, "
          f"{result.steps_per_epoch * BATCH / seconds:.6g} cells/s "
          f"({card})", flush=True)

    sources = {
        "gather_rows": ("scvae_tpu_torch/ops/csrc/gather.cu",
                        "scvae_tpu/ops/gather.py:223"),
        "nb_forward": ("scvae_tpu_torch/ops/csrc/nb_likelihood.cu",
                       "scvae_tpu/ops/fused_likelihood.py:627"),
        "nb_backward_dh": ("scvae_tpu_torch/ops/csrc/nb_likelihood.cu",
                           "scvae_tpu/ops/fused_likelihood.py:714"),
        "nb_backward_dw": ("scvae_tpu_torch/ops/csrc/nb_likelihood.cu",
                           "scvae_tpu/ops/fused_likelihood.py:714"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **values}
        for name, values in kernels.items()
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
