"""Plain reference of ``vae_nb.json``: scVAE's VAE with a Gaussian latent
and a negative-binomial likelihood (Grønbech et al. 2020), in float32.

Encoder MLP (dense → batch norm → ReLU) → Gaussian posterior heads (mean,
log σ clipped to (-3, 3)) → z = mean + σ·ε → decoder MLP → NB heads (p by a
sigmoid, log r clipped to (-10, 10)) → log p(x|z) summed over the genes;
the analytic KL against N(0, I); the loss is −mean(log p(x|z) − KL) over
the minibatch (one sample, so the importance-weighted bound is the ELBO).

Parameters are named by their place in the scVAE tree ("encoder.layers.0.
kernel", ...), and drawn from a CPU generator seeded with the run's seed,
kernel by kernel in the tree's order (Glorot uniform; biases and batch
norm's centres zero).  Also the operation counts of a training step and of
an evaluation pass, and the likelihood's calls, for the roofline metrics.
"""

from __future__ import annotations

import torch

from portbench import plain


def init(spec: dict, seed: int) -> tuple[dict, dict]:
    generator = torch.Generator().manual_seed(seed)
    hidden = spec["hidden_sizes"]
    f, d = spec["feature_size"], spec["latent_size"]
    params: dict = {}
    state: dict = {}
    plain.mlp_params(params, state, "encoder", "encoder", generator, f,
                     hidden)
    for head in ("mu", "log_sigma"):
        plain.dense_params(params, f"posterior.{head}", generator,
                           hidden[-1], d)
    plain.mlp_params(params, state, "decoder", "decoder", generator, d,
                     list(reversed(hidden)))
    for head in ("p", "log_r"):
        plain.dense_params(params, f"reconstruction.{head}", generator,
                           hidden[0], f)
    return params, state


def noise_shape(spec: dict, rows: int) -> tuple[int, ...]:
    """The standard-normal draws of one batch: (samples, rows, latent)."""
    return (1, rows, spec["latent_size"])


def _terms(spec, params, state, x, noise, *, training, precision):
    n_layers = len(spec["hidden_sizes"])
    new_state: dict = {}
    h = plain.mlp(params, state, new_state, "encoder", "encoder", x,
                  n_layers, training=training, precision=precision)
    mean = torch.clamp(plain.dense(params, "posterior.mu", h, precision),
                       *plain.interior(*plain.HALF_RANGE))
    log_sigma = torch.clamp(
        plain.dense(params, "posterior.log_sigma", h, precision),
        *plain.interior(-3.0, 3.0))
    sigma = torch.exp(log_sigma)
    z = mean + sigma * noise  # (1, B, D)
    dec = plain.mlp(params, state, new_state, "decoder", "decoder", z,
                    n_layers, training=training, precision=precision)
    log_px = torch.sum(plain.negative_binomial_log_prob(
        x, plain.dense(params, "reconstruction.p", dec, precision),
        plain.dense(params, "reconstruction.log_r", dec, precision)),
        dim=-1)[0]  # (B,)
    var_ratio = torch.square(sigma)
    kl = torch.sum(0.5 * (var_ratio + torch.square(mean) - 1.0
                          - torch.log(var_ratio)), dim=-1)  # (B,)
    return log_px, kl, new_state


def loss(spec, params, state, x, noise, *, precision="float32"):
    """(−mean ELBO of the batch, the batch-norm state after the step)."""
    log_px, kl, new_state = _terms(spec, params, state, x, noise,
                                   training=True, precision=precision)
    return -torch.mean(log_px - kl), new_state


def evaluate(spec, params, state, x, noise, *, precision="float32"):
    """The batch's mean lower bound, batch norm on its running statistics."""
    log_px, kl, _ = _terms(spec, params, state, x, noise, training=False,
                           precision=precision)
    return torch.mean(log_px - kl)


def _products(spec: dict, rows: int) -> list[tuple[int, int, int, bool]]:
    """The step's matmuls as (m, k, n, reads the input counts)."""
    f, d = spec["feature_size"], spec["latent_size"]
    hidden = list(spec["hidden_sizes"])
    out = []
    for i, (a, b) in enumerate(zip([f] + hidden[:-1], hidden)):
        out.append((rows, a, b, i == 0))
    out += [(rows, hidden[-1], d, False)] * 2
    back = list(reversed(hidden))
    for a, b in zip([d] + back[:-1], back):
        out.append((rows, a, b, False))
    out += [(rows, back[-1], f, False)] * 2
    return out


def train_flops(spec: dict, batch: int) -> float:
    """A training step's matmul operations: forward, and backward without
    the input's gradient of the layers that read the counts."""
    return sum(2 * m * k * n * (2 if first else 3)
               for m, k, n, first in _products(spec, batch))


def eval_flops(spec: dict, rows: int) -> float:
    return sum(2 * m * k * n for m, k, n, _ in _products(spec, rows))


def likelihood_calls(spec: dict, batch: int) -> list[dict]:
    """The NB likelihood's work in a training step: decoder rows against
    target rows, heads of hidden × genes."""
    return [{"rows": batch, "targets": batch,
             "hidden": spec["hidden_sizes"][0],
             "genes": spec["feature_size"], "heads": 2}]
