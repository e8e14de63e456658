"""Plain PyTorch pieces that the configurations' references share.

Float32 with TF32 off, no kernel, no graph, no fused path: dense layers,
batch norm as the reference scVAE configures it (centre only, decay 0.999,
eps 1e-3, biased batch variance), the negative binomial's log-probability,
element-wise clipping to [-1, 1] and Adam with the optax defaults.  Each
matmul goes through :func:`matmul`, whose ``precision`` lets the control
(the reference computed in a lower precision, put in the program's place)
round its operands.

Imports torch and numpy only: nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BN_DECAY = 0.999
BN_EPS = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CLIP = 1.0
_F32 = np.finfo(np.float32)
HALF_RANGE = (float(_F32.min / 2), float(_F32.max / 2))
LOG_2PI = math.log(2.0 * math.pi)
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def interior(lo: float, hi: float) -> tuple[float, float]:
    """The nearest float32 values strictly inside [lo, hi]: the bounds the
    scVAE reference clips a constrained parameter to."""
    return (float(np.nextafter(np.float32(lo), np.float32(np.inf))),
            float(np.nextafter(np.float32(hi), np.float32(-np.inf))))


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, to nearest), as the tensor
    cores round a TF32 matmul's operands."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude onto e4m3's largest value), as fp8 training scales a
    tensor, and back to float32."""
    amax = torch.amax(torch.abs(x)).clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDING = {
    "float32": None,
    "tf32": _round_tf32,
    "bfloat16": lambda x: x.bfloat16().float(),
    "fp8": _round_fp8,
}


class _Round(torch.autograd.Function):
    """Round in the forward pass and round the gradient the same way, as a
    cast to a narrower type and back does."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float32"):
    """a @ b in float32, the operands first rounded to ``precision``."""
    fn = ROUNDING[precision]
    if fn is None:
        return torch.matmul(a, b)
    return torch.matmul(_Round.apply(a, fn), _Round.apply(b, fn))


def glorot_uniform(generator: torch.Generator, fan_in: int,
                   fan_out: int) -> torch.Tensor:
    """Glorot uniform (TF1's ``fully_connected`` default) drawn from a CPU
    generator."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(
        -limit, limit, generator=generator)


def dense_params(params: dict, name: str, generator: torch.Generator,
                 fan_in: int, fan_out: int) -> None:
    params[f"{name}.kernel"] = glorot_uniform(generator, fan_in, fan_out)
    params[f"{name}.bias"] = torch.zeros(fan_out, dtype=torch.float32)


def mlp_params(params: dict, state: dict, name: str, state_name: str,
               generator: torch.Generator, in_dim: int, sizes) -> None:
    """Dense layers with batch norm; the kernels drawn layer by layer."""
    for i, size in enumerate(sizes):
        dense_params(params, f"{name}.layers.{i}", generator, in_dim, size)
        in_dim = size
    for i, size in enumerate(sizes):
        params[f"{name}.batch_norm.{i}.beta"] = torch.zeros(size)
        state[f"{state_name}.batch_norm.{i}.mean"] = torch.zeros(size)
        state[f"{state_name}.batch_norm.{i}.var"] = torch.ones(size)


def dense(params: dict, name: str, x: torch.Tensor,
          precision: str = "float32") -> torch.Tensor:
    return matmul(x, params[f"{name}.kernel"], precision) + params[
        f"{name}.bias"]


def batch_norm(params: dict, state: dict, new_state: dict, name: str,
               state_name: str, i: int, h: torch.Tensor, *, training: bool,
               clusters: bool = False) -> torch.Tensor:
    """Batch norm over every axis but the last (and, with ``clusters``, but
    the first: one set of statistics per cluster, whose running update is
    the mean over the clusters)."""
    key = f"{state_name}.batch_norm.{i}"
    if training:
        axes = tuple(range(1 if clusters else 0, h.dim() - 1))
        mean = torch.mean(h, dim=axes, keepdim=True)
        var = torch.var(h, dim=axes, unbiased=False, keepdim=True)
        batch_mean = mean.detach().reshape(-1, h.shape[-1]).mean(0)
        batch_var = var.detach().reshape(-1, h.shape[-1]).mean(0)
        new_state[f"{key}.mean"] = (BN_DECAY * state[f"{key}.mean"]
                                    + (1.0 - BN_DECAY) * batch_mean)
        new_state[f"{key}.var"] = (BN_DECAY * state[f"{key}.var"]
                                   + (1.0 - BN_DECAY) * batch_var)
    else:
        mean, var = state[f"{key}.mean"], state[f"{key}.var"]
    beta = params[f"{name}.batch_norm.{i}.beta"]
    return (h - mean) * torch.rsqrt(var + BN_EPS) + beta


def mlp(params: dict, state: dict, new_state: dict, name: str,
        state_name: str, x: torch.Tensor, n_layers: int, *, training: bool,
        precision: str = "float32", clusters: bool = False,
        first_preactivation: torch.Tensor | None = None) -> torch.Tensor:
    """dense → batch norm → ReLU per layer; with ``first_preactivation``
    the first dense layer's output is given."""
    h = x
    for i in range(n_layers):
        if i == 0 and first_preactivation is not None:
            h = first_preactivation
        else:
            h = dense(params, f"{name}.layers.{i}", h, precision)
        h = batch_norm(params, state, new_state, name, state_name, i, h,
                       training=training, clusters=clusters)
        h = torch.relu(h)
    return h


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def normal_log_prob(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * torch.square(z) - torch.log(scale) - 0.5 * LOG_2PI


def negative_binomial_log_prob(t: torch.Tensor, p_raw: torch.Tensor,
                               log_r_raw: torch.Tensor) -> torch.Tensor:
    """log NB(t; r, p) per element from the heads' raw outputs: p the
    sigmoid of its head, log r its head, each clipped inside its support."""
    p = torch.clamp(torch.sigmoid(p_raw), *interior(0.0, 1.0))
    r = torch.exp(torch.clamp(log_r_raw, *interior(-10.0, 10.0)))
    return (torch.lgamma(t + r) - torch.lgamma(r) - torch.lgamma(1.0 + t)
            + r * torch.log1p(-p) + torch.xlogy(t, p))


@torch.no_grad()
def clip_adam_(params: dict, grads: dict, mu: dict, nu: dict, count: int,
               learning_rate: float) -> None:
    """One step of element-wise clipping to [-1, 1], then Adam (optax
    defaults), in place; ``count`` is the step's number, from 1."""
    device = next(iter(params.values())).device
    step = torch.tensor(float(count), device=device)
    correction1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=device), step)
    correction2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=device), step)
    for name, g in grads.items():
        g = torch.clamp(g, -CLIP, CLIP)
        mu[name].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu[name].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        denom = torch.sqrt(nu[name] / correction2) + ADAM_EPS
        params[name].sub_(learning_rate * (mu[name] / correction1) / denom)
