"""Dense networks (encoder/decoder MLPs) as functions on parameter dicts.

Counterpart of ``scvae_tpu/models/networks.py``: dropout → linear →
batch-norm → activation per layer, batch norm configured like TF1
``contrib.layers.batch_norm`` (centre only, decay 0.999, eps 1e-3, running
statistics).  Parameters and batch-norm statistics are plain nested dicts
and lists of tensors with the JAX package's names and layout (kernel is
(in, out)), so weights move between the two one to one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

Params = dict[str, Any]
State = dict[str, Any]

BN_DECAY = 0.999
BN_EPS = 1e-3


def glorot_uniform(generator: torch.Generator, shape: tuple[int, int]) -> torch.Tensor:
    """Xavier/Glorot uniform, the TF1 ``fully_connected`` default."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator
    )


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {
        "kernel": glorot_uniform(generator, (in_dim, out_dim)),
        "bias": torch.zeros((out_dim,), dtype=torch.float32),
    }


def apply_dense(params: Params, x: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Dense layer.  With ``compute_dtype`` (bfloat16) the matmul inputs are
    rounded to it and multiplied in float32: bfloat16 inputs, float32
    accumulation and a float32 product, as XLA's
    ``preferred_element_type=float32`` gives.  Gradients pass through the
    roundings as through JAX's casts."""
    kernel = params["kernel"]
    if compute_dtype is not None and kernel.dtype != compute_dtype:
        y = torch.matmul(x.to(compute_dtype).float(),
                         kernel.to(compute_dtype).float())
    else:
        y = torch.matmul(x.float(), kernel)
    return y + params["bias"]


def init_batch_norm(dim: int) -> tuple[Params, State]:
    params = {"beta": torch.zeros((dim,), dtype=torch.float32)}
    state = {
        "mean": torch.zeros((dim,), dtype=torch.float32),
        "var": torch.ones((dim,), dtype=torch.float32),
    }
    return params, state


def apply_batch_norm(
    params: Params, state: State, x: torch.Tensor, *, training: bool
) -> tuple[torch.Tensor, State]:
    """Normalise over all leading axes; returns (output, new_state)."""
    if training:
        axes = tuple(range(x.dim() - 1))
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, unbiased=False)
        new_state = {
            "mean": BN_DECAY * state["mean"] + (1.0 - BN_DECAY) * mean.detach(),
            "var": BN_DECAY * state["var"] + (1.0 - BN_DECAY) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + BN_EPS) + params["beta"]
    return y, new_state


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with the reference's keep-probability convention."""
    if keep_prob >= 1.0 or keep_prob <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def init_mlp(
    generator: torch.Generator,
    in_dim: int,
    hidden_sizes: Sequence[int],
    *,
    batch_norm: bool,
) -> tuple[Params, State]:
    layers = []
    bn_params, bn_state = [], []
    dim = in_dim
    for size in hidden_sizes:
        layers.append(init_dense(generator, dim, size))
        if batch_norm:
            p, s = init_batch_norm(size)
            bn_params.append(p)
            bn_state.append(s)
        dim = size
    params: Params = {"layers": layers}
    state: State = {}
    if batch_norm:
        params["batch_norm"] = bn_params
        state["batch_norm"] = bn_state
    return params, state


def apply_mlp(
    params: Params,
    state: State,
    x: torch.Tensor,
    *,
    training: bool,
    generator: torch.Generator | None = None,
    activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    input_dropout_keep_prob: float = 1.0,
    hidden_dropout_keep_prob: float = 1.0,
    compute_dtype=None,
) -> tuple[torch.Tensor, State]:
    """Dropout → dense → batch-norm → activation per layer."""
    use_bn = "batch_norm" in params
    new_bn_states = []
    h = x
    for i, layer in enumerate(params["layers"]):
        keep = input_dropout_keep_prob if i == 0 else hidden_dropout_keep_prob
        if training and keep < 1.0:
            h = dropout(h, keep, generator)
        h = apply_dense(layer, h, compute_dtype=compute_dtype)
        if use_bn:
            h, bn_s = apply_batch_norm(
                params["batch_norm"][i], state["batch_norm"][i], h,
                training=training,
            )
            new_bn_states.append(bn_s)
        h = activation(h)
    new_state: State = {}
    if use_bn:
        new_state["batch_norm"] = new_bn_states
    return h, new_state
