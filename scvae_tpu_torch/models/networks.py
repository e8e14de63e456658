"""Dense networks (encoder/decoder MLPs) as functions on parameter dicts.

Counterpart of ``scvae_tpu/models/networks.py``: dropout → linear →
batch-norm → activation per layer, batch norm configured like TF1
``contrib.layers.batch_norm`` (centre only, decay 0.999, eps 1e-3, running
statistics).  Parameters and batch-norm statistics are plain nested dicts
and lists of tensors with the JAX package's names and layout (kernel is
(in, out)), so weights move between the two one to one.

The GMVAE runs one network for every latent cluster.  The JAX package
``vmap``s it over the cluster axis, so batch statistics are taken per
cluster and the new running statistics are the mean over clusters; here the
cluster axis is the leading axis of the input and ``clusters=True`` gives
those semantics.

With a ``shard`` (``parallel.RowShard``: this rank's rows of a global batch
cut over the data axis) training batch norm takes the global batch's
statistics and dropout draws the global batch's mask, so R ranks compute
what one process computes on the whole batch.  Activations hold the
batch's rows on axis −2.
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


def init_categorised_head(generator: torch.Generator, in_dim: int,
                          feature_size: int, k_max: int) -> Params:
    """(K+1)-class logit heads of the piecewise-categorical likelihood: one
    Glorot draw of width F·(K+1) (the reference's single wide head, so its
    init scale), stored class-major as kernel (K+1, H, F) and bias
    (K+1, F), so each class's weights are one contiguous (H, F) matrix."""
    wide = glorot_uniform(generator, (in_dim, feature_size * (k_max + 1)))
    kernel = wide.reshape(in_dim, feature_size, k_max + 1).permute(2, 0, 1)
    return {
        "kernel": kernel.contiguous(),
        "bias": torch.zeros((k_max + 1, feature_size), dtype=torch.float32),
    }


def apply_categorised_logits(params: Params, h: torch.Tensor, *,
                             compute_dtype=None) -> torch.Tensor:
    """Class logits (..., F, K+1) from decoder output ``h`` (..., H),
    rounded like :func:`apply_dense`."""
    kernel = params["kernel"]  # (K+1, H, F)
    if compute_dtype is not None and kernel.dtype != compute_dtype:
        h = h.to(compute_dtype)
        kernel = kernel.to(compute_dtype).float()
    logits = torch.einsum("...h,khf->...fk", h.float(), kernel)
    return logits + params["bias"].T


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
    params: Params, state: State, x: torch.Tensor, *, training: bool,
    clusters: bool = False, shard=None,
) -> tuple[torch.Tensor, State]:
    """Normalise over all leading axes, or with ``clusters`` over all but
    the first (the cluster axis) for each cluster; returns (output,
    new_state).  With a ``shard`` the training statistics are the global
    batch's, in two passes, each averaged over the ranks (equal blocks) by
    a differentiable all-reduce: the mean, then the mean square deviation
    from it, as each block's variance plus the square of its mean's
    deviation (one pass of Σx and Σx² would cancel in float32; on one rank
    both are the local statistics, bit for bit)."""
    if training:
        axes = tuple(range(1 if clusters else 0, x.dim() - 1))
        mean = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, unbiased=False, keepdim=True)
        if shard is not None:
            local_mean, mean = mean, shard.mean(mean)
            var = shard.mean(var + torch.square(local_mean - mean))
        batch_mean, batch_var = (
            v.detach().reshape(-1, x.shape[-1]) for v in (mean, var))
        if clusters:  # one update per cluster, averaged over clusters
            batch_mean, batch_var = batch_mean.mean(0), batch_var.mean(0)
        else:
            batch_mean, batch_var = batch_mean[0], batch_var[0]
        new_state = {
            "mean": BN_DECAY * state["mean"] + (1.0 - BN_DECAY) * batch_mean,
            "var": BN_DECAY * state["var"] + (1.0 - BN_DECAY) * batch_var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + BN_EPS) + params["beta"]
    return y, new_state


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator | None, shard=None) -> torch.Tensor:
    """Inverted dropout with the reference's keep-probability convention
    (with a ``shard``, the rank's rows of the global batch's mask)."""
    if keep_prob >= 1.0 or keep_prob <= 0.0:
        return x
    if shard is None:
        uniform = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        uniform = shard.uniform(x.shape, generator, x.device)
    keep = uniform < keep_prob
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
    clusters: bool = False,
    shard=None,
) -> tuple[torch.Tensor, State]:
    """Dropout → dense → batch-norm → activation per layer (batch norm per
    cluster of the leading axis with ``clusters``; global statistics and
    draws with a ``shard``)."""
    return _finish_mlp(
        params, state, x, 0, training=training, generator=generator,
        activation=activation, input_dropout_keep_prob=input_dropout_keep_prob,
        hidden_dropout_keep_prob=hidden_dropout_keep_prob,
        compute_dtype=compute_dtype, clusters=clusters, shard=shard,
    )


def apply_mlp_from_first_preactivation(
    params: Params,
    state: State,
    pre0: torch.Tensor,
    *,
    training: bool,
    generator: torch.Generator | None = None,
    activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    hidden_dropout_keep_prob: float = 1.0,
    compute_dtype=None,
    clusters: bool = False,
    shard=None,
) -> tuple[torch.Tensor, State]:
    """Finish an MLP from the first layer's pre-activation ``pre0``.

    For inputs concat(x, c) where x is shared across clusters and only c
    varies (the GMVAE's one-hot cluster codes), concat(x, c) W = x W[:F] +
    c W[F:], so the caller computes the (B, F)·(F, H) product once and
    passes ``pre0 = x W[:F] + b + W[F + k]`` per cluster.  Not for input
    dropout, whose mask on x is drawn per cluster."""
    return _finish_mlp(
        params, state, pre0, 1, training=training, generator=generator,
        activation=activation, input_dropout_keep_prob=1.0,
        hidden_dropout_keep_prob=hidden_dropout_keep_prob,
        compute_dtype=compute_dtype, clusters=clusters, shard=shard,
    )


def _finish_mlp(params, state, h, first, *, training, generator, activation,
                input_dropout_keep_prob, hidden_dropout_keep_prob,
                compute_dtype, clusters, shard):
    """Layers from ``first`` on, with ``h`` the input of layer ``first`` (or,
    for ``first`` = 1, layer 0's pre-activation)."""
    use_bn = "batch_norm" in params
    new_bn_states = []
    for i, layer in enumerate(params["layers"]):
        if i >= first:
            keep = (input_dropout_keep_prob if i == 0
                    else hidden_dropout_keep_prob)
            if training and keep < 1.0:
                h = dropout(h, keep, generator, shard)
            h = apply_dense(layer, h, compute_dtype=compute_dtype)
        if use_bn:
            h, bn_s = apply_batch_norm(
                params["batch_norm"][i], state["batch_norm"][i], h,
                training=training, clusters=clusters, shard=shard,
            )
            new_bn_states.append(bn_s)
        h = activation(h)
    new_state: State = {}
    if use_bn:
        new_state["batch_norm"] = new_bn_states
    return h, new_state
