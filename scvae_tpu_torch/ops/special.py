"""Special functions as the kernels compute them.

``lgamma`` and ``digamma`` use the same recurrence push-up to z = x + 3 and
Stirling / asymptotic series as ``scvae_tpu/ops/special.py``, operation for
operation, instead of ``torch.lgamma`` / ``torch.digamma``: they are the plain
version of the device functions in ``ops/csrc/special.cuh``, and the port's
likelihoods must compute the same function on the CPU and in the kernels.
Accurate to ~1e-6 relative in float32 over the x > 0 domain the count
likelihoods use.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_SHIFT = 3


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Γ(x) for x > 0 (Stirling series after a 3-step recurrence)."""
    shift_log = torch.zeros_like(x)
    for k in range(_SHIFT):
        shift_log = shift_log + torch.log(x + k)
    z = x + _SHIFT
    inv = 1.0 / z
    inv2 = inv * inv
    series = inv * (
        1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0))
    )
    stirling = (z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI + series
    return stirling - shift_log


def digamma(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) = d/dx log Γ(x) for x > 0."""
    shift_sum = torch.zeros_like(x)
    for k in range(_SHIFT):
        shift_sum = shift_sum + 1.0 / (x + k)
    z = x + _SHIFT
    inv = 1.0 / z
    inv2 = inv * inv
    series = inv2 * (
        -1.0 / 12.0 + inv2 * (1.0 / 120.0 + inv2 * (-1.0 / 252.0))
    )
    return torch.log(z) - 0.5 * inv + series - shift_sum


def logaddexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log(eˣ + eʸ) as ``jnp.logaddexp`` computes it: NaNs or same-signed
    infinities give x + y, otherwise max + log1p(exp(−|x − y|))."""
    delta = x - y
    return torch.where(
        torch.isnan(delta), x + y,
        torch.maximum(x, y) + torch.log1p(torch.exp(-delta.abs())),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return logaddexp(x, torch.zeros_like(x))
