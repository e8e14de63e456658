"""Fused negative-binomial decoder heads + log-likelihood (kernels K2, K3).

The training loss ends with two dense heads on the decoder output (the NB
``p`` logit and ``log_r``), the elementwise NB log-probability and a sum over
genes.  The fused path computes

    a_k = h W_k + b_k  →  support clip  →  log NB(t)  →  Σ_genes

without writing the (M, F) activations to device memory, and its backward
recomputes them tile by tile.  On CUDA tensors :func:`nb_forward` launches
the hand-written kernel K2 and :func:`nb_backward` the two kernels of K3
(``ops/csrc/nb_likelihood.cu``); on CPU tensors both run their plain
versions, :func:`reference_nb_log_likelihood` and
:func:`reference_nb_backward`.  :class:`FusedNBLogLikelihood` wraps the pair
as an ``autograd.Function``.

Numerics follow ``scvae_tpu/ops/fused_likelihood.py``: with a
``compute_dtype`` of bfloat16, h and W are rounded to bf16 and the products
summed in float32, the elementwise math runs in float32, the backward rounds
da_k to bf16 before the dh and dW products, and db_k sums the unrounded
da_k.  Support clips use the nearest float32 strictly inside each support,
with zero gradient outside the clip range.
"""

from __future__ import annotations

import numpy as np
import torch

from scvae_tpu_torch.ops import extension
from scvae_tpu_torch.ops.special import digamma, lgamma

_TINY = float(np.finfo(np.float32).tiny)
_P_HI = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_L_LO = float(np.nextafter(np.float32(-10.0), np.float32(np.inf)))
_L_HI = float(np.nextafter(np.float32(10.0), np.float32(-np.inf)))

# Kernel launches, counted where each kernel is launched and nowhere else.
LAUNCHES = {"nb_forward": 0, "nb_backward_dh": 0, "nb_backward_dw": 0}

_T_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# Elementwise pieces (the kernels' device functions, in plain PyTorch)
# --------------------------------------------------------------------------


def nb_ll(a_p, a_r, t):
    """log NB(t | p = clip(σ(a_p)), r = exp(clip(a_r, ±10))) without the
    −lgamma(1+t) constant."""
    p = torch.clamp(torch.sigmoid(a_p), _TINY, _P_HI)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    return lgamma(t + r) - lgamma(r) + r * torch.log1p(-p) + t * torch.log(p)


def reference_nb_grads(a_p, a_r, t):
    """(∂ll/∂a_p, ∂ll/∂a_r) of :func:`nb_ll`, zero outside each clip range."""
    p_raw = torch.sigmoid(a_p)
    p = torch.clamp(p_raw, _TINY, _P_HI)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    p_inside = (p_raw > _TINY) & (p_raw < _P_HI)
    g_p = torch.where(p_inside, t * (1.0 - p) - r * p, zero)
    r_inside = (a_r > _L_LO) & (a_r < _L_HI)
    g_r = torch.where(
        r_inside, r * (digamma(t + r) - digamma(r) + torch.log1p(-p)), zero
    )
    return g_p, g_r


# --------------------------------------------------------------------------
# Plain versions of the kernels
# --------------------------------------------------------------------------


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = x.float()
    return x if compute_dtype is None else x.to(compute_dtype).float()


def _cycle_rows(t: torch.Tensor, m: int) -> torch.Tensor:
    """Row i of h pairs with row i mod M_t of t (the IW / MC sample axis
    shares one block of targets)."""
    return t if t.shape[0] == m else t.repeat(m // t.shape[0], 1)


def _activations(h, w_p, b_p, w_r, b_r, compute_dtype):
    hc = _rounded(h, compute_dtype)
    a_p = hc @ _rounded(w_p, compute_dtype) + b_p
    a_r = hc @ _rounded(w_r, compute_dtype) + b_r
    return hc, a_p, a_r


def reference_nb_log_likelihood(h, w_p, b_p, w_r, b_r, t, *,
                                compute_dtype=None,
                                include_lgamma_const=True):
    """Plain version of K2: row-summed NB log-likelihood (M,).  With
    ``compute_dtype=None`` this is ``reference_log_likelihood`` of the JAX
    package for the NB heads; with bfloat16 it rounds like the kernel."""
    _, a_p, a_r = _activations(h, w_p, b_p, w_r, b_r, compute_dtype)
    tt = _cycle_rows(t.float(), h.shape[0])
    ll = nb_ll(a_p, a_r, tt)
    if include_lgamma_const:
        ll = ll - lgamma(1.0 + tt)
    return torch.sum(ll, dim=-1)


def _weighted_grads(g, h, w_p, b_p, w_r, b_r, t, compute_dtype):
    """Rounded h and the row-weighted (da_p, da_r) = g·∂ll/∂a."""
    hc, a_p, a_r = _activations(h, w_p, b_p, w_r, b_r, compute_dtype)
    g_p, g_r = reference_nb_grads(a_p, a_r, _cycle_rows(t.float(), h.shape[0]))
    g = g.float()[:, None]
    return hc, g_p * g, g_r * g


def reference_nb_dh(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """Plain version of K3's first pass: dh = Σ_k bf16(da_k) W_kᵀ."""
    _, da_p, da_r = _weighted_grads(g, h, w_p, b_p, w_r, b_r, t, compute_dtype)
    dh = _rounded(da_p, compute_dtype) @ _rounded(w_p, compute_dtype).T
    return dh + _rounded(da_r, compute_dtype) @ _rounded(w_r, compute_dtype).T


def reference_nb_dw(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """Plain version of K3's second pass: (dW_p, db_p, dW_r, db_r) with
    dW_k = hᵀ bf16(da_k) and db_k = Σ_rows da_k."""
    hc, da_p, da_r = _weighted_grads(g, h, w_p, b_p, w_r, b_r, t, compute_dtype)
    return (hc.T @ _rounded(da_p, compute_dtype), da_p.sum(0),
            hc.T @ _rounded(da_r, compute_dtype), da_r.sum(0))


def reference_nb_backward(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """Plain version of K3: (dh, dW_p, db_p, dW_r, db_r) for the row
    cotangents ``g`` (M,)."""
    args = (g, h, w_p, b_p, w_r, b_r, t)
    return (reference_nb_dh(*args, compute_dtype=compute_dtype),
            *reference_nb_dw(*args, compute_dtype=compute_dtype))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _round_flag(compute_dtype) -> int:
    if compute_dtype is None:
        return 0
    if compute_dtype == torch.bfloat16:
        return 1
    raise ValueError(f"unsupported compute dtype {compute_dtype}")


def _checked_cuda(h, w_p, b_p, w_r, b_r, t):
    """Validate and normalise the kernels' operands; returns them as
    contiguous float32 tensors (t may stay bfloat16)."""
    tensors = (h, w_p, b_p, w_r, b_r, t)
    if not all(x.is_cuda and x.device == h.device for x in tensors):
        raise ValueError("all operands must be CUDA tensors on one device")
    m, hidden = h.shape
    f = t.shape[-1]
    if t.dim() != 2 or t.shape[0] == 0 or m % t.shape[0]:
        raise ValueError(f"t {tuple(t.shape)} does not tile h rows {m}")
    for w, b in ((w_p, b_p), (w_r, b_r)):
        if tuple(w.shape) != (hidden, f) or tuple(b.shape) != (f,):
            raise ValueError(f"head shapes {tuple(w.shape)}, {tuple(b.shape)} "
                             f"do not match h {tuple(h.shape)} and t "
                             f"{tuple(t.shape)}")
    if t.dtype not in _T_CODES:
        t = t.float()
    f32 = [x.float().contiguous() for x in (h, w_p, b_p, w_r, b_r)]
    return (*f32, t.contiguous())


def nb_forward(h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None,
               include_lgamma_const=True) -> torch.Tensor:
    """Row-summed NB log-likelihood (M,): K2 on CUDA, the plain version on
    the CPU."""
    if not h.is_cuda:
        return reference_nb_log_likelihood(
            h, w_p, b_p, w_r, b_r, t, compute_dtype=compute_dtype,
            include_lgamma_const=include_lgamma_const,
        )
    h, w_p, b_p, w_r, b_r, t = _checked_cuda(h, w_p, b_p, w_r, b_r, t)
    m, hidden = h.shape
    out = torch.empty((m,), dtype=torch.float32, device=h.device)
    if m == 0:
        return out
    extension.call(
        "scvae_nb_forward", h.device,
        h.data_ptr(), w_p.data_ptr(), b_p.data_ptr(), w_r.data_ptr(),
        b_r.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], out.data_ptr(),
        m, t.shape[0], hidden, t.shape[1], _round_flag(compute_dtype),
        int(include_lgamma_const),
    )
    LAUNCHES["nb_forward"] += 1
    return out


def _checked_backward(g, h, w_p, b_p, w_r, b_r, t):
    h, w_p, b_p, w_r, b_r, t = _checked_cuda(h, w_p, b_p, w_r, b_r, t)
    if tuple(g.shape) != (h.shape[0],) or g.device != h.device:
        raise ValueError(f"row cotangents {tuple(g.shape)} do not match "
                         f"{h.shape[0]} rows on {h.device}")
    return g.float().contiguous(), h, w_p, b_p, w_r, b_r, t


def nb_backward_dh(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """dh (M, H): K3's first kernel on CUDA, the plain version on the CPU."""
    if not h.is_cuda:
        return reference_nb_dh(g, h, w_p, b_p, w_r, b_r, t,
                               compute_dtype=compute_dtype)
    g, h, w_p, b_p, w_r, b_r, t = _checked_backward(g, h, w_p, b_p, w_r, b_r, t)
    m, hidden = h.shape
    dh = torch.empty((m, hidden), dtype=torch.float32, device=h.device)
    if m == 0:
        return dh
    extension.call(
        "scvae_nb_backward_dh", h.device,
        g.data_ptr(), h.data_ptr(), w_p.data_ptr(), b_p.data_ptr(),
        w_r.data_ptr(), b_r.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        dh.data_ptr(), m, t.shape[0], hidden, t.shape[1],
        _round_flag(compute_dtype),
    )
    LAUNCHES["nb_backward_dh"] += 1
    return dh


def nb_backward_dw(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """(dW_p, db_p, dW_r, db_r): K3's second kernel on CUDA, the plain
    version on the CPU."""
    if not h.is_cuda:
        return reference_nb_dw(g, h, w_p, b_p, w_r, b_r, t,
                               compute_dtype=compute_dtype)
    g, h, w_p, b_p, w_r, b_r, t = _checked_backward(g, h, w_p, b_p, w_r, b_r, t)
    m, hidden = h.shape
    f = t.shape[1]
    out = [torch.empty(shape, dtype=torch.float32, device=h.device)
           for shape in ((hidden, f), (f,), (hidden, f), (f,))]
    if f == 0:
        return tuple(out)
    extension.call(
        "scvae_nb_backward_dw", h.device,
        g.data_ptr(), h.data_ptr(), w_p.data_ptr(), b_p.data_ptr(),
        w_r.data_ptr(), b_r.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        *(x.data_ptr() for x in out), m, t.shape[0], hidden, f,
        _round_flag(compute_dtype),
    )
    LAUNCHES["nb_backward_dw"] += 1
    return tuple(out)


def nb_backward(g, h, w_p, b_p, w_r, b_r, t, *, compute_dtype=None):
    """(dh, dW_p, db_p, dW_r, db_r) for the row cotangents ``g`` (M,): the
    two K3 kernels on CUDA, the plain version on the CPU."""
    args = (g, h, w_p, b_p, w_r, b_r, t)
    return (nb_backward_dh(*args, compute_dtype=compute_dtype),
            *nb_backward_dw(*args, compute_dtype=compute_dtype))


class FusedNBLogLikelihood(torch.autograd.Function):
    """Row-summed NB log-likelihood with the fused backward; the twin of
    ``_make_fused_from`` in the JAX package.  Saves h, W, b and t, and
    recomputes the activations in the backward."""

    @staticmethod
    def forward(ctx, h, w_p, b_p, w_r, b_r, t, compute_dtype,
                include_lgamma_const):
        ctx.save_for_backward(h, w_p, b_p, w_r, b_r, t)
        ctx.compute_dtype = compute_dtype
        return nb_forward(
            h, w_p, b_p, w_r, b_r, t, compute_dtype=compute_dtype,
            include_lgamma_const=include_lgamma_const,
        )

    @staticmethod
    def backward(ctx, g):
        h, w_p, b_p, w_r, b_r, t = ctx.saved_tensors
        dh, dw_p, db_p, dw_r, db_r = nb_backward(
            g, h, w_p, b_p, w_r, b_r, t, compute_dtype=ctx.compute_dtype
        )
        return dh.to(h.dtype), dw_p, db_p, dw_r, db_r, None, None, None


def fused_log_likelihood(name, h, heads, t, compute_dtype=None,
                         include_lgamma_const=True) -> torch.Tensor:
    """Row-summed log p(t | heads(h)) on the fused path.

    ``h``: (..., H) decoder output; ``t``: (..., F) targets, or (M_t, F)
    shared by the leading sample axes of ``h`` (rows cycle instead of
    broadcasting).  ``heads``: {param: {kernel, bias}}.  With
    ``include_lgamma_const=False`` the −lgamma(1+t) constant is left out, for
    callers that subtract its row sums themselves.  Returns (...,)."""
    if name != "negative binomial":
        raise NotImplementedError(
            f"the fused {name!r} likelihood is not ported yet"
        )
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    if not (t.dim() == 2 and h2.shape[0] % t.shape[0] == 0):
        t = torch.broadcast_to(t, lead + t.shape[-1:]).reshape(-1, t.shape[-1])
    out = FusedNBLogLikelihood.apply(
        h2, heads["p"]["kernel"], heads["p"]["bias"],
        heads["log_r"]["kernel"], heads["log_r"]["bias"], t,
        compute_dtype, include_lgamma_const,
    )
    return out.reshape(lead)
