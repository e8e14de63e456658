"""Fused decoder heads + count log-likelihoods (kernels K2–K7).

The training loss ends with one dense head per likelihood parameter on the
decoder output, the elementwise log-probability and a sum over genes.  The
fused path computes

    a_k = h W_k + b_k  →  support clip  →  log p(t | a)  →  Σ_genes

without writing the (M, F) activations to device memory, and its backward
recomputes them tile by tile.  Counterpart of
``scvae_tpu/ops/fused_likelihood.py``:

* the base families — Poisson, negative binomial (NB), zero-inflated
  Poisson (ZIP) and zero-inflated NB (ZINB), :data:`FAMILIES` — share one
  forward kernel K2 and one backward K3, a gradient kernel then the dh and
  dW products, on the tensor cores (``ops/csrc/count_likelihood_tc.cu``,
  then ``ops/csrc/tc_product.cu``), templated on the family's elementwise
  (ll, grads) pair as ``_make_fused_from`` is; in float32 h and W go over
  as three bf16 terms each;
* the constrained Poisson (CP), whose gene-axis softmax couples every gene
  of a row, has its own forward K6 with an online logsumexp across gene
  tiles and the backward K7's gradient kernel on the tensor cores
  (``ops/csrc/cp_likelihood_tc.cu``, then the products of
  ``ops/csrc/tc_product.cu``), with bf16 h on two bf16 terms of W and da,
  with float32 h on three bf16 terms of h, W and da as the base families';
* the categorised instances of K2/K3 — a base family plus K + 1 class-logit
  heads, the piecewise-categorical likelihood of ``_make_fused_categorised``
  — have their own forward and gradient kernel on the tensor cores for up
  to :data:`MAX_FUSED_HEADS` heads (``ops/csrc/categorised_likelihood_tc.cu``,
  then the products of ``ops/csrc/tc_product.cu``), in float32 on three
  bf16 terms of h, W and da as the base families';
* the grouped kernels K4/K5 take h (G, M, H) against targets t (M, F) shared
  by the G groups, with the group loop inside the kernel and lgamma(1 + t)
  always subtracted, for the base families and 2 ≤ G ≤
  :data:`MAX_FUSED_GROUPS` (``_make_fused_grouped``): one grouped forward
  and gradient kernel on the tensor cores
  (``ops/csrc/grouped_likelihood_tc.cu``), then the products of
  ``ops/csrc/tc_product.cu`` over the G·M rows; in float32 on three bf16
  terms of h, W and da as the base families'.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run the
plain versions beside them.  :class:`FusedLogLikelihood`,
:class:`FusedConstrainedPoisson`, :class:`FusedCategorised` and
:class:`FusedGroupedLogLikelihood` wrap them as ``autograd.Function``\\ s;
:func:`fused_log_likelihood` dispatches by name,
:func:`fused_categorised_log_likelihood` takes the class heads and
:func:`fused_grouped_log_likelihood` the group axis, with the JAX
signatures.

Numerics follow the JAX package.  Base families: with a ``compute_dtype`` of
bfloat16, h and W are rounded to bf16 and the products summed in float32,
the elementwise math runs in float32, the backward rounds da_k to bf16
before the dh and dW products, and db_k sums the unrounded da_k (the
categorised instances likewise, for every head).  In float32 the CUDA
kernels multiply h, W and da as three bf16 terms each, which keeps float32
accuracy (see the split-bf16 section below).  Support
clips use the nearest float32 strictly inside each support, with zero
gradient outside the clip range.  CP takes no compute dtype in the JAX
kernels: its caller hands them bf16 h, which multiplies float32 W in
float32.  So here bfloat16 rounds the values of h only, W and da stay
float32 (as bf16 terms on the tensor cores), and dh comes back in float32
(unrounded, as JAX returns it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from scvae_tpu_torch.ops import extension
from scvae_tpu_torch.ops.special import digamma, lgamma, logaddexp

_TINY = float(np.finfo(np.float32).tiny)
_P_HI = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_L_LO = float(np.nextafter(np.float32(-10.0), np.float32(np.inf)))
_L_HI = float(np.nextafter(np.float32(10.0), np.float32(-np.inf)))

_T_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# Elementwise pieces (the kernels' device functions, in plain PyTorch)
# --------------------------------------------------------------------------


def _zero_outside(inside, value):
    return torch.where(inside, value, 0.0)


def _p(a):
    """(raw σ(a), σ(a) clipped into (0, 1), inside-the-clip mask)."""
    raw = torch.sigmoid(a)
    return raw, torch.clamp(raw, _TINY, _P_HI), (raw > _TINY) & (raw < _P_HI)


def _inside_l(a):
    return (a > _L_LO) & (a < _L_HI)


def poisson_ll(a_l, t):
    """log Poisson(t | exp(clip(a_l, ±10))) without the −lgamma(1+t)
    constant."""
    log_lam = torch.clamp(a_l, _L_LO, _L_HI)
    return t * log_lam - torch.exp(log_lam)


def poisson_grads(a_l, t):
    lam = torch.exp(torch.clamp(a_l, _L_LO, _L_HI))
    return (_zero_outside(_inside_l(a_l), t - lam),)


def nb_ll(a_p, a_r, t):
    """log NB(t | p = clip(σ(a_p)), r = exp(clip(a_r, ±10))) without the
    −lgamma(1+t) constant."""
    _, p, _ = _p(a_p)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    return lgamma(t + r) - lgamma(r) + r * torch.log1p(-p) + t * torch.log(p)


def nb_grads(a_p, a_r, t):
    """(∂ll/∂a_p, ∂ll/∂a_r) of :func:`nb_ll`, zero outside each clip range."""
    _, p, p_inside = _p(a_p)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    g_p = _zero_outside(p_inside, t * (1.0 - p) - r * p)
    g_r = _zero_outside(_inside_l(a_r),
                 r * (digamma(t + r) - digamma(r) + torch.log1p(-p)))
    return g_p, g_r


def zip_ll(a_pi, a_l, t):
    """log ZIP(t | π = clip(σ(a_pi)), λ = exp(clip(a_l, ±10))) without the
    −lgamma(1+t) constant (zero at t = 0, so subtracting it everywhere is
    exact).  Both branches are evaluated and t > 0 selects, as jnp.where."""
    _, pi, _ = _p(a_pi)
    log_lam = torch.clamp(a_l, _L_LO, _L_HI)
    lam = torch.exp(log_lam)
    log1m_pi = torch.log1p(-pi)
    y_pos = log1m_pi + t * log_lam - lam
    y_zero = logaddexp(torch.log(pi), log1m_pi - lam)
    return torch.where(t > 0, y_pos, y_zero)


def zip_grads(a_pi, a_l, t):
    _, pi, pi_inside = _p(a_pi)
    lam = torch.exp(torch.clamp(a_l, _L_LO, _L_HI))
    # t = 0 branch: S = π + (1−π)e^{−λ}; log S via logaddexp.
    log_s = logaddexp(torch.log(pi), torch.log1p(-pi) - lam)
    inv_s = torch.exp(-log_s)
    elam_over_s = torch.exp(-lam - log_s)
    g_pi_zero = pi * (1.0 - pi) * (inv_s - elam_over_s)
    g_l_zero = -lam * (1.0 - pi) * elam_over_s
    pos = t > 0
    g_pi = _zero_outside(pi_inside, torch.where(pos, -pi, g_pi_zero))
    g_l = _zero_outside(_inside_l(a_l), torch.where(pos, t - lam, g_l_zero))
    return g_pi, g_l


def zinb_ll(a_pi, a_p, a_r, t):
    """log ZINB(t) without the −lgamma(1+t) constant; the base NB in the TFP
    convention (successes before r failures)."""
    _, pi, _ = _p(a_pi)
    _, p, _ = _p(a_p)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    log1m_pi = torch.log1p(-pi)
    nb_pos = lgamma(t + r) - lgamma(r) + r * torch.log1p(-p) + t * torch.log(p)
    y_pos = log1m_pi + nb_pos
    # NB(0) = (1−p)^r → log = r·log1p(−p)
    y_zero = logaddexp(torch.log(pi), log1m_pi + r * torch.log1p(-p))
    return torch.where(t > 0, y_pos, y_zero)


def zinb_grads(a_pi, a_p, a_r, t):
    _, pi, pi_inside = _p(a_pi)
    _, p, p_inside = _p(a_p)
    r = torch.exp(torch.clamp(a_r, _L_LO, _L_HI))
    log1m_p = torch.log1p(-p)
    # t = 0 branch: S = π + (1−π)(1−p)^r; q0 = (1−p)^r.
    log_q0 = r * log1m_p
    log_s = logaddexp(torch.log(pi), torch.log1p(-pi) + log_q0)
    inv_s = torch.exp(-log_s)
    q0_over_s = torch.exp(log_q0 - log_s)
    one_m_pi = 1.0 - pi
    g_pi_zero = pi * one_m_pi * (inv_s - q0_over_s)
    g_p_zero = -one_m_pi * r * p * q0_over_s
    g_r_zero = one_m_pi * r * log1m_p * q0_over_s
    g_p_pos = t * (1.0 - p) - r * p
    g_r_pos = r * (digamma(t + r) - digamma(r) + log1m_p)
    pos = t > 0
    return (_zero_outside(pi_inside, torch.where(pos, -pi, g_pi_zero)),
            _zero_outside(p_inside, torch.where(pos, g_p_pos, g_p_zero)),
            _zero_outside(_inside_l(a_r), torch.where(pos, g_r_pos, g_r_zero)))


@dataclasses.dataclass(frozen=True)
class Family:
    """A base likelihood of K2/K3: its code in ``count_likelihood_tc.cu``, the
    prefix of its launch counters, its head names in kernel order and its
    elementwise ``ll(*a, t)`` / ``grads(*a, t)``."""

    code: int
    prefix: str
    heads: tuple[str, ...]
    ll: Callable[..., torch.Tensor]
    grads: Callable[..., tuple[torch.Tensor, ...]]


FAMILIES = {
    "poisson": Family(0, "poisson", ("log_lambda",), poisson_ll, poisson_grads),
    "negative binomial": Family(1, "nb", ("p", "log_r"), nb_ll, nb_grads),
    "zero-inflated poisson": Family(2, "zip", ("pi", "log_lambda"), zip_ll,
                                    zip_grads),
    "zero-inflated negative binomial": Family(3, "zinb", ("pi", "p", "log_r"),
                                              zinb_ll, zinb_grads),
}
_MAX_HEADS = 3
# Base heads plus class heads of the categorised instances: the JAX
# package's cap (``_MAX_FUSED_HEADS``), beyond which it trains unfused.
MAX_FUSED_HEADS = 32

# Groups of the grouped kernels: the JAX package's cap
# (``_MAX_FUSED_GROUPS``), beyond which it takes the flat kernels.
MAX_FUSED_GROUPS = 16

# Kernel launches, counted where each kernel is launched and nowhere else (a
# CUDA graph's replay adds what its capture recorded: ops.add_launch_counts).
# K2/K3 (tensor cores) count as "<prefix>_<kernel>" (prefix "cat_<family>"
# for the categorised instances): the forward as "_forward", the backward's
# gradient kernel as "_backward_gradient" and its products as
# "_backward_dh" / "_backward_dw"; the float32 instances with the
# "_float32" suffix.  The grouped kernels count under the prefix
# "<family>_grouped": K4 as "_forward", K5 as "_backward_gradient",
# "_backward_dh", "_backward_dw"; the float32 instances with the "_float32"
# suffix.  CP's as "cp_<kernel>" (the forward, the
# backward's gradient kernel and its products; float32 h with the
# "_float32" suffix).
_KERNELS = ("forward", "backward_dh", "backward_dw")
LAUNCHES = {
    f"{prefix}_{kernel}{suffix}": 0
    for fam in FAMILIES.values()
    for prefix in (fam.prefix, f"cat_{fam.prefix}")
    for kernel in (*_KERNELS, "backward_gradient")
    for suffix in ("", "_float32")
} | {
    f"{fam.prefix}_grouped_{kernel}{suffix}": 0
    for fam in FAMILIES.values()
    for kernel in (*_KERNELS, "backward_gradient")
    for suffix in ("", "_float32")
}
LAUNCHES.update({f"cp_{kernel}{suffix}": 0
                 for kernel in (*_KERNELS, "backward_gradient")
                 for suffix in ("", "_float32")})


def supports_fused_likelihood(name: str, k_max: int = 0) -> bool:
    """Whether ``name`` with ``k_max`` class heads has a fused path (the JAX
    package's test: every base family and CP; categorised only over a base
    family and within :data:`MAX_FUSED_HEADS` heads)."""
    if k_max == 0:
        return name in FAMILIES or name == "constrained poisson"
    return (name in FAMILIES
            and k_max + 1 + len(FAMILIES[name].heads) <= MAX_FUSED_HEADS)


def supports_grouped_likelihood(name: str, g: int, k_max: int = 0) -> bool:
    """Whether ``g`` groups of family ``name`` with ``k_max`` class heads
    have a grouped path (the JAX package's test: base families only, no
    class heads, 1 < g ≤ :data:`MAX_FUSED_GROUPS`)."""
    return k_max == 0 and name in FAMILIES and 1 < g <= MAX_FUSED_GROUPS


# --------------------------------------------------------------------------
# Plain versions of K2 / K3
# --------------------------------------------------------------------------


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = x.float()
    return x if compute_dtype is None else x.to(compute_dtype).float()


def _cycle_rows(t: torch.Tensor, m: int) -> torch.Tensor:
    """Row i of h pairs with row i mod M_t of t (the IW / MC sample axis
    shares one block of targets)."""
    return t if t.shape[0] == m else t.repeat(m // t.shape[0], 1)


def _activations(h, weights, biases, compute_dtype):
    hc = _rounded(h, compute_dtype)
    return hc, [hc @ _rounded(w, compute_dtype) + b
                for w, b in zip(weights, biases)]


def reference_forward(name, h, weights, biases, t, *, compute_dtype=None,
                      include_lgamma_const=True):
    """Plain version of K2: the row-summed log-likelihood (M,) of family
    ``name`` with head ``weights`` / ``biases`` in the family's head order.
    With ``compute_dtype=None`` this is the JAX ``reference_log_likelihood``;
    with bfloat16 it rounds like the kernel."""
    _, acts = _activations(h, weights, biases, compute_dtype)
    tt = _cycle_rows(t.float(), h.shape[0])
    ll = FAMILIES[name].ll(*acts, tt)
    if include_lgamma_const:
        ll = ll - lgamma(1.0 + tt)
    return torch.sum(ll, dim=-1)


def _weighted_grads(name, g, h, weights, biases, t, compute_dtype):
    """Rounded h and the row-weighted da_k = g·∂ll/∂a_k."""
    hc, acts = _activations(h, weights, biases, compute_dtype)
    gs = FAMILIES[name].grads(*acts, _cycle_rows(t.float(), h.shape[0]))
    g = g.float()[:, None]
    return hc, [g_k * g for g_k in gs]


def reference_dh(name, g, h, weights, biases, t, *, compute_dtype=None):
    """Plain version of K3's first pass: dh = Σ_k bf16(da_k) W_kᵀ."""
    _, das = _weighted_grads(name, g, h, weights, biases, t, compute_dtype)
    dh = 0.0
    for da, w in zip(das, weights):
        dh = dh + _rounded(da, compute_dtype) @ _rounded(w, compute_dtype).T
    return dh


def reference_dw(name, g, h, weights, biases, t, *, compute_dtype=None):
    """Plain version of K3's second pass: (dW_0, db_0, dW_1, db_1, …) with
    dW_k = hᵀ bf16(da_k) and db_k = Σ_rows da_k."""
    hc, das = _weighted_grads(name, g, h, weights, biases, t, compute_dtype)
    return tuple(x for da in das
                 for x in (hc.T @ _rounded(da, compute_dtype), da.sum(0)))


def reference_backward(name, g, h, weights, biases, t, *, compute_dtype=None):
    """Plain version of K3: (dh, dW_0, db_0, …) for row cotangents g (M,)."""
    args = (name, g, h, weights, biases, t)
    return (reference_dh(*args, compute_dtype=compute_dtype),
            *reference_dw(*args, compute_dtype=compute_dtype))


# --------------------------------------------------------------------------
# Plain versions of K4 / K5 (grouped): K2 / K3 per group, lgamma(1 + t)
# always subtracted
# --------------------------------------------------------------------------


def reference_grouped_forward(name, h, weights, biases, t, *,
                              compute_dtype=None):
    """Plain version of K4: the row sums (G, M) of h (G, M, H) against the
    shared targets t (M, F), each group as :func:`reference_forward`."""
    return torch.stack([
        reference_forward(name, h_g, weights, biases, t,
                          compute_dtype=compute_dtype)
        for h_g in h
    ]).reshape(h.shape[:2])


def reference_grouped_dh(name, g, h, weights, biases, t, *,
                         compute_dtype=None):
    """Plain version of K5's first pass: dh (G, M, H), each group as
    :func:`reference_dh` with its row cotangents g (G, M)."""
    return torch.stack([
        reference_dh(name, g_g, h_g, weights, biases, t,
                     compute_dtype=compute_dtype)
        for g_g, h_g in zip(g, h)
    ]).reshape(h.shape)


def reference_grouped_dw(name, g, h, weights, biases, t, *,
                         compute_dtype=None):
    """Plain version of K5's second pass: (dW_0, db_0, dW_1, db_1, …)
    summed over the groups in order, each group as :func:`reference_dw`."""
    total = reference_dw(name, g[0], h[0], weights, biases, t,
                         compute_dtype=compute_dtype)
    for g_g, h_g in zip(g[1:], h[1:]):
        parts = reference_dw(name, g_g, h_g, weights, biases, t,
                             compute_dtype=compute_dtype)
        total = tuple(a + b for a, b in zip(total, parts))
    return total


# --------------------------------------------------------------------------
# Categorised instances: elementwise pieces and plain versions
#
# The K + 1 class-logit heads join the base family's heads; per element
#
#   ll = a_c* − lse(a_0 … a_K) + [t ≥ K]·(base_ll(t − K) − lgamma(1 + t − K))
#
# with c* = min(t, K), dll/da_c = [c = c*] − softmax_c and the base heads'
# gradients masked to t ≥ K.  No unconditional −lgamma(1+t): the constant
# sits inside the shifted branch.
# --------------------------------------------------------------------------


def cat_select_and_lse(cat_acts, t):
    """(logit at class min(t, K), logsumexp over the classes) per element,
    as ``_cat_select_and_lse``: the max first, then the exponentials summed
    in class order; the select steps up one class per threshold."""
    m = cat_acts[0]
    for a in cat_acts[1:]:
        m = torch.maximum(m, a)
    s = torch.exp(cat_acts[0] - m)
    for a in cat_acts[1:]:
        s = s + torch.exp(a - m)
    a_sel = cat_acts[0]
    for c in range(1, len(cat_acts)):
        a_sel = torch.where(t >= c, cat_acts[c], a_sel)
    return a_sel, m + torch.log(s)


def _shifted_base_ll(name, k, base_acts, t):
    """[t ≥ K]·(base_ll(t − K) − lgamma(1 + t − K))."""
    shifted = torch.clamp(t - k, min=0.0)
    base = FAMILIES[name].ll(*base_acts, shifted) - lgamma(1.0 + shifted)
    return torch.where(t >= k, base, 0.0)


def categorised_ll(name, k):
    """Elementwise ``ll(activations, t)`` of the categorised instance over
    base ``name`` with K = ``k`` (``_categorised_ll``); ``activations`` are
    the base heads' then the K + 1 class heads'."""
    n_base = len(FAMILIES[name].heads)

    def ll(activations, t):
        a_sel, lse = cat_select_and_lse(activations[n_base:], t)
        return a_sel - lse + _shifted_base_ll(name, k, activations[:n_base], t)

    return ll


def categorised_grads(name, k):
    """Elementwise ``grads(activations, t, lse)`` (``_categorised_grads``):
    dll/da per head, base heads first, with the class softmax exp(a − lse)
    from the per-element ``lse`` that the forward computed (the JAX package
    recomputes it as exp(a − max)/Σ; the two agree to float32 rounding)."""
    fam = FAMILIES[name]
    n_base = len(fam.heads)

    def grads(activations, t, lse):
        pos = t >= k
        shifted = torch.clamp(t - k, min=0.0)
        base_gs = tuple(torch.where(pos, g_a, 0.0)
                        for g_a in fam.grads(*activations[:n_base], shifted))
        cat_gs = []
        for c, a in enumerate(activations[n_base:]):
            # t is integer-valued, so [min(t, K) = c] ⇔ c ≤ t < c+1 below K
            ind = (t >= c) & (t < c + 1) if c < k else pos
            cat_gs.append(torch.where(ind, 1.0, 0.0) - torch.exp(a - lse))
        return base_gs + tuple(cat_gs)

    return grads


def _class_count(cat_w) -> int:
    return cat_w.shape[0] - 1


def _categorised_ll_lse(name, base_acts, cat_acts, t):
    """Per-element log-likelihood and lse of the categorised instance from
    its base heads' and classes' activations."""
    a_sel, lse = cat_select_and_lse(cat_acts, t)
    ll = a_sel - lse + _shifted_base_ll(name, len(cat_acts) - 1, base_acts, t)
    return ll, lse


def _categorised_elements(name, h, weights, biases, cat_w, cat_b, t,
                          compute_dtype):
    """Per-element log-likelihood and lse (M, F) of the categorised
    instance, rounded like the kernels."""
    n_base = len(FAMILIES[name].heads)
    _, acts = _activations(h, [*weights, *cat_w], [*biases, *cat_b],
                           compute_dtype)
    return _categorised_ll_lse(name, acts[:n_base], acts[n_base:],
                               _cycle_rows(t.float(), h.shape[0]))


def reference_categorised_forward(name, h, weights, biases, cat_w, cat_b, t,
                                  *, compute_dtype=None):
    """Plain version of the categorised K2: (row sums (M,), per-element lse
    (M, F)) for base ``weights`` / ``biases`` in the family's head order and
    class heads ``cat_w`` (K+1, H, F), ``cat_b`` (K+1, F), rounded like the
    kernel."""
    ll, lse = _categorised_elements(name, h, weights, biases, cat_w, cat_b, t,
                                    compute_dtype)
    return torch.sum(ll, dim=-1), lse


def _categorised_weighted_grads(name, g, h, weights, biases, cat_w, cat_b, t,
                                lse, compute_dtype):
    """Rounded h and the row-weighted da of every head (base, then
    classes), the class softmax from the forward's ``lse``."""
    hc, acts = _activations(h, [*weights, *cat_w], [*biases, *cat_b],
                            compute_dtype)
    gs = categorised_grads(name, _class_count(cat_w))(
        acts, _cycle_rows(t.float(), h.shape[0]), lse)
    g = g.float()[:, None]
    return hc, [g_a * g for g_a in gs]


def reference_categorised_dh(name, g, h, weights, biases, cat_w, cat_b, t,
                             lse, *, compute_dtype=None):
    """Plain version of the categorised K3's first pass: dh = Σ bf16(da) Wᵀ
    over every head."""
    _, das = _categorised_weighted_grads(name, g, h, weights, biases, cat_w,
                                         cat_b, t, lse, compute_dtype)
    dh = 0.0
    for da, w in zip(das, [*weights, *cat_w]):
        dh = dh + _rounded(da, compute_dtype) @ _rounded(w, compute_dtype).T
    return dh


def reference_categorised_dw(name, g, h, weights, biases, cat_w, cat_b, t,
                             lse, *, compute_dtype=None):
    """Plain version of the categorised K3's second pass: (dW_0, db_0, …)
    of the base heads, then the class heads' dW (K+1, H, F) and db
    (K+1, F)."""
    hc, das = _categorised_weighted_grads(name, g, h, weights, biases, cat_w,
                                          cat_b, t, lse, compute_dtype)
    grads = [(hc.T @ _rounded(da, compute_dtype), da.sum(0)) for da in das]
    n_base = len(weights)
    return (*(x for pair in grads[:n_base] for x in pair),
            torch.stack([dw for dw, _ in grads[n_base:]]),
            torch.stack([db for _, db in grads[n_base:]]))


def reference_categorised_log_likelihood(name, h, heads, cat_kernel, cat_bias,
                                         t, compute_dtype=None):
    """Unfused computation of the categorised row sums (the JAX package's
    ``reference_categorised_log_likelihood``): exact float32,
    ``compute_dtype`` ignored."""
    del compute_dtype
    fam = FAMILIES[name]
    ws = [heads[p]["kernel"] for p in fam.heads] + list(cat_kernel)
    bs = [heads[p]["bias"] for p in fam.heads] + list(cat_bias)
    acts = tuple(h @ w + b for w, b in zip(ws, bs))
    ll = categorised_ll(name, _class_count(cat_kernel))(acts, t)
    return torch.sum(ll, dim=-1)


# --------------------------------------------------------------------------
# Plain versions of K6 / K7 (constrained Poisson)
# --------------------------------------------------------------------------


def _constrained_poisson_ll_rows(a, t, n):
    """Row sums of the CP log-likelihood from raw activations ``a`` (..., F),
    targets ``t`` and count sums ``n`` (..., 1); rate = softmax_F(a)·n, so

        Σ_f ll = Σ_f (t·a − lgamma(1+t)) − (Σ_f t)(lse − log n) − n."""
    lse = torch.logsumexp(a, dim=-1, keepdim=True)
    sx = torch.sum(t, dim=-1, keepdim=True)
    rows = (torch.sum(t * a - lgamma(1.0 + t), dim=-1, keepdim=True)
            - sx * (lse - torch.log(n)) - n)
    return rows[..., 0]


def reference_cp_forward(h, w, b, t, n):
    """Plain version of K6: (ll (M,), lse (M,)) for h (M, H), W (H, F),
    b (F,), t (M_t, F) and count sums n (M,)."""
    a = h.float() @ w.float() + b.float()
    tt = _cycle_rows(t.float(), h.shape[0])
    ll = _constrained_poisson_ll_rows(a, tt, n.float()[:, None])
    return ll, torch.logsumexp(a, dim=-1)


def _cp_da(g, h, w, b, t, lse):
    """h as float32 and da = g·(t − (Σt)·exp(a − lse))."""
    hf = h.float()
    a = hf @ w.float() + b.float()
    tt = _cycle_rows(t.float(), h.shape[0])
    sx = tt.sum(-1, keepdim=True)
    return hf, g.float()[:, None] * (tt - sx * torch.exp(a - lse[:, None]))


def reference_cp_dh(g, h, w, b, t, lse):
    """Plain version of K7's first pass: dh = da Wᵀ."""
    _, da = _cp_da(g, h, w, b, t, lse)
    return da @ w.float().T


def reference_cp_dw(g, h, w, b, t, lse):
    """Plain version of K7's second pass: (dW, db) = (hᵀ da, Σ_rows da)."""
    hf, da = _cp_da(g, h, w, b, t, lse)
    return hf.T @ da, da.sum(0)


def reference_log_likelihood(name, h, heads, t, count_sum=None,
                             compute_dtype=None):
    """Unfused computation of the same quantity (the JAX package's
    ``reference_log_likelihood``): exact float32, ``compute_dtype``
    accepted for call-site symmetry and ignored."""
    del compute_dtype
    if name == "constrained poisson":
        if count_sum is None:
            raise ValueError("constrained poisson requires count_sum")
        a = h @ heads["lambda"]["kernel"] + heads["lambda"]["bias"]
        return _constrained_poisson_ll_rows(a, t, count_sum)
    if name not in FAMILIES:
        raise ValueError(f"No fused likelihood for {name!r}")
    fam = FAMILIES[name]
    acts = [h @ heads[p]["kernel"] + heads[p]["bias"] for p in fam.heads]
    return torch.sum(fam.ll(*acts, t) - lgamma(1.0 + t), dim=-1)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _round_flag(compute_dtype) -> int:
    if compute_dtype is None:
        return 0
    if compute_dtype == torch.bfloat16:
        return 1
    raise ValueError(f"unsupported compute dtype {compute_dtype}")


def _validated(h, weights, biases, t, *rows):
    """Check the kernels' operands: tensors on one CUDA device, t tiling
    h's rows, heads of shape (H, F) and (F,), and (M,) per-row operands
    ``rows``; returns t as a contiguous float32 or bfloat16 tensor."""
    tensors = (h, *weights, *biases, t, *rows)
    if not all(x.is_cuda and x.device == h.device for x in tensors):
        raise ValueError("all operands must be CUDA tensors on one device")
    m, hidden = h.shape
    f = t.shape[-1]
    if hidden == 0:
        raise ValueError("the decoder output has no hidden units")
    if t.dim() != 2 or t.shape[0] == 0 or m % t.shape[0]:
        raise ValueError(f"t {tuple(t.shape)} does not tile h rows {m}")
    for w, b in zip(weights, biases):
        if tuple(w.shape) != (hidden, f) or tuple(b.shape) != (f,):
            raise ValueError(f"head shapes {tuple(w.shape)}, {tuple(b.shape)} "
                             f"do not match h {tuple(h.shape)} and t "
                             f"{tuple(t.shape)}")
    for x in rows:
        if tuple(x.shape) != (m,):
            raise ValueError(f"row operand {tuple(x.shape)} does not match "
                             f"{m} rows")
    return (t if t.dtype in _T_CODES else t.float()).contiguous()


def _checked_cuda(h, weights, biases, t, *rows):
    """Validate and normalise the kernels' operands: contiguous float32
    tensors on one CUDA device (t may stay bfloat16).  ``rows`` are (M,)
    per-row operands."""
    t = _validated(h, weights, biases, t, *rows)
    f32 = lambda xs: [x.float().contiguous() for x in xs]  # noqa: E731
    return (f32([h])[0], f32(weights), f32(biases), t, *f32(rows))


def _family_heads(name, weights, biases):
    fam = FAMILIES[name]
    if len(weights) != len(fam.heads) or len(biases) != len(fam.heads):
        raise ValueError(f"{name} takes {len(fam.heads)} heads, got "
                         f"{len(weights)} weights and {len(biases)} biases")
    return fam


# --------------------------------------------------------------------------
# bf16 K2 / K3 on the tensor cores (ops/csrc/count_likelihood_tc.cu,
# categorised_likelihood_tc.cu and tc_product.cu)
#
# h and the heads' weights go over in bf16, zero-padded to widths that are
# multiples of 8 (16-byte rows): h (M, Hp) and W (Hp, NH, Fp), the heads side
# by side (for the categorised instances the base heads, then the classes).
# The forwards write row sums per gene tile, which a second pass sums in
# order (the categorised forward also each element's lse).  The backward's
# gradient kernel writes bf16(da) (M, NH·Fp) and per-row-tile column sums of
# da, which the products dh = da Wᵀ and dW = hᵀ da (with db) then read.  A
# product splits its depth over the blocks of a thread-block cluster, which
# sum their tiles in rank order.
# --------------------------------------------------------------------------

TC_GENE_TILE = 64       # genes per heads block (each head)
TC_ROW_TILE = 64        # rows per heads block
TC_PRODUCT_DEPTH = 64   # depth of a product stage (one 128-byte bf16 row)
TC_PRODUCT_ROWS = 128   # rows (dh) or hidden units (dW) per product block
TC_PRODUCT_COLS = 256   # columns per product block; half with promoted sums
TC_MAX_SPLITS = 8       # blocks of a cluster (the portable cap)
TC_MIN_SPLIT_DEPTH = 4  # depth stages per split at least
# Clusters of S product blocks (one block per SM) that the H100 holds at
# once, by S, as cudaOccupancyMaxActiveClusters reported them on an H100
# 80GB HBM3 (a cluster of 7 or 8 is portable, but only 15 fit at once).
TC_CLUSTER_CAPACITY = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                       8: 15}
# Depth of one split above which a product promotes its sums (adds the
# products, summed inside the tensor cores from zeroed registers, to the
# running sums in float32 every 1,024 deep): a running sum kept inside the
# tensor cores truncates later products, by more the deeper the sum
# (tools/product_precision.py reads it against the depth; the checks allow
# 2e-5 of the largest value).
TC_PROMOTE_DEPTH = 4096


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tc_padded(n: int) -> int:
    """Width rounded up to a multiple of 8 (16 bytes of bf16)."""
    return _cdiv(n, 8) * 8


def tc_splits(out_tiles: int, depth: int,
              capacity: dict = TC_CLUSTER_CAPACITY) -> tuple[int, int]:
    """(splits, depth stages per split) of a product with ``out_tiles``
    output blocks over ``depth``: without a split if the tiles fill the
    card, else the most splits (the blocks of a cluster, at most
    :data:`TC_MAX_SPLITS`, none shorter than :data:`TC_MIN_SPLIT_DEPTH`
    stages) whose clusters the card holds at once (``capacity``)."""
    k_tiles = max(1, _cdiv(depth, TC_PRODUCT_DEPTH))
    limit = max(1, min(TC_MAX_SPLITS, k_tiles // TC_MIN_SPLIT_DEPTH))
    want = 1
    while want < limit and out_tiles <= capacity[want + 1]:
        want += 1
    per = _cdiv(k_tiles, want)
    return _cdiv(k_tiles, per), per


def _product_plan(rows: int, cols: int, depth: int,
                  capacity: dict) -> tuple[int, int, bool]:
    """(splits, stages per split, promote) of a rows x cols product over
    ``depth``: promoted sums (and half-width tiles) where one split of
    full-width tiles would sum more than :data:`TC_PROMOTE_DEPTH`."""
    for promote in (False, True):
        cols_per_tile = TC_PRODUCT_COLS // 2 if promote else TC_PRODUCT_COLS
        tiles = _cdiv(rows, TC_PRODUCT_ROWS) * _cdiv(cols, cols_per_tile)
        splits, per = tc_splits(tiles, depth, capacity)
        if promote or per * TC_PRODUCT_DEPTH <= TC_PROMOTE_DEPTH:
            return splits, per, promote
    raise AssertionError("unreachable")


def tc_plan(m: int, hidden: int, f: int, n_heads: int,
            capacity: dict = TC_CLUSTER_CAPACITY) -> dict:
    """Padded widths, grids, scratch shapes and product splits of the
    tensor-core K2/K3 for M = ``m`` rows, H = ``hidden``, F = ``f`` and
    ``n_heads`` heads, on a card that holds ``capacity[S]`` clusters of S
    product blocks at once.  The heads kernels' forwards write ``row_sums``
    partials per gene tile, their gradient kernels ``db_parts`` per row
    tile; ``dh_splits`` / ``dw_splits``: (splits, depth stages per split,
    promote)."""
    hp, fp = tc_padded(hidden), tc_padded(f)
    width = n_heads * fp
    return {
        "hp": hp, "fp": fp,
        "row_sums": (_cdiv(f, TC_GENE_TILE), m),
        "da": (m, width),
        "db_parts": (_cdiv(m, TC_ROW_TILE), width),
        "dh_splits": _product_plan(m, hp, width, capacity),
        "dw_splits": _product_plan(hp, width, m, capacity),
    }


def _tc_operands(h, weights, biases, cat_w=None, cat_b=None):
    """h (M, Hp) and W (Hp, NH, Fp) rounded to bf16 and zero-padded, and
    the float32 biases (NH, F): the base heads, then the class heads
    ``cat_w`` (C, H, F) / ``cat_b`` (C, F) if given."""
    m, hidden = h.shape
    f = weights[0].shape[1]
    hp, fp = tc_padded(hidden), tc_padded(f)
    n_base = len(weights)
    n_heads = n_base + (0 if cat_w is None else cat_w.shape[0])
    bf16 = torch.bfloat16
    if hp == hidden:
        hb = h.to(bf16).contiguous()
    else:
        hb = torch.zeros((m, hp), dtype=bf16, device=h.device)
        hb[:, :hidden] = h
    padded = (hp, fp) != (hidden, f)
    w = (torch.zeros if padded else torch.empty)(
        (hp, n_heads, fp), dtype=bf16, device=h.device)
    for k, w_k in enumerate(weights):
        w[:hidden, k, :f] = w_k
    b = torch.stack([b_k.float() for b_k in biases])
    if cat_w is not None:
        w[:hidden, n_base:, :f] = cat_w.permute(1, 0, 2)
        b = torch.cat([b, cat_b.float()])
    return hb, w, b.contiguous()


def _tc_forward(fam, h, weights, biases, t, include_lgamma_const):
    t = _validated(h, weights, biases, t)
    m, hidden = h.shape
    f = t.shape[1]
    plan = tc_plan(m, hidden, f, len(weights))
    hb, w, b = _tc_operands(h, weights, biases)
    out = torch.empty((m,), dtype=torch.float32, device=h.device)
    part = torch.empty(plan["row_sums"], dtype=torch.float32, device=h.device)
    extension.call(
        "scvae_tc_forward", h.device, fam.code, hb.data_ptr(), w.data_ptr(),
        b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], part.data_ptr(),
        out.data_ptr(), m, t.shape[0], plan["hp"], f,
        int(include_lgamma_const),
    )
    LAUNCHES[f"{fam.prefix}_forward"] += 1
    return out


def cat_tc_forward(name, h, weights, biases, cat_w, cat_b, t):
    """Launch the categorised bf16 K2 over base ``name`` (the base heads,
    then the class heads ``cat_w`` (C, H, F) / ``cat_b`` (C, F)): (row sums
    (M,), lse (M, F), the row-sum partials per gene tile (F tiles, M) that
    the row sums add up in order)."""
    fam, h, weights, biases, t, (cat_w, cat_b) = _checked_categorised(
        name, h, weights, biases, cat_w, cat_b, t)
    m, hidden = h.shape
    f = t.shape[1]
    n_classes = cat_w.shape[0]
    plan = tc_plan(m, hidden, f, len(weights) + n_classes)
    hb, w, b = _tc_operands(h, weights, biases, cat_w, cat_b)
    dev = h.device
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    lse = torch.empty((m, f), dtype=torch.float32, device=dev)
    part = torch.empty(plan["row_sums"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cat_tc_forward", dev, fam.code, hb.data_ptr(), w.data_ptr(),
        b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], part.data_ptr(),
        out.data_ptr(), lse.data_ptr(), m, t.shape[0], plan["hp"], f,
        n_classes,
    )
    LAUNCHES[f"cat_{fam.prefix}_forward"] += 1
    return out, lse, part


def reference_cat_tc_forward(name, h, weights, biases, cat_w, cat_b, t):
    """Plain version of :func:`cat_tc_forward` in its layout: (the row sums
    per gene tile (F tiles, M), lse (M, F)), bf16 operands."""
    _family_heads(name, weights, biases)
    ll, lse = _categorised_elements(name, h, weights, biases, cat_w, cat_b, t,
                                    torch.bfloat16)
    return _gene_tile_sums(ll), lse


def _gene_tile_sums(ll):
    """The forwards' row-sum partials (F tiles, M) of elements ``ll``."""
    m, f = ll.shape
    tiles = _cdiv(f, TC_GENE_TILE)
    padded = torch.zeros((m, tiles * TC_GENE_TILE), dtype=torch.float32,
                         device=ll.device)
    padded[:, :f] = ll
    return padded.reshape(m, tiles, TC_GENE_TILE).sum(-1).T


@dataclasses.dataclass
class TcGradient:
    """The backward's first kernel's outputs: bf16 h and W as the products
    read them, bf16(da) (M, NH·Fp) and da's column sums per row tile; and
    the launch-count prefix and suffix of its products."""

    prefix: str
    plan: dict
    hidden: int
    f: int
    h: torch.Tensor
    w: torch.Tensor
    da: torch.Tensor
    db_parts: torch.Tensor
    suffix: str = ""


def tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Launch the backward's first kernel (the heads' products and da) of
    family ``name`` for row cotangents ``g``."""
    fam = _family_heads(name, weights, biases)
    t = _validated(h, weights, biases, t, g)
    m, hidden = h.shape
    f = t.shape[1]
    plan = tc_plan(m, hidden, f, len(weights))
    hb, w, b = _tc_operands(h, weights, biases)
    dev = h.device
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    g = g.float().contiguous()
    extension.call(
        "scvae_tc_gradient", dev, fam.code, g.data_ptr(), hb.data_ptr(),
        w.data_ptr(), b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        da.data_ptr(), db_parts.data_ptr(), m, t.shape[0], plan["hp"], f,
    )
    LAUNCHES[f"{fam.prefix}_backward_gradient"] += 1
    return TcGradient(fam.prefix, plan, hidden, f, hb, w, da, db_parts)


def cat_tc_gradient(name, g, h, weights, biases, cat_w, cat_b, t,
                    lse) -> TcGradient:
    """Launch the categorised backward's first kernel over base ``name``:
    every head's products and da (the classes' softmax from the forward's
    ``lse``) for row cotangents ``g``."""
    fam, h, weights, biases, t, (g, cat_w, cat_b, lse) = _checked_categorised(
        name, h, weights, biases, cat_w, cat_b, t, g, lse)
    m, hidden = h.shape
    f = t.shape[1]
    n_classes = cat_w.shape[0]
    plan = tc_plan(m, hidden, f, len(weights) + n_classes)
    hb, w, b = _tc_operands(h, weights, biases, cat_w, cat_b)
    dev = h.device
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cat_tc_gradient", dev, fam.code, g.data_ptr(),
        hb.data_ptr(), w.data_ptr(), b.data_ptr(), t.data_ptr(),
        _T_CODES[t.dtype], lse.data_ptr(), da.data_ptr(), db_parts.data_ptr(),
        m, t.shape[0], plan["hp"], f, n_classes,
    )
    LAUNCHES[f"cat_{fam.prefix}_backward_gradient"] += 1
    return TcGradient(f"cat_{fam.prefix}", plan, hidden, f, hb, w, da,
                      db_parts)


def tc_dh(grad: TcGradient) -> torch.Tensor:
    """dh (M, H) = Σ_k bf16(da_k) W_kᵀ from the first kernel's outputs."""
    plan, (m, width) = grad.plan, grad.da.shape
    dev = grad.da.device
    splits, per, promote = plan["dh_splits"]
    dh = torch.empty((m, grad.hidden), dtype=torch.float32, device=dev)
    extension.call(
        "scvae_tc_dh", dev, grad.da.data_ptr(), grad.w.data_ptr(),
        dh.data_ptr(), m, grad.hidden, plan["hp"], width, splits, per,
        int(promote),
    )
    LAUNCHES[f"{grad.prefix}_backward_dh{grad.suffix}"] += 1
    return dh


def tc_dw_stacked(grad: TcGradient) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW (NH, H, F), db (NH, F)) with dW_k = hᵀ bf16(da_k) and db_k =
    Σ_rows da_k, from the first kernel's outputs.  The product's depth is
    the rows of ``grad.h``, over which ``grad.da`` lies as rows of NH·Fp
    (the constrained Poisson's: NH = 1 over its pairs of terms)."""
    plan, m = grad.plan, grad.h.shape[0]
    n_heads = grad.db_parts.shape[1] // plan["fp"]
    dev = grad.da.device
    shapes = ((n_heads, grad.hidden, grad.f), (n_heads, grad.f))
    if m == 0:
        return tuple(torch.zeros(s, dtype=torch.float32, device=dev)
                     for s in shapes)
    dw, db = (torch.empty(s, dtype=torch.float32, device=dev) for s in shapes)
    splits, per, promote = plan["dw_splits"]
    extension.call(
        "scvae_tc_dw", dev, grad.h.data_ptr(), grad.da.data_ptr(),
        grad.db_parts.data_ptr(), dw.data_ptr(), db.data_ptr(), n_heads, m,
        grad.hidden, plan["hp"], grad.f, splits, per, plan["db_parts"][0],
        int(promote),
    )
    LAUNCHES[f"{grad.prefix}_backward_dw{grad.suffix}"] += 1
    return dw, db


def tc_dw(grad: TcGradient) -> tuple[torch.Tensor, ...]:
    """(dW_0, db_0, dW_1, db_1, …) of :func:`tc_dw_stacked`."""
    dw, db = tc_dw_stacked(grad)
    return tuple(x for k in range(dw.shape[0]) for x in (dw[k], db[k]))


def _reference_scratch(prefix, plan, hidden, f, hb, w, das,
                       groups=1) -> TcGradient:
    """The gradient kernels' outputs from the float32 da of every head:
    bf16(da) (M, NH·Fp), zero past F, and da's column sums per row tile;
    over ``groups`` group-major blocks of rows, the sums of every group per
    row tile of a block."""
    m = hb.shape[0]
    da = torch.zeros((m, len(das), plan["fp"]), dtype=torch.float32,
                     device=hb.device)
    da[:, :, :f] = torch.stack(das, 1)
    da = da.reshape(plan["da"])
    tiles = plan["db_parts"][0]
    rows = torch.zeros((tiles * TC_ROW_TILE, da.shape[1]),
                       dtype=torch.float32, device=hb.device)
    rows[:m // groups] = da.reshape(groups, m // groups, da.shape[1]).sum(0)
    db_parts = rows.reshape(tiles, TC_ROW_TILE, -1).sum(1)
    return TcGradient(prefix, plan, hidden, f, hb, w, da.to(torch.bfloat16),
                      db_parts)


def reference_tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Plain version of :func:`tc_gradient`, with the same layout: bf16(da)
    (M, NH·Fp), zero past F, and da's column sums per row tile."""
    fam = _family_heads(name, weights, biases)
    m, hidden = h.shape
    f = t.shape[-1]
    plan = tc_plan(m, hidden, f, len(weights))
    hb, w, _ = _tc_operands(h, weights, biases)
    _, das = _weighted_grads(name, g, h, weights, biases, t, torch.bfloat16)
    return _reference_scratch(fam.prefix, plan, hidden, f, hb, w, das)


def reference_cat_tc_gradient(name, g, h, weights, biases, cat_w, cat_b, t,
                              lse) -> TcGradient:
    """Plain version of :func:`cat_tc_gradient`, with the same layout: the
    base heads' and then the classes' bf16(da) (M, NH·Fp), zero past F, and
    da's column sums per row tile."""
    fam = _family_heads(name, weights, biases)
    m, hidden = h.shape
    f = t.shape[-1]
    plan = tc_plan(m, hidden, f, len(weights) + cat_w.shape[0])
    hb, w, _ = _tc_operands(h, weights, biases, cat_w, cat_b)
    _, das = _categorised_weighted_grads(name, g, h, weights, biases, cat_w,
                                         cat_b, t, lse, torch.bfloat16)
    return _reference_scratch(f"cat_{fam.prefix}", plan, hidden, f, hb, w,
                              das)


def reference_tc_dh(grad: TcGradient) -> torch.Tensor:
    """Plain version of :func:`tc_dh`: the float32 product of the same
    bf16 operands."""
    w = grad.w.float().reshape(grad.w.shape[0], -1)
    return (grad.da.float() @ w.T)[:, :grad.hidden]


def reference_tc_dw_stacked(grad: TcGradient):
    """Plain version of :func:`tc_dw_stacked`: the float32 product of the
    same bf16 operands and the sum of the row tiles' column sums."""
    fp = grad.plan["fp"]
    n_heads = grad.db_parts.shape[1] // fp
    da = grad.da.float().reshape(grad.h.shape[0], -1)
    dw = (grad.h.float().T @ da).reshape(-1, n_heads, fp)
    db = grad.db_parts.sum(0).reshape(n_heads, fp)
    return (dw[:grad.hidden, :, :grad.f].permute(1, 0, 2),
            db[:, :grad.f])


def reference_tc_dw(grad: TcGradient) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`tc_dw`."""
    dw, db = reference_tc_dw_stacked(grad)
    return tuple(x for k in range(dw.shape[0]) for x in (dw[k], db[k]))


# --------------------------------------------------------------------------
# bf16 K6 / K7 on the tensor cores (ops/csrc/cp_likelihood_tc.cu, then the
# products of tc_product.cu)
#
# The JAX kernels multiply h, which holds bf16 values when training in bf16,
# by the unrounded float32 W, and the backward multiplies the float32 da.  So
# W and da go to the tensor cores as sums of bf16 terms: x_0 = bf16(x),
# x_1 = bf16(x − x_0), …, each term the bf16 rounding of what the terms
# before it leave (an exact float32 difference), so that two terms leave at
# most 2⁻¹⁶|x| and three 2⁻²⁴|x| (bf16 keeps 8 significant bits).  The
# products multiply the pairs of terms (da_i, W_j) with i + j < CP_TERMS,
# laid along the depth of one product; with two terms
#
#   a  = h W_0 + h W_1 + b                     (float32 sums, term order)
#   dh = [da_0 | da_0 | da_1] [W_0 | W_1 | W_0]ᵀ
#   dW = hᵀ da_0 + hᵀ da_1,  db = Σ_rows da    (da unrounded for db)
#
# W's terms sit in _tc_operands' heads layout W (Hp, P, Fp), one head per
# pair holding its W_j: the first CP_TERMS heads are W_0, W_1, …, which the
# forward reads.  The gradient kernel recomputes a exactly as the forward
# did, so exp(a − lse) uses the very a that the forward summed, and writes
# each pair's da_i into a (M, P·Fp) scratch, which dh reads as it lies and
# dW as P·M rows of Fp against h repeated once per pair, zero where the
# pair's j > 0 (each da_i counted once).  tools/cp_split_precision.py reads
# the errors against the number of terms (PERF.md); the kernels fix two.
# --------------------------------------------------------------------------

CP_TERMS = 2  # bf16 terms of W and of da (kCpTerms in the kernels)
# the (da term, W term) pairs (i, j) with i + j < CP_TERMS that the products
# multiply, by i, then j
CP_TERM_PAIRS = tuple((i, j) for i in range(CP_TERMS)
                      for j in range(CP_TERMS - i))
CP_PARTIALS = 4  # per row and gene tile: max a, Σ exp(a − max), Σ ll, Σ t


def split_bf16(x: torch.Tensor, terms: int = CP_TERMS) -> list[torch.Tensor]:
    """``terms`` bf16 tensors whose float32 sum approximates x: x_0 =
    bf16(x), x_k = bf16(x − x_0 − … − x_(k−1))."""
    rest = x.float()
    out = [rest.to(torch.bfloat16)]
    for _ in range(terms - 1):
        rest = rest - out[-1]  # exact: float32 less its own bf16 rounding
        out.append(rest.to(torch.bfloat16))
    return out


def cp_tc_plan(m: int, hidden: int, f: int,
               capacity: dict = TC_CLUSTER_CAPACITY) -> dict:
    """:func:`tc_plan` of the bf16 CP kernels: the forward's ``partials``
    (CP_PARTIALS, F tiles, M), the da scratch (M, P·Fp) of the P pairs of
    terms, db's ``db_parts`` (row tiles, Fp), and the products' splits (dh
    over depth P·Fp, dW over P·M rows)."""
    pairs = len(CP_TERM_PAIRS)
    plan = tc_plan(m, hidden, f, pairs, capacity)
    del plan["row_sums"]
    plan.update(
        partials=(CP_PARTIALS, _cdiv(f, TC_GENE_TILE), m),
        db_parts=(_cdiv(m, TC_ROW_TILE), plan["fp"]),
        dw_splits=_product_plan(plan["hp"], plan["fp"], pairs * m, capacity),
    )
    return plan


def _cp_tc_operands(h, w, b):
    """bf16 h (M, Hp) and W's terms per pair (Hp, P, Fp), zero-padded, and
    b (1, F) in float32."""
    hidden, f = w.shape
    hp, fp = tc_padded(hidden), tc_padded(f)
    hb = h.to(torch.bfloat16)
    if hp != hidden:
        hb = torch.nn.functional.pad(hb, (0, hp - hidden))
    w_terms = split_bf16(w)
    w_pairs = torch.stack([w_terms[j] for _, j in CP_TERM_PAIRS], 1)
    if (hp, fp) != (hidden, f):
        w_pairs = torch.nn.functional.pad(w_pairs,
                                          (0, fp - f, 0, 0, 0, hp - hidden))
    return hb.contiguous(), w_pairs, b.float().reshape(1, f).contiguous()


def _cp_dw_rows(hb: torch.Tensor) -> torch.Tensor:
    """The dW product's rows (M·P, Hp): h once per pair, zero where the
    pair's W term is not the first."""
    zeros = torch.zeros_like(hb)
    rows = [hb if j == 0 else zeros for _, j in CP_TERM_PAIRS]
    return torch.stack(rows, 1).reshape(-1, hb.shape[1])


def _cp_tc_activations(h, w, b):
    """a (M, F): h's bf16 values times each W term, summed in float32 in
    term order, then b."""
    hf = h.to(torch.bfloat16).float()
    a = 0.0
    for w_j in split_bf16(w):
        a = a + hf @ w_j.float()
    return a + b.float()


def _cp_merge(partials, n):
    """(ll, lse) per row from the partials (CP_PARTIALS, F tiles, M), merged
    tile by tile in order: (m, s) + (m', s') = (M, s e^(m − M) +
    s' e^(m' − M))."""
    mx, se, acc, sx = (p[0] for p in partials)
    for k in range(1, partials.shape[1]):
        m_k, s_k, acc_k, sx_k = (p[k] for p in partials)
        mm = torch.maximum(mx, m_k)
        se = se * torch.exp(mx - mm) + s_k * torch.exp(m_k - mm)
        mx, acc, sx = mm, acc + acc_k, sx + sx_k
    lse = mx + torch.log(se)
    n = n.float()
    return acc - sx * (lse - torch.log(n)) - n, lse


def reference_cp_tc_forward(h, w, b, t, n):
    """Plain version of :func:`cp_tc_forward`, with its layout: (ll (M,),
    lse (M,), partials (CP_PARTIALS, F tiles, M)), the partials per gene
    tile of each row being the max of a, Σ exp(a − max), Σ (t·a −
    lgamma(1 + t)) and Σ t over the tile's genes."""
    return _cp_forward_partials(_cp_tc_activations(h, w, b), t, n)


def _cp_forward_partials(a, t, n):
    """(ll, lse, partials per gene tile) of the CP forwards from the
    activations ``a`` (M, F)."""
    m, f = a.shape
    tiles = _cdiv(f, TC_GENE_TILE)
    tt = _cycle_rows(t.float(), m)

    def tiled(x, fill):
        out = torch.full((m, tiles * TC_GENE_TILE), fill, dtype=torch.float32,
                         device=a.device)
        out[:, :f] = x
        return out.reshape(m, tiles, TC_GENE_TILE)

    at = tiled(a, -math.inf)
    tile_max = at.amax(-1)
    partials = torch.stack([
        tile_max,
        torch.exp(at - tile_max[..., None]).sum(-1),
        tiled(tt * a - lgamma(1.0 + tt), 0.0).sum(-1),
        tiled(tt, 0.0).sum(-1),
    ]).transpose(1, 2).contiguous()
    return (*_cp_merge(partials, n), partials)


def reference_cp_tc_gradient(g, h, w, b, t, lse) -> TcGradient:
    """Plain version of :func:`cp_tc_gradient`, with its layout: da =
    g·(t − (Σt)·exp(a − lse)) split into bf16 terms, da_i per pair
    (M, P·Fp), zero past F, and the column sums of the unrounded da per row
    tile (row tiles, Fp); h as the dW product reads it."""
    m, hidden = h.shape
    f = t.shape[-1]
    plan = cp_tc_plan(m, hidden, f)
    hb, w_pairs, _ = _cp_tc_operands(h, w, b)
    tt = _cycle_rows(t.float(), m)
    a = _cp_tc_activations(h, w, b)
    padded = torch.zeros((m, plan["fp"]), dtype=torch.float32, device=a.device)
    padded[:, :f] = g.float()[:, None] * (
        tt - tt.sum(-1, keepdim=True) * torch.exp(a - lse.float()[:, None]))
    da_terms = split_bf16(padded)
    da = torch.stack([da_terms[i] for i, _ in CP_TERM_PAIRS], 1)
    tiles = plan["db_parts"][0]
    rows = torch.zeros((tiles * TC_ROW_TILE, plan["fp"]), dtype=torch.float32,
                       device=a.device)
    rows[:m] = padded
    db_parts = rows.reshape(tiles, TC_ROW_TILE, -1).sum(1)
    return TcGradient("cp", plan, hidden, f, _cp_dw_rows(hb), w_pairs,
                      da.reshape(plan["da"]), db_parts)


def cp_tc_forward(h, w, b, t, n):
    """Launch the bf16 K6 (``h`` a bf16 tensor, W float32): (ll (M,), lse
    (M,), the partials per gene tile (CP_PARTIALS, F tiles, M) that a
    second kernel merges in order)."""
    t = _validated(h, [w], [b], t, n)
    m, hidden = h.shape
    f = t.shape[1]
    plan = cp_tc_plan(m, hidden, f)
    hb, w_pairs, b2 = _cp_tc_operands(h, w, b)
    dev = h.device
    n = n.float().contiguous()
    ll, lse = (torch.empty((m,), dtype=torch.float32, device=dev)
               for _ in range(2))
    partials = torch.empty(plan["partials"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cp_tc_forward", dev, hb.data_ptr(), w_pairs.data_ptr(),
        b2.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], n.data_ptr(),
        partials.data_ptr(), ll.data_ptr(), lse.data_ptr(), m, t.shape[0],
        plan["hp"], f,
    )
    LAUNCHES["cp_forward"] += 1
    return ll, lse, partials


def cp_tc_gradient(g, h, w, b, t, lse) -> TcGradient:
    """Launch the bf16 K7's first kernel for row cotangents ``g`` and the
    forward's ``lse``: the activations again, the da terms per pair and the
    column sums of da per row tile, for the products :func:`tc_dh` and
    :func:`tc_dw`."""
    t = _validated(h, [w], [b], t, g, lse)
    m, hidden = h.shape
    f = t.shape[1]
    plan = cp_tc_plan(m, hidden, f)
    hb, w_pairs, b2 = _cp_tc_operands(h, w, b)
    dev = h.device
    g, lse = g.float().contiguous(), lse.float().contiguous()
    # Σ_f t per target row, a plain reduction outside the kernels as in the
    # JAX package's backward
    sx = t.sum(-1, dtype=torch.float32)
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cp_tc_gradient", dev, g.data_ptr(), hb.data_ptr(),
        w_pairs.data_ptr(), b2.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        lse.data_ptr(), sx.data_ptr(), da.data_ptr(), db_parts.data_ptr(), m,
        t.shape[0], plan["hp"], f,
    )
    LAUNCHES["cp_backward_gradient"] += 1
    return TcGradient("cp", plan, hidden, f, _cp_dw_rows(hb), w_pairs, da,
                      db_parts)


# --------------------------------------------------------------------------
# float32 K2 / K3 on the tensor cores: the base families'
# (ops/csrc/count_likelihood_tc.cu's heads kernels over depth segments) and
# the categorised instances' (categorised_likelihood_tc.cu's forward and
# gradient kernel over the same segments, the base heads then the classes,
# NH = base heads + K + 1), then the products of tc_product.cu; and the
# constrained Poisson's float32 K6 / K7 likewise (cp_likelihood_tc.cu's
# forward, merge and gradient kernel over the same segments, NH = 1)
#
# JAX multiplies float32 h and W, and the backward the float32 da.  So each
# goes to the tensor cores as SPLIT_TERMS = 3 bf16 terms (split_bf16; the
# float32 entries split h and W on the card, split_pack_kernel, and the
# gradient kernel splits da), and a product x y as the pairs of terms
# (x_i, y_j) with i + j < SPLIT_TERMS (P = 6 pairs, by i then j).  One
# operand of the three (h, W, da) must be laid out twice, since each
# product pairs two of them and every pair takes one term of each; h is the
# smallest.  Slot p of each layout holds:
#
#   H  (M, P, Hp)        h_j of pair p (i, j)
#   W  (Hp, P, NH, Fp)   every head's W_j of pair p; so W_i in block i < T,
#                        as the first T pairs are (0, j)
#   da (M, P, NH, Fp)    da_i of pair p
#
#   a_k = Σ_p H_p W_k,(i of p) + b_k   the heads kernel's depth runs over
#                                    the slots of H, slot p against W's
#                                    block i of p: Σ over the pairs h_j W_i,
#                                    summed in float32 in pair order
#   dh  = da Wᵀ                      over the depth P·NH·Fp: Σ da_i W_jᵀ
#   dW  = Hᵀ da                      H and da read as P·M rows: Σ h_jᵀ da_i
#   db  = Σ_rows da                  from the unrounded da
#
# The gradient kernel recomputes a exactly as the forward summed it.
# tools/f32_split_precision.py reads the errors against the number of terms
# (PERF.md): two terms of each miss the 2e-5 checks where the activations
# reach the exponentials' clip; the kernels fix three (kSplitTerms in
# tc_common.cuh).
# --------------------------------------------------------------------------

SPLIT_TERMS = 3  # bf16 terms of h, W and da (kSplitTerms in the kernels)
# the pairs of terms (i, j) with i + j < SPLIT_TERMS, by i then j
SPLIT_PAIRS = tuple((i, j) for i in range(SPLIT_TERMS)
                    for j in range(SPLIT_TERMS - i))


def f32_tc_plan(m: int, hidden: int, f: int, n_heads: int,
                capacity: dict = TC_CLUSTER_CAPACITY) -> dict:
    """:func:`tc_plan` of the float32 K2/K3: the forward's ``row_sums``
    (F tiles, M), the da scratch (M, P·NH·Fp) of the P pairs, db's
    ``db_parts`` (row tiles, NH·Fp), and the products' splits (dh over
    depth P·NH·Fp, dW over P·M rows of NH·Fp)."""
    pairs = len(SPLIT_PAIRS)
    plan = tc_plan(m, hidden, f, pairs * n_heads, capacity)
    width = n_heads * plan["fp"]
    plan.update(
        db_parts=(_cdiv(m, TC_ROW_TILE), width),
        dw_splits=_product_plan(plan["hp"], width, pairs * m, capacity),
    )
    return plan


def _f32_tc_operands(h, weights, cat_w=None):
    """h's bf16 terms per pair (M, P, Hp) and the heads' W terms per pair
    (Hp, P, NH, Fp), zero-padded, the base heads, then the class heads
    ``cat_w`` (C, H, F) if given: the plain version of the split that the
    float32 kernels' entries make (``split_pack_kernel``)."""
    m, hidden = h.shape
    f = weights[0].shape[1]
    hp, fp = tc_padded(hidden), tc_padded(f)
    h_terms = split_bf16(h, SPLIT_TERMS)
    hh = torch.stack([h_terms[j] for _, j in SPLIT_PAIRS], 1)
    w = torch.stack(list(weights), 1)
    if cat_w is not None:
        w = torch.cat([w, cat_w.permute(1, 0, 2)], 1)
    w_terms = split_bf16(w, SPLIT_TERMS)
    w = torch.stack([w_terms[j] for _, j in SPLIT_PAIRS], 1)
    if hp != hidden:
        hh = torch.nn.functional.pad(hh, (0, hp - hidden))
    if (hp, fp) != (hidden, f):
        w = torch.nn.functional.pad(w, (0, fp - f, 0, 0, 0, 0, 0, hp - hidden))
    return hh.contiguous(), w.contiguous()


def _f32_tc_activations(h, weights, biases):
    """a_k (M, F) of the split design: Σ over the pairs (i, j) of h_j W_k,i
    in the kernels' order, float32 sums, then b_k."""
    h_terms = [x.float() for x in split_bf16(h, SPLIT_TERMS)]
    acts = []
    for w, b in zip(weights, biases):
        w_terms = [x.float() for x in split_bf16(w, SPLIT_TERMS)]
        a = 0.0
        for i, j in SPLIT_PAIRS:
            a = a + h_terms[j] @ w_terms[i]
        acts.append(a + b.float())
    return acts


def reference_f32_tc_forward(name, h, weights, biases, t, *,
                             include_lgamma_const=True):
    """Plain version of :func:`f32_tc_forward`: the row sums (M,) of the
    split design's activations."""
    fam = _family_heads(name, weights, biases)
    acts = _f32_tc_activations(h, weights, biases)
    tt = _cycle_rows(t.float(), h.shape[0])
    ll = fam.ll(*acts, tt)
    if include_lgamma_const:
        ll = ll - lgamma(1.0 + tt)
    return torch.sum(ll, dim=-1)


def reference_f32_tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Plain version of :func:`f32_tc_gradient`, with its layout: da_k =
    g·∂ll/∂a_k from the split design's activations, split into bf16 terms,
    da_(i of pair p) in slot p (M, P·NH·Fp), zero past F; the column sums
    of the unrounded da per row tile (row tiles, NH·Fp); h's terms per pair
    as the dW product reads them (P·M, Hp), and W's (Hp, P, NH, Fp)."""
    fam = _family_heads(name, weights, biases)
    acts = _f32_tc_activations(h, weights, biases)
    gs = fam.grads(*acts, _cycle_rows(t.float(), h.shape[0]))
    return _f32_tc_reference_scratch(fam.prefix, g, h, weights, gs,
                                     t.shape[-1])


def _f32_tc_reference_scratch(prefix, g, h, weights, gs, f, cat_w=None,
                              plan=None, groups=1) -> TcGradient:
    """The float32 gradient kernels' outputs in their layout from the
    per-head ∂ll/∂a ``gs`` (base heads, then the classes of ``cat_w``);
    over ``groups`` group-major blocks of rows (``plan`` the grouped one),
    da's column sums of every group per row tile of a block."""
    m, hidden = h.shape
    n_heads = len(gs)
    if plan is None:
        plan = f32_tc_plan(m, hidden, f, n_heads)
    hh, w = _f32_tc_operands(h, weights, cat_w)
    fp = plan["fp"]
    padded = torch.zeros((m, n_heads, fp), dtype=torch.float32,
                         device=h.device)
    padded[:, :, :f] = torch.stack(gs, 1) * g.float()[:, None, None]
    da_terms = split_bf16(padded, SPLIT_TERMS)
    da = torch.stack([da_terms[i] for i, _ in SPLIT_PAIRS], 1)
    tiles = plan["db_parts"][0]
    rows = torch.zeros((tiles * TC_ROW_TILE, n_heads * fp),
                       dtype=torch.float32, device=h.device)
    rows[:m // groups] = padded.reshape(groups, m // groups, -1).sum(0)
    db_parts = rows.reshape(tiles, TC_ROW_TILE, -1).sum(1)
    return TcGradient(prefix, plan, hidden, f, hh.reshape(-1, plan["hp"]),
                      w, da.reshape(plan["da"]), db_parts, "_float32")


def reference_cat_f32_tc_forward(name, h, weights, biases, cat_w, cat_b, t):
    """Plain version of :func:`cat_f32_tc_forward`: (row sums (M,), lse
    (M, F), the row sums per gene tile (F tiles, M)) from the split
    design's activations, the base heads' then the classes'."""
    n_base = len(_family_heads(name, weights, biases).heads)
    acts = _f32_tc_activations(h, [*weights, *cat_w], [*biases, *cat_b])
    ll, lse = _categorised_ll_lse(name, acts[:n_base], acts[n_base:],
                                  _cycle_rows(t.float(), h.shape[0]))
    return ll.sum(-1), lse, _gene_tile_sums(ll)


def reference_cat_f32_tc_gradient(name, g, h, weights, biases, cat_w, cat_b,
                                  t, lse) -> TcGradient:
    """Plain version of :func:`cat_f32_tc_gradient`, with its layout (see
    :func:`reference_f32_tc_gradient`): every head's da, the base heads'
    then the classes' (their softmax from the forward's ``lse``)."""
    fam = _family_heads(name, weights, biases)
    acts = _f32_tc_activations(h, [*weights, *cat_w], [*biases, *cat_b])
    gs = categorised_grads(name, _class_count(cat_w))(
        acts, _cycle_rows(t.float(), h.shape[0]), lse)
    return _f32_tc_reference_scratch(f"cat_{fam.prefix}", g, h, weights, gs,
                                     t.shape[-1], cat_w)


def _f32_tc_scratch(plan, m, n_heads, device):
    """The float32 entries' split of h (M, P, Hp) and of the heads' W
    (Hp, P, NH, Fp), which the kernels write and the products read."""
    pairs, hp, fp = len(SPLIT_PAIRS), plan["hp"], plan["fp"]
    return (torch.empty((m, pairs, hp), dtype=torch.bfloat16, device=device),
            torch.empty((hp, pairs, n_heads, fp), dtype=torch.bfloat16,
                        device=device))


def _weight_pointers(weights):
    """w0, w1, w2 pointers; null past the family's heads."""
    pointers = [w.data_ptr() for w in weights]
    return pointers + [None] * (_MAX_HEADS - len(pointers))


def f32_tc_forward(name, h, weights, biases, t, include_lgamma_const=True):
    """Launch the float32 K2 of family ``name`` on the tensor cores: h and
    W split into their bf16 terms per pair, then the row sums (M,) of the
    terms multiplied pair by pair."""
    fam = _family_heads(name, weights, biases)
    h, weights, biases, t = _checked_cuda(h, weights, biases, t)
    m, hidden = h.shape
    f = t.shape[1]
    out = torch.empty((m,), dtype=torch.float32, device=h.device)
    if m == 0:
        return out
    plan = f32_tc_plan(m, hidden, f, len(weights))
    hh, w = _f32_tc_scratch(plan, m, len(weights), h.device)
    b = torch.stack(biases)
    part = torch.empty(plan["row_sums"], dtype=torch.float32, device=h.device)
    extension.call(
        "scvae_tc_f32_forward", h.device, fam.code, h.data_ptr(),
        *_weight_pointers(weights), b.data_ptr(), t.data_ptr(),
        _T_CODES[t.dtype], hh.data_ptr(), w.data_ptr(), part.data_ptr(),
        out.data_ptr(), m, t.shape[0], hidden, f, int(include_lgamma_const),
    )
    LAUNCHES[f"{fam.prefix}_forward_float32"] += 1
    return out


def f32_tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Launch the float32 K3's first kernel of family ``name`` for row
    cotangents ``g``: h and W split into their bf16 terms per pair, the
    activations as the forward summed them, da's bf16 terms per pair and
    da's column sums per row tile, for :func:`tc_dh` and :func:`tc_dw`
    (counted with the "_float32" suffix)."""
    fam = _family_heads(name, weights, biases)
    h, weights, biases, t, g = _checked_cuda(h, weights, biases, t, g)
    m, hidden = h.shape
    f = t.shape[1]
    plan = f32_tc_plan(m, hidden, f, len(weights))
    dev = h.device
    hh, w = _f32_tc_scratch(plan, m, len(weights), dev)
    b = torch.stack(biases)
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_tc_f32_gradient", dev, fam.code, g.data_ptr(), h.data_ptr(),
        *_weight_pointers(weights), b.data_ptr(), t.data_ptr(),
        _T_CODES[t.dtype], hh.data_ptr(), w.data_ptr(), da.data_ptr(),
        db_parts.data_ptr(), m, t.shape[0], hidden, f,
    )
    LAUNCHES[f"{fam.prefix}_backward_gradient_float32"] += 1
    return TcGradient(fam.prefix, plan, hidden, f, hh.reshape(-1, plan["hp"]),
                      w, da, db_parts, "_float32")


def cat_f32_tc_forward(name, h, weights, biases, cat_w, cat_b, t):
    """Launch the categorised float32 K2 over base ``name`` on the tensor
    cores: h and every head's W (the base heads, then the classes of
    ``cat_w`` (C, H, F)) split into their bf16 terms per pair, then (row
    sums (M,), lse (M, F), the row-sum partials per gene tile (F tiles,
    M)) of the terms multiplied pair by pair."""
    fam, h, weights, biases, t, (cat_w, cat_b) = _checked_categorised(
        name, h, weights, biases, cat_w, cat_b, t)
    m, hidden = h.shape
    f = t.shape[1]
    n_heads = len(weights) + cat_w.shape[0]
    plan = f32_tc_plan(m, hidden, f, n_heads)
    dev = h.device
    hh, w = _f32_tc_scratch(plan, m, n_heads, dev)
    b = torch.cat([torch.stack(biases), cat_b])
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    lse = torch.empty((m, f), dtype=torch.float32, device=dev)
    part = torch.empty(plan["row_sums"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cat_tc_f32_forward", dev, fam.code, h.data_ptr(),
        *_weight_pointers(weights), cat_w.data_ptr(), b.data_ptr(),
        t.data_ptr(), _T_CODES[t.dtype], hh.data_ptr(), w.data_ptr(),
        part.data_ptr(), out.data_ptr(), lse.data_ptr(), m, t.shape[0],
        hidden, f, cat_w.shape[0],
    )
    LAUNCHES[f"cat_{fam.prefix}_forward_float32"] += 1
    return out, lse, part


def cat_f32_tc_gradient(name, g, h, weights, biases, cat_w, cat_b, t,
                        lse) -> TcGradient:
    """Launch the categorised float32 K3's first kernel over base ``name``
    for row cotangents ``g``: h and every head's W split into their bf16
    terms per pair, the activations as the forward summed them, every
    head's da (the classes' softmax from the forward's ``lse``) as bf16
    terms per pair and its column sums per row tile, for :func:`tc_dh` and
    :func:`tc_dw_stacked` (counted with the "_float32" suffix)."""
    fam, h, weights, biases, t, (g, cat_w, cat_b, lse) = _checked_categorised(
        name, h, weights, biases, cat_w, cat_b, t, g, lse)
    m, hidden = h.shape
    f = t.shape[1]
    n_heads = len(weights) + cat_w.shape[0]
    plan = f32_tc_plan(m, hidden, f, n_heads)
    dev = h.device
    hh, w = _f32_tc_scratch(plan, m, n_heads, dev)
    b = torch.cat([torch.stack(biases), cat_b])
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cat_tc_f32_gradient", dev, fam.code, g.data_ptr(),
        h.data_ptr(), *_weight_pointers(weights), cat_w.data_ptr(),
        b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], lse.data_ptr(),
        hh.data_ptr(), w.data_ptr(), da.data_ptr(), db_parts.data_ptr(), m,
        t.shape[0], hidden, f, cat_w.shape[0],
    )
    LAUNCHES[f"cat_{fam.prefix}_backward_gradient_float32"] += 1
    return TcGradient(f"cat_{fam.prefix}", plan, hidden, f,
                      hh.reshape(-1, plan["hp"]), w, da, db_parts,
                      "_float32")


def reference_cp_f32_tc_forward(h, w, b, t, n):
    """Plain version of :func:`cp_f32_tc_forward`, with its layout: (ll
    (M,), lse (M,), partials (CP_PARTIALS, F tiles, M)) of the split
    design's activations (see :func:`reference_cp_tc_forward`)."""
    return _cp_forward_partials(_f32_tc_activations(h, [w], [b])[0], t, n)


def reference_cp_f32_tc_gradient(g, h, w, b, t, lse) -> TcGradient:
    """Plain version of :func:`cp_f32_tc_gradient`, with its layout (see
    :func:`reference_f32_tc_gradient`): da = g·(t − (Σt)·exp(a − lse))
    of the split design's activations, its terms per pair (M, P·Fp), zero
    past F, and the column sums of the unrounded da per row tile (row
    tiles, Fp); h's terms per pair as the dW product reads them (P·M, Hp),
    and W's (Hp, P, 1, Fp)."""
    a = _f32_tc_activations(h, [w], [b])[0]
    tt = _cycle_rows(t.float(), h.shape[0])
    dll = tt - tt.sum(-1, keepdim=True) * torch.exp(a - lse.float()[:, None])
    return _f32_tc_reference_scratch("cp", g, h, [w], [dll], t.shape[-1])


def cp_f32_tc_forward(h, w, b, t, n):
    """Launch the float32 K6 on the tensor cores: h and W split into their
    bf16 terms per pair, then (ll (M,), lse (M,), the partials per gene
    tile (CP_PARTIALS, F tiles, M) that a second kernel merges in order) of
    the terms multiplied pair by pair."""
    h, (w,), (b,), t, n = _checked_cuda(h, [w], [b], t, n)
    m, hidden = h.shape
    f = t.shape[1]
    plan = f32_tc_plan(m, hidden, f, 1)
    dev = h.device
    ll, lse = (torch.empty((m,), dtype=torch.float32, device=dev)
               for _ in range(2))
    partials = torch.empty((CP_PARTIALS, *plan["row_sums"]),
                           dtype=torch.float32, device=dev)
    if m == 0:
        return ll, lse, partials
    hh, wp = _f32_tc_scratch(plan, m, 1, dev)
    extension.call(
        "scvae_cp_tc_f32_forward", dev, h.data_ptr(), w.data_ptr(),
        b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype], n.data_ptr(),
        hh.data_ptr(), wp.data_ptr(), partials.data_ptr(), ll.data_ptr(),
        lse.data_ptr(), m, t.shape[0], hidden, f,
    )
    LAUNCHES["cp_forward_float32"] += 1
    return ll, lse, partials


def cp_f32_tc_gradient(g, h, w, b, t, lse) -> TcGradient:
    """Launch the float32 K7's first kernel for row cotangents ``g`` and the
    forward's ``lse``: h and W split into their bf16 terms per pair, the
    activations as the forward summed them, da's bf16 terms per pair and
    da's column sums per row tile, for :func:`tc_dh` and :func:`tc_dw`
    (counted with the "_float32" suffix)."""
    h, (w,), (b,), t, g, lse = _checked_cuda(h, [w], [b], t, g, lse)
    m, hidden = h.shape
    f = t.shape[1]
    plan = f32_tc_plan(m, hidden, f, 1)
    dev = h.device
    hh, wp = _f32_tc_scratch(plan, m, 1, dev)
    # Σ_f t per target row, a plain reduction outside the kernels as in the
    # JAX package's backward
    sx = t.sum(-1, dtype=torch.float32)
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_cp_tc_f32_gradient", dev, g.data_ptr(), h.data_ptr(),
        w.data_ptr(), b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        lse.data_ptr(), sx.data_ptr(), hh.data_ptr(), wp.data_ptr(),
        da.data_ptr(), db_parts.data_ptr(), m, t.shape[0], hidden, f,
    )
    LAUNCHES["cp_backward_gradient_float32"] += 1
    return TcGradient("cp", plan, hidden, f, hh.reshape(-1, plan["hp"]), wp,
                      da, db_parts, "_float32")


def fused_forward(name, h, weights, biases, t, *, compute_dtype=None,
                  include_lgamma_const=True) -> torch.Tensor:
    """Row-summed log-likelihood (M,) of family ``name``: K2 on CUDA (bf16:
    the tensor-core kernel on bf16 operands; float32: the same kernel on
    their bf16 terms), the plain version on the CPU."""
    fam = _family_heads(name, weights, biases)
    round_flag = _round_flag(compute_dtype)
    if not h.is_cuda:
        return reference_forward(name, h, weights, biases, t,
                                 compute_dtype=compute_dtype,
                                 include_lgamma_const=include_lgamma_const)
    if round_flag:
        return _tc_forward(fam, h, weights, biases, t, include_lgamma_const)
    return f32_tc_forward(name, h, weights, biases, t, include_lgamma_const)


def fused_backward(name, g, h, weights, biases, t, *, compute_dtype=None):
    """(dh, dW_0, db_0, …) for the row cotangents ``g`` (M,): on CUDA the
    tensor-core gradient kernel once (bf16 operands, or in float32 their
    bf16 terms), then the dh and the dW product of its da; the plain
    version on the CPU."""
    args = (name, g, h, weights, biases, t)
    if not h.is_cuda:
        return (reference_dh(*args, compute_dtype=compute_dtype),
                *reference_dw(*args, compute_dtype=compute_dtype))
    if _round_flag(compute_dtype):
        grad = tc_gradient(*args)
    else:
        fam = _family_heads(name, weights, biases)
        m, hidden = h.shape
        f = t.shape[-1]
        if m == 0 or f == 0:
            _validated(h, weights, biases, t, g)
            return (torch.zeros((m, hidden), device=h.device),
                    *(torch.zeros(shape, device=h.device)
                      for _ in fam.heads for shape in ((hidden, f), (f,))))
        grad = f32_tc_gradient(*args)
    return (tc_dh(grad), *tc_dw(grad))


def cp_forward(h, w, b, t, n):
    """(ll (M,), lse (M,)) of the constrained Poisson, by h's dtype: bf16 h
    (training in bf16) on the tensor-core K6 with W in two bf16 terms
    (:func:`cp_tc_forward`), any other h in float32 on the same kernel with
    h and W in three (:func:`cp_f32_tc_forward`); on the CPU the plain
    versions (the float32 one for float32 h).  W stays float32 either way."""
    if h.dtype == torch.bfloat16:
        if not h.is_cuda:
            return reference_cp_tc_forward(h, w, b, t, n)[:2]
        return cp_tc_forward(h, w, b, t, n)[:2]
    if not h.is_cuda:
        return reference_cp_forward(h, w, b, t, n)
    return cp_f32_tc_forward(h, w, b, t, n)[:2]


def cp_backward(g, h, w, b, t, lse):
    """(dh, dW, db) of the constrained Poisson for row cotangents ``g``
    (M,) and the forward's ``lse``: on CUDA the tensor-core gradient kernel
    once (bf16 h: W and da in two bf16 terms; any other h in float32: h, W
    and da in three), then the dh and dW products of its da terms; on the
    CPU the plain versions (the float32 ones for float32 h)."""
    if h.dtype == torch.bfloat16:
        if not h.is_cuda:
            grad = reference_cp_tc_gradient(g, h, w, b, t, lse)
            return (reference_tc_dh(grad), *reference_tc_dw(grad))
        grad = cp_tc_gradient(g, h, w, b, t, lse)
        return (tc_dh(grad), *tc_dw(grad))
    if not h.is_cuda:
        return (reference_cp_dh(g, h, w, b, t, lse),
                *reference_cp_dw(g, h, w, b, t, lse))
    m, hidden = h.shape
    f = t.shape[-1]
    if m == 0 or f == 0:
        _validated(h, [w], [b], t, g, lse)
        return (torch.zeros((m, hidden), device=h.device),
                torch.zeros((hidden, f), device=h.device),
                torch.zeros((f,), device=h.device))
    grad = cp_f32_tc_gradient(g, h, w, b, t, lse)
    return (tc_dh(grad), *tc_dw(grad))


def _checked_categorised(name, h, weights, biases, cat_w, cat_b, t, g=None,
                         lse=None):
    """Validate and normalise the categorised kernels' operands: those of
    the base family (and the row cotangents ``g``), the class heads
    (C, H, F) / (C, F) with 2 ≤ C and at most :data:`MAX_FUSED_HEADS` heads
    in all, and the per-element ``lse`` (M, F)."""
    fam = _family_heads(name, weights, biases)
    m, hidden = h.shape
    f = t.shape[-1]
    n_classes = cat_w.shape[0]
    if (cat_w.dim() != 3 or tuple(cat_w.shape[1:]) != (hidden, f)
            or tuple(cat_b.shape) != (n_classes, f)):
        raise ValueError(f"class heads {tuple(cat_w.shape)}, "
                         f"{tuple(cat_b.shape)} do not match h "
                         f"{tuple(h.shape)} and t {tuple(t.shape)}")
    if n_classes < 2 or not supports_fused_likelihood(name, n_classes - 1):
        raise ValueError(f"{name} takes 2 to "
                         f"{MAX_FUSED_HEADS - len(fam.heads)} classes, got "
                         f"{n_classes}")
    if lse is not None and tuple(lse.shape) != (m, f):
        raise ValueError(f"lse {tuple(lse.shape)} is not ({m}, {f})")
    rows = [] if g is None else [g]
    h, weights, biases, t, *rows = _checked_cuda(h, weights, biases, t, *rows)
    more = [x.float().contiguous()
            for x in (cat_w, cat_b, *([] if lse is None else [lse]))]
    if not all(x.device == h.device for x in more):
        raise ValueError("all operands must be CUDA tensors on one device")
    return fam, h, weights, biases, t, (*rows, *more)


def categorised_forward(name, h, weights, biases, cat_w, cat_b, t, *,
                        compute_dtype=None):
    """(row sums (M,), per-element lse (M, F)) of the categorised instance
    over base ``name``: its K2 kernel on CUDA (bf16: on bf16 operands;
    float32: on their bf16 terms), the plain version on the CPU."""
    if not h.is_cuda:
        return reference_categorised_forward(name, h, weights, biases, cat_w,
                                             cat_b, t,
                                             compute_dtype=compute_dtype)
    forward = cat_tc_forward if _round_flag(compute_dtype) else (
        cat_f32_tc_forward)
    return forward(name, h, weights, biases, cat_w, cat_b, t)[:2]


def categorised_backward(name, g, h, weights, biases, cat_w, cat_b, t, lse, *,
                         compute_dtype=None):
    """(dh, dW_0, db_0, …, dW_classes (K+1, H, F), db_classes (K+1, F)) of
    the categorised instance for the row cotangents ``g`` (M,) and the
    forward's per-element ``lse``: on CUDA the tensor-core gradient kernel
    once (bf16 operands, or in float32 their bf16 terms), then the dh and
    dW products of its da; the plain versions on the CPU."""
    args = (name, g, h, weights, biases, cat_w, cat_b, t, lse)
    if not h.is_cuda:
        return (reference_categorised_dh(*args, compute_dtype=compute_dtype),
                *reference_categorised_dw(*args,
                                          compute_dtype=compute_dtype))
    gradient = cat_tc_gradient if _round_flag(compute_dtype) else (
        cat_f32_tc_gradient)
    grad = gradient(*args)
    dw, db = tc_dw_stacked(grad)
    n_base = len(weights)
    return (tc_dh(grad), *(x for k in range(n_base) for x in (dw[k], db[k])),
            dw[n_base:], db[n_base:])


def _grouped_shapes(h, t, g=None):
    """(G, M, H) of the grouped kernels' operands: h (G, M, H), the shared
    targets t (M, F) and the row cotangents g (G, M)."""
    if h.dim() != 3:
        raise ValueError(f"h {tuple(h.shape)} is not (groups, rows, hidden)")
    n_groups, m, hidden = h.shape
    if t.dim() != 2 or t.shape[0] != m:
        raise ValueError(f"t {tuple(t.shape)} does not have h's {m} rows")
    if g is not None and tuple(g.shape) != (n_groups, m):
        raise ValueError(f"g {tuple(g.shape)} is not ({n_groups}, {m})")
    if n_groups * m >= 2 ** 31:
        raise ValueError(f"{n_groups} groups of {m} rows exceed int32")
    return n_groups, m, hidden


# K4 / K5 on the tensor cores (ops/csrc/grouped_likelihood_tc.cu): one heads
# kernel, forward and gradient, bf16 on the flat kernels' bf16 operands and
# float32 on the flat float32 kernels' split (h, W and da as three bf16
# terms, the ring's depth over the six pairs).  A block keeps every head's
# W resident in shared memory over the group loop, in slots of ``w_chunk``
# rows (``w_slots`` of them, one term of W each where a term fits); the
# forward's row sums per gene tile go through reduce_kernel, the gradient
# kernel's scratch through the flat kernels' products.  GROUPED_TC_ROWS is
# kGtRows, GROUPED_TC_SMEM kGtSmemMax, and the bytes below the parts that
# gt_smem_bytes lays out: the t tile, one row of every head's resident W,
# the sums (the gradient kernel's column sums of each warp's rows, or the
# forward's row sums), and the h ring of four slices of GROUPED_TC_DEPTH
# hidden units.
GROUPED_TC_ROWS = 128
GROUPED_TC_SMEM = 232448
GROUPED_TC_DEPTH = 64
_GT_T_BYTES = 4 * GROUPED_TC_ROWS * 72          # float [128][72]
_GT_SUM_BYTES = 4 * 8 * TC_GENE_TILE            # float [8][64] per head
_GT_W_ROW_BYTES = 2 * 72                        # bf16 [72] per head and row


def grouped_tc_plan(n_groups: int, m: int, hidden: int, f: int,
                    n_heads: int, float32: bool = False) -> dict:
    """:func:`tc_plan` (``float32``: :func:`f32_tc_plan`) of the G·M
    group-major rows (the scratch da and the products over them), with the
    grouped gradient kernel's column sums per 64 target rows over every
    group, ``db_parts`` (ceil(M / 64), NH·Fp), the grouped kernels' grid,
    and W's resident slots (``w_slots`` of ``w_chunk`` rows, a multiple of
    the ring's depth: a slot per term of W while the terms fit, else all
    of Hp in one slot where it fits, else the most rows that do) with their
    shared memory."""
    rows = n_groups * m
    plan = (f32_tc_plan if float32 else tc_plan)(rows, hidden, f, n_heads)
    depth = GROUPED_TC_DEPTH
    ring = 2 * 4 * GROUPED_TC_ROWS * (depth + 8)  # bf16 [4][128][depth + 8]
    fixed = ring + _GT_T_BYTES + (4 * TC_GENE_TILE + _GT_SUM_BYTES) * n_heads
    row_bytes = _GT_W_ROW_BYTES * n_heads
    most = (GROUPED_TC_SMEM - fixed) // row_bytes // depth * depth
    term_rows = _cdiv(plan["hp"], depth) * depth
    terms = SPLIT_TERMS if float32 else 1
    slots = max(1, min(terms, most // term_rows))
    w_chunk = min(term_rows, most)
    plan.update(
        db_parts=(_cdiv(m, TC_ROW_TILE), n_heads * plan["fp"]),
        grid=(_cdiv(m, GROUPED_TC_ROWS), _cdiv(f, TC_GENE_TILE)),
        w_chunk=w_chunk, w_slots=slots,
        smem_bytes=fixed + row_bytes * w_chunk * slots)
    return plan


def _grouped_rows(h, t, g=None, float32=False):
    """h (G, M, H) flattened group-major to (G·M, H) (float32 and
    contiguous for ``float32``), the row cotangents g (G, M) as float32
    (G·M,), and (G, M, H), checked against the shared targets t (M, F)."""
    n_groups, m, hidden = _grouped_shapes(h, t, g)
    h2 = h.reshape(-1, hidden)
    if float32:
        h2 = h2.float().contiguous()
    if g is not None:
        g = g.reshape(-1).float().contiguous()
    return h2, g, (n_groups, m, hidden)


def _grouped_forward_buffers(plan, n_groups, m, device):
    """The grouped forwards' row sums (G, M) and their partials per gene
    tile (F tiles, G·M)."""
    return (torch.empty((n_groups, m), dtype=torch.float32, device=device),
            torch.empty((plan["grid"][1], n_groups * m), dtype=torch.float32,
                        device=device))


def grouped_tc_forward(name, h, weights, biases, t) -> torch.Tensor:
    """Launch the grouped bf16 K4 of family ``name``: the row sums (G, M)
    of h (G, M, H) against the shared targets t (M, F), bf16 operands,
    lgamma(1 + t) subtracted."""
    fam = _family_heads(name, weights, biases)
    h2, _, (n_groups, m, hidden) = _grouped_rows(h, t)
    t = _validated(h2, weights, biases, t)
    f = t.shape[1]
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights))
    hb, w, b = _tc_operands(h2, weights, biases)
    out, part = _grouped_forward_buffers(plan, n_groups, m, h.device)
    extension.call(
        "scvae_grouped_tc_forward", h.device, fam.code, hb.data_ptr(),
        w.data_ptr(), b.data_ptr(), t.data_ptr(), _T_CODES[t.dtype],
        part.data_ptr(), out.data_ptr(), n_groups, m, plan["hp"], f,
        plan["w_chunk"], plan["w_slots"],
    )
    LAUNCHES[f"{fam.prefix}_grouped_forward"] += 1
    return out


def grouped_f32_tc_forward(name, h, weights, biases, t) -> torch.Tensor:
    """Launch the grouped float32 K4 of family ``name``: h and W split into
    their bf16 terms per pair (as for :func:`f32_tc_forward`), then the row
    sums (G, M) of the terms multiplied pair by pair, lgamma(1 + t)
    subtracted."""
    fam = _family_heads(name, weights, biases)
    h2, _, (n_groups, m, hidden) = _grouped_rows(h, t, float32=True)
    h2, weights, biases, t = _checked_cuda(h2, weights, biases, t)
    f = t.shape[1]
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights), float32=True)
    hh, w = _f32_tc_scratch(plan, n_groups * m, len(weights), h.device)
    b = torch.stack(biases)
    out, part = _grouped_forward_buffers(plan, n_groups, m, h.device)
    extension.call(
        "scvae_grouped_tc_f32_forward", h.device, fam.code, h2.data_ptr(),
        *_weight_pointers(weights), b.data_ptr(), t.data_ptr(),
        _T_CODES[t.dtype], hh.data_ptr(), w.data_ptr(), part.data_ptr(),
        out.data_ptr(), n_groups, m, hidden, f, plan["w_chunk"],
        plan["w_slots"],
    )
    LAUNCHES[f"{fam.prefix}_grouped_forward_float32"] += 1
    return out


def reference_grouped_f32_tc_forward(name, h, weights, biases, t):
    """Plain version of :func:`grouped_f32_tc_forward`: the row sums (G, M)
    of the split design's activations over the G·M group-major rows."""
    n_groups, m, hidden = h.shape
    return reference_f32_tc_forward(name, h.reshape(-1, hidden), weights,
                                    biases, t).reshape(n_groups, m)


def grouped_forward(name, h, weights, biases, t, *, compute_dtype=None):
    """Row sums (G, M) of h (G, M, H) against the shared targets t (M, F),
    lgamma(1 + t) subtracted: K4 on CUDA (bf16: the grouped tensor-core
    forward on bf16 operands; float32: the same kernel on their bf16
    terms), the plain version on the CPU."""
    _family_heads(name, weights, biases)
    round_flag = _round_flag(compute_dtype)
    if not h.is_cuda:
        return reference_grouped_forward(name, h, weights, biases, t,
                                         compute_dtype=compute_dtype)
    n_groups, m, hidden = _grouped_shapes(h, t)
    if n_groups * m == 0 or t.shape[-1] == 0:
        _validated(h.reshape(-1, hidden), weights, biases, t)
        return torch.zeros((n_groups, m), dtype=torch.float32, device=h.device)
    if round_flag:
        return grouped_tc_forward(name, h, weights, biases, t)
    return grouped_f32_tc_forward(name, h, weights, biases, t)


def grouped_tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Launch the grouped bf16 backward's gradient kernel of family
    ``name`` for h (G, M, H), the shared targets t (M, F) and the row
    cotangents g (G, M): bf16(da) over the G·M group-major rows and its
    column sums per 64 target rows over every group, for :func:`tc_dh` and
    :func:`tc_dw_stacked` (counted as "<family>_grouped_backward_…")."""
    fam = _family_heads(name, weights, biases)
    h2, g, (n_groups, m, hidden) = _grouped_rows(h, t, g)
    t = _validated(h2, weights, biases, t, g)
    f = t.shape[1]
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights))
    hb, w, b = _tc_operands(h2, weights, biases)
    dev = h.device
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_grouped_tc_gradient", dev, fam.code, g.data_ptr(),
        hb.data_ptr(), w.data_ptr(), b.data_ptr(), t.data_ptr(),
        _T_CODES[t.dtype], da.data_ptr(), db_parts.data_ptr(), n_groups, m,
        plan["hp"], f, plan["w_chunk"], plan["w_slots"],
    )
    LAUNCHES[f"{fam.prefix}_grouped_backward_gradient"] += 1
    return TcGradient(f"{fam.prefix}_grouped", plan, hidden, f, hb, w, da,
                      db_parts)


def grouped_f32_tc_gradient(name, g, h, weights, biases, t) -> TcGradient:
    """Launch the grouped float32 backward's gradient kernel of family
    ``name``: h and W split into their bf16 terms per pair, the activations
    as the grouped float32 forward summed them, da's bf16 terms per pair
    over the G·M group-major rows (G·M, P·NH·Fp) and da's column sums per
    64 target rows over every group, for :func:`tc_dh` and :func:`tc_dw`
    (counted as "<family>_grouped_backward_…_float32")."""
    fam = _family_heads(name, weights, biases)
    h2, g, (n_groups, m, hidden) = _grouped_rows(h, t, g, float32=True)
    h2, weights, biases, t, g = _checked_cuda(h2, weights, biases, t, g)
    f = t.shape[1]
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights), float32=True)
    dev = h.device
    hh, w = _f32_tc_scratch(plan, n_groups * m, len(weights), dev)
    b = torch.stack(biases)
    da = torch.empty(plan["da"], dtype=torch.bfloat16, device=dev)
    db_parts = torch.empty(plan["db_parts"], dtype=torch.float32, device=dev)
    extension.call(
        "scvae_grouped_tc_f32_gradient", dev, fam.code, g.data_ptr(),
        h2.data_ptr(), *_weight_pointers(weights), b.data_ptr(),
        t.data_ptr(), _T_CODES[t.dtype], hh.data_ptr(), w.data_ptr(),
        da.data_ptr(), db_parts.data_ptr(), n_groups, m, hidden, f,
        plan["w_chunk"], plan["w_slots"],
    )
    LAUNCHES[f"{fam.prefix}_grouped_backward_gradient_float32"] += 1
    return TcGradient(f"{fam.prefix}_grouped", plan, hidden, f,
                      hh.reshape(-1, plan["hp"]), w, da, db_parts,
                      "_float32")


def reference_grouped_tc_gradient(name, g, h, weights, biases,
                                  t) -> TcGradient:
    """Plain version of :func:`grouped_tc_gradient`, with the same layout:
    bf16(da) (G·M, NH·Fp), zero past F, and da's column sums per 64 target
    rows over every group."""
    fam = _family_heads(name, weights, biases)
    n_groups, m, hidden = h.shape
    f = t.shape[-1]
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights))
    h2 = h.reshape(-1, hidden)
    hb, w, _ = _tc_operands(h2, weights, biases)
    _, das = _weighted_grads(name, g.reshape(-1), h2, weights, biases, t,
                             torch.bfloat16)
    return _reference_scratch(f"{fam.prefix}_grouped", plan, hidden, f, hb,
                              w, das, groups=n_groups)


def reference_grouped_f32_tc_gradient(name, g, h, weights, biases,
                                      t) -> TcGradient:
    """Plain version of :func:`grouped_f32_tc_gradient`, with its layout
    (see :func:`reference_f32_tc_gradient`) over the G·M group-major rows:
    da's column sums per 64 target rows over every group."""
    fam = _family_heads(name, weights, biases)
    n_groups, m, hidden = h.shape
    f = t.shape[-1]
    h2 = h.reshape(-1, hidden)
    acts = _f32_tc_activations(h2, weights, biases)
    gs = fam.grads(*acts, _cycle_rows(t.float(), h2.shape[0]))
    plan = grouped_tc_plan(n_groups, m, hidden, f, len(weights), float32=True)
    return _f32_tc_reference_scratch(f"{fam.prefix}_grouped", g.reshape(-1),
                                     h2, weights, gs, f, plan=plan,
                                     groups=n_groups)


def grouped_backward(name, g, h, weights, biases, t, *, compute_dtype=None):
    """(dh (G, M, H), dW_0, db_0, dW_1, db_1, …) for the row cotangents g
    (G, M), dW/db summed over the groups and rows.  On CUDA the grouped
    gradient kernel once (bf16 operands, or in float32 their bf16 terms),
    then the dh and dW products of its da; on the CPU with bf16 the plain
    versions of that design, in float32 the per-group plain versions."""
    args = (name, g, h, weights, biases, t)
    round_flag = _round_flag(compute_dtype)
    fam = _family_heads(name, weights, biases)
    n_groups, m, hidden = h.shape
    f = t.shape[-1]
    if n_groups * m == 0 or f == 0:
        dev = h.device
        return (torch.zeros((n_groups, m, hidden), device=dev),
                *(torch.zeros(shape, device=dev)
                  for _ in fam.heads for shape in ((hidden, f), (f,))))
    if not h.is_cuda:
        if not round_flag:
            return (reference_grouped_dh(*args),
                    *reference_grouped_dw(*args))
        grad = reference_grouped_tc_gradient(*args)
        return (reference_tc_dh(grad).reshape(h.shape),
                *reference_tc_dw(grad))
    grad = (grouped_tc_gradient if round_flag else grouped_f32_tc_gradient)(
        *args)
    return (tc_dh(grad).reshape(h.shape), *tc_dw(grad))


# --------------------------------------------------------------------------
# autograd Functions and the public entry
# --------------------------------------------------------------------------


class FusedLogLikelihood(torch.autograd.Function):
    """Row-summed log-likelihood of a base family with the fused backward;
    the twin of ``_make_fused_from`` in the JAX package.  Saves h, the heads
    and t, and recomputes the activations in the backward.  ``params`` are
    W_0, b_0, W_1, b_1, … in the family's head order."""

    @staticmethod
    def forward(ctx, name, compute_dtype, include_lgamma_const, h, t, *params):
        ctx.save_for_backward(h, t, *params)
        ctx.name = name
        ctx.compute_dtype = compute_dtype
        return fused_forward(name, h, params[0::2], params[1::2], t,
                             compute_dtype=compute_dtype,
                             include_lgamma_const=include_lgamma_const)

    @staticmethod
    def backward(ctx, g):
        h, t, *params = ctx.saved_tensors
        dh, *dparams = fused_backward(ctx.name, g, h, params[0::2],
                                      params[1::2], t,
                                      compute_dtype=ctx.compute_dtype)
        return (None, None, None, dh.to(h.dtype), None, *dparams)


class FusedConstrainedPoisson(torch.autograd.Function):
    """Row-summed constrained-Poisson log-likelihood with the fused backward
    (``_fused_constrained_poisson`` in the JAX package).  ``round_h`` hands
    h over as a bf16 tensor (W and da in two bf16 terms), else as float32
    (h, W and da in three); the gradient of h is float32 and unrounded.  Saves
    lse from the forward as a residual; the count-sum cotangent dn =
    g·(Σt/n − 1) is computed here, outside the kernels, when asked for."""

    @staticmethod
    def forward(ctx, h, w, b, t, n, round_h):
        hv = h.to(torch.bfloat16) if round_h else h.float()
        ll, lse = cp_forward(hv, w, b, t, n)
        ctx.save_for_backward(hv, w, b, t, n, lse)
        ctx.h_dtype = h.dtype
        return ll

    @staticmethod
    def backward(ctx, g):
        hv, w, b, t, n, lse = ctx.saved_tensors
        dh, dw, db = cp_backward(g, hv, w, b, t, lse)
        dh = dh.to(ctx.h_dtype)
        dn = None
        if ctx.needs_input_grad[4]:
            sx = _cycle_rows(t.float(), hv.shape[0]).sum(-1)
            dn = (g * (sx / n - 1.0)).to(n.dtype)
        return dh, dw, db, None, dn, None


class FusedCategorised(torch.autograd.Function):
    """Row-summed categorised log-likelihood with the fused backward
    (``_make_fused_categorised`` in the JAX package).  Saves h, the heads,
    t and the forward's per-element lse (M, F), which the backward reads
    instead of sweeping the class heads twice.  ``params`` are the base
    family's W_0, b_0, W_1, b_1, … in its head order."""

    @staticmethod
    def forward(ctx, name, compute_dtype, h, t, cat_w, cat_b, *params):
        ll, lse = categorised_forward(name, h, params[0::2], params[1::2],
                                      cat_w, cat_b, t,
                                      compute_dtype=compute_dtype)
        ctx.save_for_backward(h, t, lse, cat_w, cat_b, *params)
        ctx.name = name
        ctx.compute_dtype = compute_dtype
        return ll

    @staticmethod
    def backward(ctx, g):
        h, t, lse, cat_w, cat_b, *params = ctx.saved_tensors
        dh, *dparams, dcat_w, dcat_b = categorised_backward(
            ctx.name, g, h, params[0::2], params[1::2], cat_w, cat_b, t, lse,
            compute_dtype=ctx.compute_dtype)
        return (None, None, dh.to(h.dtype), None, dcat_w, dcat_b, *dparams)


class FusedGroupedLogLikelihood(torch.autograd.Function):
    """Row sums (G, M) of a base family over G groups of h against shared
    targets, with the grouped backward (``_make_fused_grouped`` in the JAX
    package).  Saves h, the heads and t; the gradient of t is zero, as JAX's
    ``bwd`` returns it.  ``params`` are W_0, b_0, W_1, b_1, … in the
    family's head order."""

    @staticmethod
    def forward(ctx, name, compute_dtype, h, t, *params):
        ctx.save_for_backward(h, t, *params)
        ctx.name = name
        ctx.compute_dtype = compute_dtype
        return grouped_forward(name, h, params[0::2], params[1::2], t,
                               compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        h, t, *params = ctx.saved_tensors
        dh, *dparams = grouped_backward(ctx.name, g, h, params[0::2],
                                        params[1::2], t,
                                        compute_dtype=ctx.compute_dtype)
        dt = torch.zeros_like(t) if ctx.needs_input_grad[3] else None
        return (None, None, dh.to(h.dtype), dt, *dparams)


def fused_grouped_log_likelihood(name, h, heads, t,
                                 compute_dtype=None) -> torch.Tensor:
    """Row-summed log p(t | heads(h_g)) per group on the grouped path
    (K4/K5): ``h`` (..., G, M, H) against targets ``t`` (M, F) shared by
    every group; the leading axes are flattened into the group axis.
    lgamma(1 + t) is always subtracted.  Returns (..., G, M)."""
    if name not in FAMILIES:
        raise ValueError(f"No fused grouped likelihood for {name!r}")
    lead = h.shape[:-2]
    m, hidden = h.shape[-2:]
    params = [heads[p][k] for p in FAMILIES[name].heads
              for k in ("kernel", "bias")]
    out = FusedGroupedLogLikelihood.apply(
        name, compute_dtype, h.reshape(math.prod(lead), m, hidden), t,
        *params)
    return out.reshape(lead + (m,))


def _flat_rows(h, t):
    """h as (M, H) and t as (M_t, F): a 2-D t whose rows tile M rides the
    cycled rows, any other t is broadcast to h's leading axes."""
    h2 = h.reshape(-1, h.shape[-1])
    if not (t.dim() == 2 and h2.shape[0] % t.shape[0] == 0):
        t = torch.broadcast_to(t, h.shape[:-1] + t.shape[-1:]).reshape(
            -1, t.shape[-1])
    return h2, t


def fused_categorised_log_likelihood(name, h, heads, cat_kernel, cat_bias, t,
                                     compute_dtype=None) -> torch.Tensor:
    """Row-summed categorised log p(t | heads(h)) on the fused path: the
    base family ``name``'s ``heads`` plus the class heads ``cat_kernel``
    (K+1, H, F) and ``cat_bias`` (K+1, F).  ``h`` (..., H); ``t`` (..., F),
    or (M_t, F) shared by the leading axes of ``h`` (rows cycle).
    Returns (...,)."""
    if name not in FAMILIES:
        raise ValueError(f"No fused categorised likelihood for {name!r}")
    h2, t = _flat_rows(h, t)
    params = [heads[p][k] for p in FAMILIES[name].heads
              for k in ("kernel", "bias")]
    out = FusedCategorised.apply(name, compute_dtype, h2, t, cat_kernel,
                                 cat_bias, *params)
    return out.reshape(h.shape[:-1])


def fused_log_likelihood(name, h, heads, t, count_sum=None, compute_dtype=None,
                         include_lgamma_const=True) -> torch.Tensor:
    """Row-summed log p(t | heads(h)) on the fused path.

    ``h``: (..., H) decoder output; ``t``: (..., F) targets, or (M_t, F)
    shared by the leading sample axes of ``h`` (rows cycle instead of
    broadcasting, for the constrained Poisson too).  ``heads``: {param:
    {kernel, bias}}; ``count_sum``: (..., 1) per-cell totals, required for
    "constrained poisson".  ``compute_dtype``: bfloat16 matmul inputs with
    float32 sums (for CP: the values of h only).  With
    ``include_lgamma_const=False`` the base families leave out the
    −lgamma(1+t) constant, for callers that subtract its row sums
    themselves; CP always includes it.  Returns (...,)."""
    lead = h.shape[:-1]
    h2, t = _flat_rows(h, t)
    if name == "constrained poisson":
        if count_sum is None:
            raise ValueError("constrained poisson requires count_sum")
        _round_flag(compute_dtype)
        n = torch.broadcast_to(count_sum, lead + (1,)).reshape(-1)
        out = FusedConstrainedPoisson.apply(
            h2, heads["lambda"]["kernel"], heads["lambda"]["bias"], t, n,
            compute_dtype is not None,
        )
    elif name in FAMILIES:
        params = [heads[p][k] for p in FAMILIES[name].heads
                  for k in ("kernel", "bias")]
        out = FusedLogLikelihood.apply(name, compute_dtype,
                                       include_lgamma_const, h2, t, *params)
    else:
        raise ValueError(f"No fused likelihood for {name!r}")
    return out.reshape(lead)
