"""The fused likelihood kernels on a gene block (the port of
``scvae_tpu/ops/sharded.py``).

Under a model axis each rank holds its F/M-gene block of the
reconstruction heads and the categorised class heads
(``parallel.mesh.GeneSplit``).  log p(x|z) is additive over the genes for
every fused likelihood but the constrained Poisson, so each rank runs the
kernels of ``ops.fused_likelihood`` on its rows and its gene block:

* forward: the kernel on the block's heads and the block of t's columns,
  then one all-reduce (SUM) of the (M,) row sums over the model group;
* backward: the backward kernels on the block with the whole row
  cotangent, then one all-reduce (SUM) of dh over the model group; dW and
  db are the block's.

There is no data-axis collective here: JAX sums dW over ``data`` inside
its backward because its loss is a global sum, while the port's step
averages every gradient over the data group in one all-reduce (the same
numbers).  The constrained Poisson's gene softmax couples the genes, so it
splits the rows only: a cut ``lambda`` head is gathered whole (its
gradient is the rank's block of the whole head's, with no sum over the
model group, since every rank of the group computes the same loss).  Heads
whose width the model axis does not divide are whole on every rank, and
every rank of the group computes all F genes (JAX's ``_can_split_model``).

A :class:`~scvae_tpu_torch.parallel.mesh.GeneSplit` without a group runs
one block's launches and no collective: the caller combines the blocks.
"""

from __future__ import annotations

import torch

from scvae_tpu_torch.ops.fused_likelihood import (
    FAMILIES,
    _flat_rows,
    categorised_backward,
    categorised_forward,
    fused_backward,
    fused_categorised_log_likelihood,
    fused_forward,
    fused_log_likelihood,
)


class SplitLogLikelihood(torch.autograd.Function):
    """Row sums (M,) of a base family over every gene, from K2 and K3 on
    this rank's gene block (``t`` is the block of the targets' columns,
    ``params`` the block's W_0, b_0, W_1, b_1, … in the family's head
    order), summed over the model group."""

    @staticmethod
    def forward(ctx, name, compute_dtype, include_lgamma_const, genes, h, t,
                *params):
        ctx.save_for_backward(h, t, *params)
        ctx.name, ctx.compute_dtype, ctx.genes = name, compute_dtype, genes
        rows = fused_forward(name, h, params[0::2], params[1::2], t,
                             compute_dtype=compute_dtype,
                             include_lgamma_const=include_lgamma_const)
        return genes.sum(rows)

    @staticmethod
    def backward(ctx, g):
        h, t, *params = ctx.saved_tensors
        dh, *dparams = fused_backward(ctx.name, g.contiguous(), h,
                                      params[0::2], params[1::2], t,
                                      compute_dtype=ctx.compute_dtype)
        dh = ctx.genes.sum(dh)
        return (None, None, None, None, dh.to(h.dtype), None, *dparams)


class SplitCategorised(torch.autograd.Function):
    """Row sums (M,) of a categorised instance over every gene, from its
    kernels on this rank's gene block of the base heads and the class
    heads (the class log-softmax is per gene), summed over the model
    group."""

    @staticmethod
    def forward(ctx, name, compute_dtype, genes, h, t, cat_w, cat_b, *params):
        ll, lse = categorised_forward(name, h, params[0::2], params[1::2],
                                      cat_w, cat_b, t,
                                      compute_dtype=compute_dtype)
        ctx.save_for_backward(h, t, lse, cat_w, cat_b, *params)
        ctx.name, ctx.compute_dtype, ctx.genes = name, compute_dtype, genes
        return genes.sum(ll)

    @staticmethod
    def backward(ctx, g):
        h, t, lse, cat_w, cat_b, *params = ctx.saved_tensors
        dh, *dparams, dcat_w, dcat_b = categorised_backward(
            ctx.name, g.contiguous(), h, params[0::2], params[1::2], cat_w,
            cat_b, t, lse, compute_dtype=ctx.compute_dtype)
        dh = ctx.genes.sum(dh)
        return (None, None, None, dh.to(h.dtype), None, dcat_w, dcat_b,
                *dparams)


def _head_params(name, heads):
    return [heads[p][k] for p in FAMILIES[name].heads
            for k in ("kernel", "bias")]


def sharded_fused_log_likelihood(name, h, heads, t, *, genes, count_sum=None,
                                 compute_dtype=None,
                                 include_lgamma_const=True) -> torch.Tensor:
    """``ops.fused_log_likelihood`` on a gene split: ``heads`` as this rank
    holds them (its block where ``genes`` cuts F, else whole), ``t`` the
    whole (…, F) targets (or (M_t, F) rows that cycle).  The row sums over
    all F genes on every rank of the group.  With
    ``include_lgamma_const=False`` the caller subtracts the row sums of
    −lgamma(1+t) over all F genes once."""
    f = t.shape[-1]
    if name == "constrained poisson":
        whole = {"lambda": genes.whole(heads["lambda"], f)}
        return fused_log_likelihood(name, h, whole, t, count_sum=count_sum,
                                    compute_dtype=compute_dtype)
    if name not in FAMILIES:
        raise ValueError(f"No fused likelihood for {name!r}")
    if not genes.splits(f):
        return fused_log_likelihood(name, h, heads, t,
                                    compute_dtype=compute_dtype,
                                    include_lgamma_const=include_lgamma_const)
    lead = h.shape[:-1]
    h2, t = _flat_rows(h, t)
    out = SplitLogLikelihood.apply(name, compute_dtype, include_lgamma_const,
                                   genes, h2, genes.block(t).contiguous(),
                                   *_head_params(name, heads))
    return out.reshape(lead)


def sharded_fused_categorised_log_likelihood(
        name, h, heads, cat_kernel, cat_bias, t, *, genes,
        compute_dtype=None) -> torch.Tensor:
    """``ops.fused_categorised_log_likelihood`` on a gene split: the base
    ``heads`` and the class heads ``cat_kernel`` (K+1, H, ·) and
    ``cat_bias`` (K+1, ·) as this rank holds them, ``t`` the whole
    targets."""
    f = t.shape[-1]
    if name not in FAMILIES:
        raise ValueError(f"No fused categorised likelihood for {name!r}")
    if not genes.splits(f):
        return fused_categorised_log_likelihood(name, h, heads, cat_kernel,
                                                cat_bias, t,
                                                compute_dtype=compute_dtype)
    h2, t = _flat_rows(h, t)
    out = SplitCategorised.apply(name, compute_dtype, genes, h2,
                                 genes.block(t).contiguous(), cat_kernel,
                                 cat_bias, *_head_params(name, heads))
    return out.reshape(h.shape[:-1])
