"""The constrained Poisson's split-bf16 design (the bf16 K6 / K7 of
``ops/csrc/cp_likelihood_tc.cu`` and the products of ``tc_product.cu``) on
the CPU, through its plain versions: against the JAX package's
``_cp_fused_forward`` and the VJP of ``_fused_constrained_poisson`` (Pallas
in interpret mode, h in bf16 as the JAX caller casts it, W float32), at the
headline decoder width 256 and F ≥ 1,024 (the split's error grows with the
depth), with a ragged F and target rows that cycle; the layout of the plain
pieces; the planner of the deeper products; and the CPU wrappers.

Tolerances: rtol 1e-5 against the JAX package, with an absolute floor of
the same fraction of the largest |reference| value, as
``tests/test_torch_constrained_poisson.py``: two bf16 terms of W and of da
leave at most 2⁻¹⁶ of each value (``tools/cp_split_precision.py`` reads
4.4e-6 of the largest value at the headline shape), the rest is float32
summation order."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import cp_split_precision  # noqa: E402

NAME = "constrained poisson"
HIDDEN = 256
# (M, M_t, F): full 512-gene JAX tiles; a ragged F (off the port's 64-gene
# tiles and the 8-element padding) with rows cycling over half as many
# targets
CASES = [(64, 64, 1024), (48, 24, 1030)]


def _case(m, m_t, f, seed):
    """A decoder output of ReLU values, Glorot-uniform W, Poisson(2)
    targets of ~25% density, count sums a little above Σt."""
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(m, HIDDEN), 0.0).astype(np.float32)
    limit = (6.0 / (HIDDEN + f)) ** 0.5
    w = rng.uniform(-limit, limit, (HIDDEN, f)).astype(np.float32)
    b = (0.3 * rng.randn(f)).astype(np.float32)
    t = (rng.poisson(2.0, (m_t, f)) * (rng.rand(m_t, f) < 0.25)).astype(
        np.float32)
    n = np.tile(t.sum(-1, keepdims=True), (m // m_t, 1)) + rng.uniform(
        0.5, 5.0, (m, 1)).astype(np.float32)
    g = rng.randn(m).astype(np.float32)
    return h, w, b, t, n.astype(np.float32), g


def assert_close(ours, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().float().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("terms,bound", [(1, 2.0 ** -8), (2, 2.0 ** -16),
                                         (3, 2.0 ** -24)])
def test_split_bf16_terms(terms, bound):
    """bf16 terms whose float32 sum leaves at most 2^(−8·terms) of x
    (bf16 keeps 8 significant bits): the precision tool's split for each
    term count it reads, and the package's ``split_bf16`` is that split at
    CP_TERMS."""
    rng = np.random.RandomState(terms)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    parts = cp_split_precision.split(x, terms)
    assert len(parts) == terms
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    assert bool(((total - x.double()).abs() <= bound * x.double().abs()).all())
    if terms == fl.CP_TERMS:
        for a, b in zip(fl.split_bf16(x), parts, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("m,m_t,f", CASES)
def test_forward_matches_jax_interpret(m, m_t, f):
    """ll and lse of the split forward (``cp_forward`` on bf16 h on the
    CPU) against the JAX kernel K6 on the same bf16 h."""
    h, w, b, t, n, _ = _case(m, m_t, f, seed=m)
    with pltpu.force_tpu_interpret_mode():
        ref_ll, ref_lse = jfl._cp_fused_forward(
            jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(w),
            jnp.asarray(b), jnp.asarray(np.tile(t, (m // m_t, 1))),
            jnp.asarray(n))
    ll, lse = ops.cp_forward(torch.from_numpy(h).to(torch.bfloat16),
                             torch.from_numpy(w),
                             torch.from_numpy(b), torch.from_numpy(t),
                             torch.from_numpy(n)[:, 0])
    assert_close(ll, ref_ll)
    assert_close(lse, ref_lse)


@pytest.mark.parametrize("m,m_t,f", CASES)
def test_vjp_matches_jax_interpret(m, m_t, f):
    """The row sums and dh, dW, db, dn of the public entry with bf16
    compute (the split forward, then the split backward's gradient and
    products) against the VJP of the JAX kernels on the same bf16 h."""
    h, w, b, t, n, g = _case(m, m_t, f, seed=m + 1)
    t_rows = jnp.asarray(np.tile(t, (m // m_t, 1)))

    def jax_loss(h_, w_, b_, n_):
        return jfl._fused_constrained_poisson(h_, w_, b_, t_rows, n_)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_loss, jnp.asarray(h).astype(jnp.bfloat16),
                           jnp.asarray(w), jnp.asarray(b), jnp.asarray(n))
        ref_grads = vjp(jnp.asarray(g))

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (h, w, b, n)]
    out = ops.fused_log_likelihood(
        NAME, leaves[0], {"lambda": {"kernel": leaves[1], "bias": leaves[2]}},
        torch.from_numpy(t), count_sum=leaves[3],
        compute_dtype=torch.bfloat16)
    assert_close(out, ref)
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    assert grads[0].dtype == torch.float32
    for ours, want in zip(grads, ref_grads, strict=True):
        assert_close(ours, want)


def test_plain_pieces_layout():
    """The plain versions in the kernels' layout: the forward's partials
    per gene tile merge to its ll and lse; the gradient's scratch holds
    da's bf16 terms per pair, zero past F, summing to da, with the row
    tiles' column sums of the unrounded da; the dW rows repeat h once per
    pair with zeros; the products equal the float64 products of the same
    bf16 operands to float32 rounding."""
    m, m_t, f = 70, 35, 130
    h, w, b, t, n, g = (torch.from_numpy(x) for x in _case(m, m_t, f, 7))
    hb, n = h.to(torch.bfloat16), n[:, 0]
    ll, lse, partials = fl.reference_cp_tc_forward(hb, w, b, t, n)
    plan = fl.cp_tc_plan(m, HIDDEN, f)
    assert partials.shape == plan["partials"] == (4, 3, m)
    tiles = [slice(0, 64), slice(64, 128), slice(128, f)]
    a = fl._cp_tc_activations(hb, w, b)
    for k, cols in enumerate(tiles):
        assert torch.equal(partials[0, k], a[:, cols].amax(-1))
    assert torch.equal((ll, lse)[1], fl._cp_merge(partials, n)[1])
    assert_close(lse, torch.logsumexp(a, -1).numpy())

    grad = fl.reference_cp_tc_gradient(g, hb, w, b, t, lse)
    fp = plan["fp"]
    assert (plan["hp"], fp) == (256, 136)
    assert grad.da.shape == plan["da"] == (m, 3 * fp)
    assert grad.da.dtype == torch.bfloat16
    terms = grad.da.reshape(m, 3, fp).float()
    assert torch.equal(terms[:, 0], terms[:, 1])  # da_0 for W_0 and W_1
    assert not bool(terms[:, :, f:].any())
    tt = t.repeat(m // m_t, 1)
    da = g[:, None] * (tt - tt.sum(-1, keepdim=True)
                       * torch.exp(a - lse[:, None]))
    total = terms[:, 0, :f].double() + terms[:, 2, :f].double()
    assert bool(((total - da.double()).abs()
                 <= 2.0 ** -16 * da.double().abs()).all())
    assert grad.db_parts.shape == plan["db_parts"] == (2, fp)
    assert_close(grad.db_parts[:, :f].sum(0), da.sum(0).numpy())
    rows = grad.h.reshape(m, 3, -1)
    assert torch.equal(rows[:, 0], hb) and torch.equal(rows[:, 2], hb)
    assert not bool(rows[:, 1].float().any())

    w_pairs = grad.w.float()
    dh = fl.reference_tc_dh(grad)
    want = (grad.da.double() @ w_pairs.reshape(HIDDEN, -1).double().T)
    assert_close(dh, want.numpy())
    dw, db = fl.reference_tc_dw(grad)
    assert dw.shape == (HIDDEN, f) and db.shape == (f,)
    want = hb.double().T @ (terms[:, 0] + terms[:, 2])[:, :f].double()
    assert_close(dw, want.numpy())


def test_cp_tc_plan_deeper_products():
    """The CP products are P = 3 pairs deep per gene (dh) and per row (dW):
    at the headline shape both split without promotion; over GMVAE-sized
    rows dW's depth promotes its sums as the planner asks past 4,096 per
    split."""
    plan = fl.cp_tc_plan(2048, 256, 2048)
    assert plan["da"] == (2048, 3 * 2048)
    assert plan["db_parts"] == (32, 2048)
    assert plan["partials"] == (4, 32, 2048)
    assert plan["dh_splits"] == fl._product_plan(2048, 256, 6144,
                                                 fl.TC_CLUSTER_CAPACITY)
    assert plan["dw_splits"] == fl._product_plan(256, 2048, 6144,
                                                 fl.TC_CLUSTER_CAPACITY)
    for splits, per, promote in (plan["dh_splits"], plan["dw_splits"]):
        assert not promote and per * fl.TC_PRODUCT_DEPTH <= fl.TC_PROMOTE_DEPTH
        assert splits * per * fl.TC_PRODUCT_DEPTH >= 6144
    deep = fl.cp_tc_plan(20480, 256, 2048)
    splits, per, promote = deep["dw_splits"]
    assert promote and splits * per * fl.TC_PRODUCT_DEPTH >= 3 * 20480


def test_cpu_wrappers_are_the_plain_versions():
    """On the CPU, bf16 h runs the split design's plain versions and float32
    h the float32 plain versions; no kernel is launched.  Both backwards are
    ``cp_backward``, and every CP kernel has its counter."""
    h, w, b, t, n, g = (torch.from_numpy(x) for x in _case(16, 8, 100, 9))
    hb, n = h.to(torch.bfloat16), n[:, 0]
    before = dict(ops.launch_counts())
    ll, lse = ops.cp_forward(hb, w, b, t, n)
    ll_ref, lse_ref, _ = fl.reference_cp_tc_forward(hb, w, b, t, n)
    assert torch.equal(ll, ll_ref) and torch.equal(lse, lse_ref)
    grad = fl.reference_cp_tc_gradient(g, hb, w, b, t, lse)
    want = (fl.reference_tc_dh(grad), *fl.reference_tc_dw(grad))
    got = ops.cp_backward(g, hb, w, b, t, lse)
    for a, b_ in zip(got, want, strict=True):
        assert torch.equal(a, b_)
    hf = hb.float()
    ll32, lse32 = ops.cp_forward(hf, w, b, t, n)
    assert torch.equal(ll32, ops.reference_cp_forward(hf, w, b, t, n)[0])
    for a, b_ in zip(ops.cp_backward(g, hf, w, b, t, lse32),
                     (ops.reference_cp_dh(g, hf, w, b, t, lse32),
                      *ops.reference_cp_dw(g, hf, w, b, t, lse32)),
                     strict=True):
        assert torch.equal(a, b_)
    assert ops.launch_counts() == before
    assert {"cp_forward", "cp_backward_gradient", "cp_backward_dh",
            "cp_backward_dw", "cp_forward_float32",
            "cp_backward_gradient_float32", "cp_backward_dh_float32",
            "cp_backward_dw_float32"} <= set(ops.launch_counts())
