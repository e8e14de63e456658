"""The base families' float32 K2/K3 design on the tensor cores
(``ops/csrc/count_likelihood_tc.cu`` over depth segments, then the products
of ``tc_product.cu``) on the CPU, through its plain versions: h, W and da
as ``SPLIT_TERMS`` bf16 terms, the products over the pairs of terms.  The
split-layout plain forward and gradient (with the products of its scratch)
against the JAX package's ``_fused_forward`` / ``_fused_backward`` with
float32 compute (Pallas in interpret mode), with ragged H and F and target
rows that cycle for two of the families; the split itself; the layout of
the operands and the plan's padded widths; and the CPU wrappers, which run
the float32 plain versions and launch nothing.

Tolerances: rtol 2e-5 against the JAX package, with an absolute floor of
the same fraction of the largest |reference| value: three bf16 terms leave
at most 2⁻²⁴ of each value (``tools/f32_split_precision.py`` reads at most
4.4e-6 of the largest value where the activations reach the exponentials'
clip), the rest is float32 summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

FAMILIES = list(ops.FAMILIES)
M, HIDDEN, F = 64, 40, 300
RTOL = 2e-5
# target rows per family: two families cycle their rows over half as many
TARGET_ROWS = {"poisson": M, "negative binomial": M // 2,
               "zero-inflated poisson": M,
               "zero-inflated negative binomial": M // 2}


def _case(name, seed, hidden=HIDDEN, f=F):
    """ReLU h, heads three times Glorot-uniform (activations that reach the
    exponentials' clip), Poisson(2) targets and row cotangents."""
    rng = np.random.RandomState(seed)
    m_t = TARGET_ROWS[name]
    h = np.maximum(rng.randn(M, hidden), 0.0).astype(np.float32)
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    k = len(ops.FAMILIES[name].heads)
    ws = [rng.uniform(-limit, limit, (hidden, f)).astype(np.float32)
          for _ in range(k)]
    bs = [(0.3 * rng.randn(f)).astype(np.float32) for _ in range(k)]
    t = rng.poisson(2.0, (m_t, f)).astype(np.float32)
    g = rng.randn(M).astype(np.float32)
    return h, ws, bs, t, g


def _torch(h, ws, bs, t, g):
    return (torch.from_numpy(h), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(t),
            torch.from_numpy(g))


def assert_close(ours, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().float().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("operand", ["h", "W", "da"])
def test_split_bf16_terms(operand):
    """``split_bf16`` at SPLIT_TERMS: bf16 terms, the first the bf16
    rounding of x and each the rounding of what the terms before it leave,
    whose float32 sum leaves at most 2^(−8·terms) of x; for h, W and da
    values as the kernels take them."""
    h, ws, _, _, g = _case("zero-inflated negative binomial", seed=1)
    rng = np.random.RandomState(2)
    x = {"h": h, "W": ws[0],
         "da": g[:, None] * rng.randn(M, F).astype(np.float32)
         * 10.0 ** rng.uniform(-4, 4, (M, F))}[operand]
    x = torch.from_numpy(np.asarray(x, np.float32))
    terms = fl.split_bf16(x, fl.SPLIT_TERMS)
    assert len(terms) == fl.SPLIT_TERMS == 3
    assert all(y.dtype == torch.bfloat16 for y in terms)
    assert torch.equal(terms[0], x.to(torch.bfloat16))
    rest = x.double()
    for y in terms:
        assert torch.equal(y, rest.float().to(torch.bfloat16))
        rest = rest - y.double()
    bound = 2.0 ** (-8 * fl.SPLIT_TERMS)
    assert bool((rest.abs() <= bound * x.double().abs()).all())


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("include_const", [True, False])
def test_plain_forward_matches_jax_interpret(name, include_const):
    """The split design's row sums (``reference_f32_tc_forward``) against
    the JAX kernel K2 with float32 compute."""
    h, ws, bs, t, _ = _case(name, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = jfl._fused_forward(
            jfl._BASE_LL[name], jnp.asarray(h), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), jnp.asarray(t),
            subtract_lgamma_const=include_const, compute_dtype=None,
            t_groups=M // t.shape[0])
    hh, wt, bt, tt, _ = _torch(h, ws, bs, t, np.zeros(M, np.float32))
    assert_close(fl.reference_f32_tc_forward(
        name, hh, wt, bt, tt, include_lgamma_const=include_const), ref)


@pytest.mark.parametrize("name", FAMILIES)
def test_plain_gradient_matches_jax_interpret(name):
    """dh, dW and db from the split design's gradient scratch
    (``reference_f32_tc_gradient``, then the plain products of its
    layout) against the JAX kernel K3 with float32 compute; at a ragged
    width and gene count, off the 8-element padding."""
    h, ws, bs, t, g = _case(name, seed=4, hidden=37, f=301)
    with pltpu.force_tpu_interpret_mode():
        ref_dh, ref_dws, ref_dbs = jfl._fused_backward(
            jfl._BASE_GRADS[name], jnp.asarray(h),
            tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
            jnp.asarray(t), jnp.asarray(g), compute_dtype=None,
            t_groups=M // t.shape[0])
    hh, wt, bt, tt, gt = _torch(h, ws, bs, t, g)
    grad = fl.reference_f32_tc_gradient(name, gt, hh, wt, bt, tt)
    assert grad.suffix == "_float32"
    assert_close(fl.reference_tc_dh(grad), ref_dh)
    got = fl.reference_tc_dw(grad)
    assert len(got) == 2 * len(ws)
    for k, (dw, db) in enumerate(zip(ref_dws, ref_dbs)):
        assert_close(got[2 * k], dw)
        assert_close(got[2 * k + 1], db)


def test_plain_gradient_layout():
    """The gradient scratch in its layout: slot p of da holds term i of
    pair p of g·∂ll/∂a, zero past F; db's row-tile sums add up to Σ_rows
    da; the dW product's rows hold h's term j of pair p, zero past H."""
    name = "negative binomial"
    h, ws, bs, t, g = _torch(*_case(name, seed=5, hidden=37, f=301))
    grad = fl.reference_f32_tc_gradient(name, g, h, ws, bs, t)
    plan = grad.plan
    pairs, fp, hp = len(fl.SPLIT_PAIRS), plan["fp"], plan["hp"]
    da = grad.da.reshape(M, pairs, 2, fp)
    acts = fl._f32_tc_activations(h, ws, bs)
    want = torch.stack(ops.FAMILIES[name].grads(
        *acts, fl._cycle_rows(t, M)), 1) * g[:, None, None]
    terms = fl.split_bf16(want, fl.SPLIT_TERMS)
    for p, (i, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(da[:, p, :, :301], terms[i])
        assert not da[:, p, :, 301:].any()
    assert_close(grad.db_parts.sum(0).reshape(2, fp)[:, :301], want.sum(0))
    h_terms = fl.split_bf16(h, fl.SPLIT_TERMS)
    rows = grad.h.reshape(M, pairs, hp)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(rows[:, p, :37], h_terms[j])
        assert not rows[:, p, 37:].any()


@pytest.mark.parametrize("m,hidden,f,n_heads", [
    (2048, 256, 2048, 2), (64, 37, 301, 3), (20480, 256, 2048, 2),
    (5, 3, 13, 1)])
def test_plan_pads_ragged_widths(m, hidden, f, n_heads):
    """The plan's padded widths (multiples of 8), the scratch of P pairs of
    NH heads, db's row-tile sums of NH heads, and the products' splits over
    the depths P·NH·Fp (dh) and P·M (dW)."""
    plan = fl.f32_tc_plan(m, hidden, f, n_heads)
    pairs = len(fl.SPLIT_PAIRS)
    hp, fp = plan["hp"], plan["fp"]
    assert hp % 8 == 0 and hidden <= hp < hidden + 8
    assert fp % 8 == 0 and f <= fp < f + 8
    assert plan["row_sums"] == (-(-f // 64), m)
    assert plan["da"] == (m, pairs * n_heads * fp)
    assert plan["db_parts"] == (-(-m // 64), n_heads * fp)
    assert plan["dh_splits"] == fl._product_plan(m, hp, pairs * n_heads * fp,
                                                 fl.TC_CLUSTER_CAPACITY)
    assert plan["dw_splits"] == fl._product_plan(hp, n_heads * fp, pairs * m,
                                                 fl.TC_CLUSTER_CAPACITY)
    for key in ("dh_splits", "dw_splits"):
        splits, per, promote = plan[key]
        assert 1 <= splits <= fl.TC_MAX_SPLITS
        assert promote or per * fl.TC_PRODUCT_DEPTH <= fl.TC_PROMOTE_DEPTH


def test_operands_layout():
    """h's terms per pair (M, P, Hp) and W's (Hp, P, NH, Fp): h_j and W_j
    of pair (i, j) in slot p, zero-padded; so W's block i < SPLIT_TERMS
    holds W_i, which the forward's slot p reads for pair (i, j)."""
    name = "zero-inflated negative binomial"
    h, ws, _, _, _ = _torch(*_case(name, seed=6, hidden=37, f=301))
    hh, w = fl._f32_tc_operands(h, ws)
    pairs = len(fl.SPLIT_PAIRS)
    assert hh.shape == (M, pairs, 40) and hh.dtype == torch.bfloat16
    assert w.shape == (40, pairs, 3, 304) and w.dtype == torch.bfloat16
    h_terms = fl.split_bf16(h, fl.SPLIT_TERMS)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(hh[:, p, :37], h_terms[j])
        for k, w_k in enumerate(ws):
            assert torch.equal(w[:37, p, k, :301],
                               fl.split_bf16(w_k, fl.SPLIT_TERMS)[j])
    for i in range(fl.SPLIT_TERMS):
        assert fl.SPLIT_PAIRS[i] == (0, i)
    assert not hh[:, :, 37:].any() and not w[37:].any()
    assert not w[..., 301:].any()


@pytest.mark.parametrize("name", FAMILIES)
def test_cpu_wrappers_run_the_plain_versions(name):
    """On CPU tensors the float32 wrappers return the float32 plain
    versions exactly and launch no kernel."""
    h, ws, bs, t, g = _torch(*_case(name, seed=7))
    ops.reset_launch_counts()
    got = ops.fused_forward(name, h, ws, bs, t)
    assert torch.equal(got, ops.reference_forward(name, h, ws, bs, t))
    got = ops.fused_backward(name, g, h, ws, bs, t)
    want = ops.reference_backward(name, g, h, ws, bs, t)
    assert len(got) == len(want) == 1 + 2 * len(ws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(ops.launch_counts().values())
    # and the split design within the checks' 2e-5 of them
    assert_close(fl.reference_f32_tc_forward(name, h, ws, bs, t),
                 ops.reference_forward(name, h, ws, bs, t))

