"""The constrained Poisson's float32 K6/K7 design on the tensor cores
(``ops/csrc/cp_likelihood_tc.cu`` over depth segments, then the products of
``tc_product.cu``) on the CPU, through its plain versions: h, W and da as
``SPLIT_TERMS`` bf16 terms, the products over the pairs of terms.  The
split-layout plain forward and gradient (with the products of its scratch)
against the JAX package's ``_cp_fused_forward`` / ``_cp_fused_backward``
with float32 h, so float32 compute (Pallas in interpret mode), at the
headline decoder width 256 with 1,024 genes, at a ragged width and gene
count, and with target rows that cycle; the layout of the split operands
and of the gradient's scratch, and the plan's widths; and the CPU
wrappers, which run the float32 plain versions and launch nothing.

Tolerances: rtol 2e-5 against the JAX package, with an absolute floor of
the same fraction of the largest |reference| value: three bf16 terms leave
at most 2⁻²⁴ of each value (``tools/f32_split_precision.py --families cp``
reads at most 2.6e-6 of the largest value against the float32 plain
versions, on seeds 0–2 at the headline shape and where a spreads widely
over the genes), the rest is float32 summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

RTOL = 2e-5
# (M, M_t, H, F): the headline width over full 512-gene JAX tiles; a ragged
# width and gene count (off the port's 64-gene tiles and the 8-element
# padding); rows cycling over a quarter as many targets
CASES = [(64, 64, 256, 1024), (48, 48, 37, 301), (64, 16, 40, 300)]


def _case(m, m_t, hidden, f, seed):
    """A decoder output of ReLU values, Glorot-uniform W, Poisson(2)
    targets of ~25% density, count sums a little above Σt, row
    cotangents."""
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(m, hidden), 0.0).astype(np.float32)
    limit = (6.0 / (hidden + f)) ** 0.5
    w = rng.uniform(-limit, limit, (hidden, f)).astype(np.float32)
    b = (0.3 * rng.randn(f)).astype(np.float32)
    t = (rng.poisson(2.0, (m_t, f)) * (rng.rand(m_t, f) < 0.25)).astype(
        np.float32)
    n = (np.tile(t.sum(-1), m // m_t)
         + rng.uniform(0.5, 5.0, m)).astype(np.float32)
    g = rng.randn(m).astype(np.float32)
    return h, w, b, t, n, g


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def _jax_rows(t, m):
    """The targets cycled to m rows, as the JAX kernels take them."""
    return jnp.asarray(np.tile(t, (m // t.shape[0], 1)))


def assert_close(ours, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().float().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("m,m_t,hidden,f", CASES)
def test_plain_forward_matches_jax_interpret(m, m_t, hidden, f):
    """ll and lse of the split design's forward
    (``reference_cp_f32_tc_forward``, its partials per gene tile merged in
    order) against the JAX kernel K6 on the same float32 h."""
    h, w, b, t, n, _ = _case(m, m_t, hidden, f, seed=m + f)
    with pltpu.force_tpu_interpret_mode():
        ref_ll, ref_lse = jfl._cp_fused_forward(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), _jax_rows(t, m),
            jnp.asarray(n))
    ll, lse, partials = fl.reference_cp_f32_tc_forward(*_torch(h, w, b, t, n))
    assert partials.shape == (fl.CP_PARTIALS, -(-f // 64), m)
    assert_close(ll, ref_ll)
    assert_close(lse, ref_lse)


@pytest.mark.parametrize("m,m_t,hidden,f", CASES)
def test_plain_gradient_matches_jax_interpret(m, m_t, hidden, f):
    """dh, dW and db from the split design's gradient scratch
    (``reference_cp_f32_tc_gradient``, then the plain products of its
    layout) against the JAX kernel K7 with float32 h, both from the JAX
    forward's lse."""
    h, w, b, t, n, g = _case(m, m_t, hidden, f, seed=m + f + 1)
    with pltpu.force_tpu_interpret_mode():
        _, lse = jfl._cp_fused_forward(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), _jax_rows(t, m),
            jnp.asarray(n))
        ref = jfl._cp_fused_backward(
            jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), _jax_rows(t, m),
            lse, jnp.asarray(g))
    ht, wt, bt, tt, gt = _torch(h, w, b, t, g)
    grad = fl.reference_cp_f32_tc_gradient(gt, ht, wt, bt, tt,
                                           torch.from_numpy(np.array(lse)))
    assert (grad.prefix, grad.suffix) == ("cp", "_float32")
    got = (fl.reference_tc_dh(grad), *fl.reference_tc_dw(grad))
    for ours, want in zip(got, ref, strict=True):
        assert ours.shape == want.shape
        assert_close(ours, want)


def test_operands_layout():
    """h's terms per pair (M, P, Hp) and W's (Hp, P, 1, Fp): h_j and W_j of
    pair (i, j) in slot p, zero-padded, so that W's block i < SPLIT_TERMS
    holds W_i; the plain version of the float32 entries' split
    (``split_pack_kernel``)."""
    h, w, *_ = _torch(*_case(16, 16, 37, 301, seed=3))
    hh, wp = fl._f32_tc_operands(h, [w])
    pairs = len(fl.SPLIT_PAIRS)
    assert hh.shape == (16, pairs, 40) and hh.dtype == torch.bfloat16
    assert wp.shape == (40, pairs, 1, 304) and wp.dtype == torch.bfloat16
    h_terms = fl.split_bf16(h, fl.SPLIT_TERMS)
    w_terms = fl.split_bf16(w, fl.SPLIT_TERMS)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(hh[:, p, :37], h_terms[j])
        assert torch.equal(wp[:37, p, 0, :301], w_terms[j])
    for i in range(fl.SPLIT_TERMS):
        assert torch.equal(wp[:37, i, 0, :301], w_terms[i])
    assert not hh[:, :, 37:].any()
    assert not wp[37:].any() and not wp[..., 301:].any()


def test_plain_gradient_layout():
    """The gradient's scratch in its layout: slot p of da holds term i of
    pair p of g·(t − (Σt)·exp(a − lse)) from the split design's
    activations, zero past F; db's row-tile sums add up to Σ_rows da; the
    dW product's rows hold h's term j of pair p, zero past H; the plain
    forward's partials merge to its ll and lse."""
    m, m_t, hidden, f = 70, 35, 37, 301
    h, w, b, t, n, g = _torch(*_case(m, m_t, hidden, f, seed=4))
    ll, lse, partials = fl.reference_cp_f32_tc_forward(h, w, b, t, n)
    a = fl._f32_tc_activations(h, [w], [b])[0]
    for k in range(partials.shape[1]):
        cols = slice(64 * k, min(64 * (k + 1), f))
        assert torch.equal(partials[0, k], a[:, cols].amax(-1))
    merged = fl._cp_merge(partials, n)
    assert torch.equal(merged[0], ll) and torch.equal(merged[1], lse)
    assert_close(lse, torch.logsumexp(a, -1).numpy())

    grad = fl.reference_cp_f32_tc_gradient(g, h, w, b, t, lse)
    plan = grad.plan
    pairs, hp, fp = len(fl.SPLIT_PAIRS), plan["hp"], plan["fp"]
    assert (hp, fp) == (40, 304)
    assert grad.da.shape == plan["da"] == (m, pairs * fp)
    tt = t.repeat(m // m_t, 1)
    want = g[:, None] * (tt - tt.sum(-1, keepdim=True)
                         * torch.exp(a - lse[:, None]))
    terms = fl.split_bf16(want, fl.SPLIT_TERMS)
    da = grad.da.reshape(m, pairs, fp)
    for p, (i, _) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(da[:, p, :f], terms[i])
        assert not da[:, p, f:].any()
    assert grad.db_parts.shape == plan["db_parts"] == (2, fp)
    assert_close(grad.db_parts.sum(0)[:f], want.sum(0).numpy())
    assert not grad.db_parts[:, f:].any()
    h_terms = fl.split_bf16(h, fl.SPLIT_TERMS)
    rows = grad.h.reshape(m, pairs, hp)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(rows[:, p, :hidden], h_terms[j])
        assert not rows[:, p, hidden:].any()
    assert torch.equal(grad.w, fl._f32_tc_operands(h, [w])[1])


@pytest.mark.parametrize("m,hidden,f", [(2048, 256, 2048), (48, 37, 301),
                                        (20480, 256, 2048), (5, 3, 13)])
def test_plan_widths(m, hidden, f):
    """The plan of the float32 CP kernels (``f32_tc_plan`` with one head):
    padded widths (multiples of 8), the forward's partials per gene tile,
    the scratch of P pairs, db's row-tile sums, and the products' splits
    over the depths P·Fp (dh) and P·M (dW)."""
    plan = fl.f32_tc_plan(m, hidden, f, 1)
    pairs = len(fl.SPLIT_PAIRS)
    hp, fp = plan["hp"], plan["fp"]
    assert hp % 8 == 0 and hidden <= hp < hidden + 8
    assert fp % 8 == 0 and f <= fp < f + 8
    assert plan["row_sums"] == (-(-f // 64), m)
    assert plan["da"] == (m, pairs * fp)
    assert plan["db_parts"] == (-(-m // 64), fp)
    assert plan["dh_splits"] == fl._product_plan(m, hp, pairs * fp,
                                                 fl.TC_CLUSTER_CAPACITY)
    assert plan["dw_splits"] == fl._product_plan(hp, fp, pairs * m,
                                                 fl.TC_CLUSTER_CAPACITY)
    for key in ("dh_splits", "dw_splits"):
        splits, per, promote = plan[key]
        assert 1 <= splits <= fl.TC_MAX_SPLITS
        assert promote or per * fl.TC_PRODUCT_DEPTH <= fl.TC_PROMOTE_DEPTH


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors float32 h runs the float32 plain versions exactly and
    launches no kernel; the split design is within 2e-5 of them; every
    float32 CP kernel has its counter."""
    h, w, b, t, n, g = _torch(*_case(48, 16, 40, 300, seed=5))
    ops.reset_launch_counts()
    ll, lse = ops.cp_forward(h, w, b, t, n)
    ll_ref, lse_ref = ops.reference_cp_forward(h, w, b, t, n)
    assert torch.equal(ll, ll_ref) and torch.equal(lse, lse_ref)
    got = ops.cp_backward(g, h, w, b, t, lse)
    want = (ops.reference_cp_dh(g, h, w, b, t, lse),
            *ops.reference_cp_dw(g, h, w, b, t, lse))
    for a, b_ in zip(got, want, strict=True):
        assert torch.equal(a, b_)
    assert not any(ops.launch_counts().values())
    split = fl.reference_cp_f32_tc_forward(h, w, b, t, n)
    assert_close(split[0], ll_ref.numpy())
    assert_close(split[1], lse_ref.numpy())
    grad = fl.reference_cp_f32_tc_gradient(g, h, w, b, t, lse)
    for a, b_ in zip((fl.reference_tc_dh(grad), *fl.reference_tc_dw(grad)),
                     want, strict=True):
        assert_close(a, b_.numpy())
    assert {f"cp_{kernel}_float32" for kernel in (
        "forward", "backward_gradient", "backward_dh", "backward_dw")} <= set(
            ops.launch_counts())
