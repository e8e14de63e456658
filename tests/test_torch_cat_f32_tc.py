"""The categorised float32 K2/K3 design on the tensor cores
(``ops/csrc/categorised_likelihood_tc.cu`` over depth segments, then the
products of ``tc_product.cu``) on the CPU, through its plain versions: h,
every head's W and da as ``SPLIT_TERMS`` bf16 terms, the products over the
pairs of terms, the base heads first and then the K + 1 class heads.  The
split-layout plain forward (row sums, lse) and gradient (with the products
of its scratch) against the JAX package's ``_make_fused_categorised`` with
float32 compute (Pallas in interpret mode), for ZINB with K = 3 (rows
cycling over half as many target rows) and Poisson with K = 30 (32 heads,
the cap), at ragged H and F; the split of the class-major weights, the
layout of the gradient's scratch and the plan's padded widths; and the CPU
wrappers, which run the float32 plain versions and launch nothing.

Tolerances: rtol 2e-5 against the JAX package, with an absolute floor of
the same fraction of the largest |reference| value, as
``tests/test_torch_f32_tc.py``: three bf16 terms leave at most 2⁻²⁴ of each
value, the rest is float32 summation order (``tools/f32_split_precision.py
--families cat_zinb:10 cat_poisson:30`` reads the design's error on the
CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

M, HIDDEN, F = 64, 37, 301
RTOL = 2e-5
# (base, K, target rows): 7 heads over cycled rows; 32 heads, the cap
CASES = [("zero-inflated negative binomial", 3, M // 2), ("poisson", 30, M)]
IDS = ["zinb-K3", "poisson-K30"]


def _case(name, k_max, m_t, seed, hidden=HIDDEN, f=F):
    """ReLU h, heads three times Glorot-uniform (activations that reach the
    exponentials' clip), class heads (K+1, H, F) / (K+1, F), Poisson(K)
    targets, every other row a third of that (classes below K as well), and
    row cotangents; numpy arrays."""
    rng = np.random.RandomState(seed)
    n_base = len(ops.FAMILIES[name].heads)
    h = np.maximum(rng.randn(M, hidden), 0.0).astype(np.float32)
    limit = 3 * (6.0 / (hidden + f)) ** 0.5
    ws = [rng.uniform(-limit, limit, (hidden, f)).astype(np.float32)
          for _ in range(n_base)]
    bs = [(0.3 * rng.randn(f)).astype(np.float32) for _ in range(n_base)]
    cat_w = rng.uniform(-limit, limit, (k_max + 1, hidden, f)).astype(
        np.float32)
    cat_b = (0.3 * rng.randn(k_max + 1, f)).astype(np.float32)
    t = rng.poisson(float(k_max), (m_t, f)).astype(np.float32)
    t[1::2] = np.floor(t[1::2] / 3)
    g = rng.randn(M).astype(np.float32)
    return h, ws, bs, cat_w, cat_b, t, g


def _torch(h, ws, bs, cat_w, cat_b, t, g):
    tensor = torch.from_numpy
    return (tensor(h), [tensor(w) for w in ws], [tensor(b) for b in bs],
            tensor(cat_w), tensor(cat_b), tensor(t), tensor(g))


def _jax_heads(name, ws, bs):
    return {p: {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
            for p, w, b in zip(ops.FAMILIES[name].heads, ws, bs)}


def assert_close(ours, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().float().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("name,k_max,m_t", CASES, ids=IDS)
def test_plain_forward_matches_jax_interpret(name, k_max, m_t):
    """The split design's row sums (``reference_cat_f32_tc_forward``)
    against the JAX kernel K2 of ``_make_fused_categorised`` with float32
    compute, its lse against JAX's ``_cat_select_and_lse`` over the float32
    class logits, and its row-sum partials per gene tile adding up to its
    row sums."""
    h, ws, bs, cat_w, cat_b, t, g = _case(name, k_max, m_t, seed=3)
    with pltpu.force_tpu_interpret_mode():
        ref = jfl.fused_categorised_log_likelihood(
            name, jnp.asarray(h), _jax_heads(name, ws, bs),
            jnp.asarray(cat_w), jnp.asarray(cat_b), jnp.asarray(t),
            compute_dtype=None)
    logits = [jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
              for w, b in zip(cat_w, cat_b)]
    t_rows = jnp.asarray(np.tile(t, (M // m_t, 1)))
    _, ref_lse = jfl._cat_select_and_lse(logits, t_rows)
    args = _torch(h, ws, bs, cat_w, cat_b, t, g)[:-1]
    out, lse, part = fl.reference_cat_f32_tc_forward(name, *args)
    assert_close(out, ref)
    assert_close(lse, ref_lse)
    assert part.shape == fl.f32_tc_plan(
        M, HIDDEN, F, len(ws) + k_max + 1)["row_sums"]
    assert_close(part.sum(0), out.numpy())


@pytest.mark.parametrize("name,k_max,m_t", CASES, ids=IDS)
def test_plain_gradient_matches_jax_interpret(name, k_max, m_t):
    """dh, every base head's dW and db, and the classes' dW and db from the
    split design's gradient scratch (``reference_cat_f32_tc_gradient`` from
    the split forward's lse, then the plain products of its layout) against
    the VJP of the JAX kernels K2/K3 with float32 compute."""
    h, ws, bs, cat_w, cat_b, t, g = _case(name, k_max, m_t, seed=4)

    def jax_loss(h_, heads_, cw, cb):
        return jfl.fused_categorised_log_likelihood(
            name, h_, heads_, cw, cb, jnp.asarray(t), compute_dtype=None)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_loss, jnp.asarray(h), _jax_heads(name, ws, bs),
                         jnp.asarray(cat_w), jnp.asarray(cat_b))
        ref_dh, ref_dheads, ref_dcw, ref_dcb = vjp(jnp.asarray(g))
    hh, wt, bt, cw, cb, tt, gt = _torch(h, ws, bs, cat_w, cat_b, t, g)
    _, lse, _ = fl.reference_cat_f32_tc_forward(name, hh, wt, bt, cw, cb, tt)
    grad = fl.reference_cat_f32_tc_gradient(name, gt, hh, wt, bt, cw, cb, tt,
                                            lse)
    assert grad.prefix == f"cat_{ops.FAMILIES[name].prefix}"
    assert grad.suffix == "_float32"
    assert_close(fl.reference_tc_dh(grad), ref_dh)
    dw, db = fl.reference_tc_dw_stacked(grad)
    n_base = len(ws)
    assert dw.shape == (n_base + k_max + 1, HIDDEN, F)
    for k, head in enumerate(ops.FAMILIES[name].heads):
        assert_close(dw[k], ref_dheads[head]["kernel"])
        assert_close(db[k], ref_dheads[head]["bias"])
    assert_close(dw[n_base:], ref_dcw)
    assert_close(db[n_base:], ref_dcb)


def test_plain_gradient_layout():
    """The gradient scratch in its layout: slot p of da holds term i of
    pair p of g·∂ll/∂a for every head, the base heads first and then the
    classes, zero past F; db's row-tile sums add up to Σ_rows da; the dW
    product's rows hold h's term j of pair p, zero past H."""
    name, k_max, m_t = CASES[0]
    h, ws, bs, cw, cb, t, g = _torch(*_case(name, k_max, m_t, seed=5))
    _, lse, _ = fl.reference_cat_f32_tc_forward(name, h, ws, bs, cw, cb, t)
    grad = fl.reference_cat_f32_tc_gradient(name, g, h, ws, bs, cw, cb, t,
                                            lse)
    plan = grad.plan
    n_heads = len(ws) + k_max + 1
    pairs, fp, hp = len(fl.SPLIT_PAIRS), plan["fp"], plan["hp"]
    assert grad.da.shape == plan["da"] == (M, pairs * n_heads * fp)
    da = grad.da.reshape(M, pairs, n_heads, fp)
    acts = fl._f32_tc_activations(h, [*ws, *cw], [*bs, *cb])
    want = torch.stack(fl.categorised_grads(name, k_max)(
        acts, fl._cycle_rows(t, M), lse), 1) * g[:, None, None]
    terms = fl.split_bf16(want, fl.SPLIT_TERMS)
    for p, (i, _) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(da[:, p, :, :F], terms[i])
        assert not da[:, p, :, F:].any()
    assert_close(grad.db_parts.sum(0).reshape(n_heads, fp)[:, :F],
                 want.sum(0).numpy())
    h_terms = fl.split_bf16(h, fl.SPLIT_TERMS)
    rows = grad.h.reshape(M, pairs, hp)
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        assert torch.equal(rows[:, p, :HIDDEN], h_terms[j])
        assert not rows[:, p, HIDDEN:].any()


@pytest.mark.parametrize("name,k_max,m_t", CASES, ids=IDS)
def test_operands_layout_with_class_major_weights(name, k_max, m_t):
    """The pack's plain version over the class-major weights: every head's
    W terms per pair (Hp, P, NH, Fp), the base heads in the family's order,
    then class c in slot n_base + c, W_j of pair (i, j) in block p,
    zero-padded; h's terms per pair (M, P, Hp)."""
    h, ws, _, cw, _, _, _ = _torch(*_case(name, k_max, m_t, seed=6))
    hh, w = fl._f32_tc_operands(h, ws, cw)
    pairs, n_base = len(fl.SPLIT_PAIRS), len(ws)
    assert hh.shape == (M, pairs, 40) and hh.dtype == torch.bfloat16
    assert w.shape == (40, pairs, n_base + k_max + 1, 304)
    assert w.dtype == torch.bfloat16
    heads = [*ws, *cw]
    for p, (_, j) in enumerate(fl.SPLIT_PAIRS):
        for k, w_k in enumerate(heads):
            assert torch.equal(w[:HIDDEN, p, k, :F],
                               fl.split_bf16(w_k, fl.SPLIT_TERMS)[j])
    assert not w[HIDDEN:].any() and not w[..., F:].any()
    # the base families' layout is the same operands without the classes
    base_hh, base_w = fl._f32_tc_operands(h, ws)
    assert torch.equal(base_hh, hh)
    assert torch.equal(base_w, w[:, :, :n_base])


@pytest.mark.parametrize("m,hidden,f,n_heads", [
    (2048, 256, 2048, 32), (2048, 256, 2048, 14), (64, 37, 301, 7),
    (20480, 256, 2048, 14)])
def test_plan_pads_ragged_widths(m, hidden, f, n_heads):
    """The float32 plan at categorised head counts: the forward's row-sum
    partials (F tiles, M), the scratch of P pairs of NH heads, db's row-tile
    sums of NH heads, and the products' splits over the depths P·NH·Fp (dh)
    and P·M (dW), none summing more than TC_PROMOTE_DEPTH unpromoted."""
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


@pytest.mark.parametrize("m", [2048, 6144, 20480])
def test_scratch_past_32_bit_offsets(m):
    """At 32 heads the float32 scratch outgrows 32-bit offsets (from 6,144
    rows on; a categorised GMVAE sends 20,480), while each of the products'
    extents (rows, widths, depths) stays within 32 bits, as their TMA
    coordinates and the kernels' row and column indices need."""
    plan = fl.f32_tc_plan(m, 256, 2048, 32)
    elements = plan["da"][0] * plan["da"][1]
    assert (elements >= 2 ** 31) == (m >= 6144)
    pairs = len(fl.SPLIT_PAIRS)
    for extent in (*plan["da"], pairs * m, 32 * plan["fp"]):
        assert extent < 2 ** 31


@pytest.mark.parametrize("name,k_max,m_t", CASES, ids=IDS)
def test_cpu_wrappers_run_the_plain_versions(name, k_max, m_t):
    """On CPU tensors the float32 categorised wrappers return the float32
    plain versions exactly and launch no kernel; the split design lies
    within the checks' 2e-5 of them."""
    h, ws, bs, cw, cb, t, g = _torch(*_case(name, k_max, m_t, seed=7))
    args = (h, ws, bs, cw, cb, t)
    ops.reset_launch_counts()
    ll, lse = ops.categorised_forward(name, *args)
    ref_ll, ref_lse = ops.reference_categorised_forward(name, *args)
    assert torch.equal(ll, ref_ll) and torch.equal(lse, ref_lse)
    got = ops.categorised_backward(name, g, *args, lse)
    want = (ops.reference_categorised_dh(name, g, *args, lse),
            *ops.reference_categorised_dw(name, g, *args, lse))
    assert len(got) == len(want) == 2 * len(ws) + 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(ops.launch_counts().values())
    out, lse_split, _ = fl.reference_cat_f32_tc_forward(name, *args)
    assert_close(out, ref_ll.numpy())
    assert_close(lse_split, ref_lse.numpy())
