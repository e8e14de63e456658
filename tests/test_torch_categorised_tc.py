"""The bf16 categorised forward and backward of the port in the
tensor-core kernels' layout, on the CPU: the plain version of the forward
kernel (``reference_cat_tc_forward``: the row sums per 64-gene tile and the
per-element lse), of the gradient kernel (``reference_cat_tc_gradient``:
bf16(da) of every head, base heads first, in the (M, NH·Fp) scratch, and
its column sums per 64-row tile) and the plain products ``reference_tc_dh``
/ ``reference_tc_dw_stacked`` applied to it, against the JAX package's
``fused_categorised_log_likelihood`` in interpret mode; the planner's grid,
splits and scratch shapes at the categorised widths; the CPU paths of
``categorised_forward`` and ``categorised_backward``.

Tolerance against JAX: rtol 2e-3 of the largest |reference| value, as the
other bf16 comparisons (``tests/test_torch_categorised.py``): h, W and da
are rounded to bf16 on both sides, and the two sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as tfl

BASES = list(ops.FAMILIES)
# rows off the 64-row tile, H and F off the 8-wide padding (24, 32)
M, HIDDEN, F, K = 70, 21, 29, 3


def assert_close(ours, ref, rtol):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * max(1e-30, float(np.abs(ref).max())))


def _case(name, k_max=K, m=M, m_t=M, hidden=HIDDEN, f=F, seed=0):
    """h, base heads, class heads (K+1, H, F) / (K+1, F), Poisson(K)
    targets (below, at and past K) and row cotangents, as numpy."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(m, hidden) * 0.5).astype(np.float32)
    limit = np.sqrt(6.0 / (hidden + f))
    heads = {
        p: {"kernel": (rng.uniform(-limit, limit, (hidden, f)) * 3)
            .astype(np.float32),
            "bias": (0.3 * rng.randn(f)).astype(np.float32)}
        for p in ops.FAMILIES[name].heads
    }
    cat_w = (rng.uniform(-limit, limit, (k_max + 1, hidden, f)) * 3).astype(
        np.float32)
    cat_b = (0.3 * rng.randn(k_max + 1, f)).astype(np.float32)
    t = rng.poisson(float(k_max), (m_t, f)).astype(np.float32)
    g = rng.randn(m).astype(np.float32)
    return h, heads, cat_w, cat_b, t, g


def _torch_args(name, h, heads, cat_w, cat_b, t):
    names = ops.FAMILIES[name].heads
    return (torch.from_numpy(h),
            [torch.from_numpy(heads[p]["kernel"]) for p in names],
            [torch.from_numpy(heads[p]["bias"]) for p in names],
            torch.from_numpy(cat_w), torch.from_numpy(cat_b),
            torch.from_numpy(t))


def _plain_tc_backward(name, g, h, ws, bs, cw, cb, t):
    """dh, the base heads' (dW, db) and the classes' (dW, db) through the
    plain versions of the three tensor-core kernels, with the lse of the
    plain bf16 forward."""
    _, lse = ops.reference_categorised_forward(name, h, ws, bs, cw, cb, t,
                                               compute_dtype=torch.bfloat16)
    grad = tfl.reference_cat_tc_gradient(name, g, h, ws, bs, cw, cb, t, lse)
    dw, db = tfl.reference_tc_dw_stacked(grad)
    return grad, tfl.reference_tc_dh(grad), dw, db


@pytest.mark.parametrize("name", BASES)
@pytest.mark.parametrize("m_t", [M, 14])
def test_tensor_core_forward_matches_jax_interpret(name, m_t):
    """The plain forward kernel's outputs, its row-sum partials summed over
    the gene tiles and its lse, against JAX's fused categorised likelihood
    (bf16, interpret mode) and JAX's own select-and-lse of the same rounded
    activations; K = 5, six classes (not a multiple of the kernel's class
    group), F = 150 over three gene tiles, targets below, at and past K."""
    k_max, f = 5, 150
    h, heads, cat_w, cat_b, t, _ = _case(name, k_max=k_max, m_t=m_t, f=f)
    t[:, :4] = [0.0, k_max - 1.0, float(k_max), k_max + 2.0]
    t_full = np.tile(t, (M // m_t, 1))
    bf16 = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref_rows = jfl.fused_categorised_log_likelihood(
            name, jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, heads),
            jnp.asarray(cat_w), jnp.asarray(cat_b), jnp.asarray(t_full),
            compute_dtype=bf16)
    hb = jnp.asarray(h).astype(bf16)
    cat_acts = [jnp.dot(hb, jnp.asarray(w).astype(bf16),
                        preferred_element_type=jnp.float32) + b
                for w, b in zip(cat_w, cat_b)]
    _, ref_lse = jfl._cat_select_and_lse(cat_acts, jnp.asarray(t_full))

    args = _torch_args(name, h, heads, cat_w, cat_b, t)
    partials, lse = tfl.reference_cat_tc_forward(name, *args)
    assert partials.shape == tfl.tc_plan(M, HIDDEN, f, 1)["row_sums"] == (
        3, M)
    assert lse.shape == (M, f)
    assert_close(partials.sum(0), ref_rows, 2e-3)
    assert_close(lse, ref_lse, 2e-3)


@pytest.mark.parametrize("m,f,n_heads,want", [
    # ZINB-cat (14 heads) and Poisson-cat (32) at the headline shape: 32
    # gene tiles of forward partials, 32 row tiles of gradient column sums
    (2048, 2048, 14, dict(row_sums=(32, 2048), db_parts=(32, 14 * 2048))),
    (2048, 2048, 32, dict(row_sums=(32, 2048), db_parts=(32, 32 * 2048))),
    # a ragged F (the last gene tile 16 wide) and rows off the row tile
    (300, 2000, 32, dict(fp=2000, row_sums=(32, 300),
                         db_parts=(5, 32 * 2000))),
    (70, 29, 14, dict(fp=32, row_sums=(1, 70), db_parts=(2, 14 * 32))),
])
def test_tensor_core_forward_plan(m, f, n_heads, want):
    """The heads kernels' partial arrays, which the wrappers allocate from
    the plan: the forward's one row per 64-gene tile, the gradient
    kernel's one row per 64-row tile, whatever the head count."""
    plan = tfl.tc_plan(m, 256, f, n_heads)
    assert {k: plan[k] for k in want} == want
    gene_tiles, rows = plan["row_sums"]
    assert rows == m
    assert ((gene_tiles - 1) * tfl.TC_GENE_TILE < f
            <= gene_tiles * tfl.TC_GENE_TILE)
    row_tiles = plan["db_parts"][0]
    assert (row_tiles - 1) * tfl.TC_ROW_TILE < m <= row_tiles * tfl.TC_ROW_TILE


@pytest.mark.parametrize("name", BASES)
def test_categorised_forward_on_the_cpu_is_plain(name):
    """``categorised_forward`` on CPU tensors is the plain forward, bit for
    bit, in float32 and in bf16, and launches nothing; the plain forward
    kernel's partials add up to its row sums and its lse is the plain
    bf16 lse."""
    h, heads, cat_w, cat_b, t, _ = _case(name, k_max=6, m_t=14, f=140,
                                         seed=4)
    args = _torch_args(name, h, heads, cat_w, cat_b, t)
    before = dict(ops.launch_counts())
    for compute in (None, torch.bfloat16):
        got = ops.categorised_forward(name, *args, compute_dtype=compute)
        want = ops.reference_categorised_forward(name, *args,
                                                 compute_dtype=compute)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    partials, lse = tfl.reference_cat_tc_forward(name, *args)
    assert torch.equal(lse, want[1])
    assert_close(partials.sum(0), want[0].numpy(), 1e-6)
    assert ops.launch_counts() == before
    prefix = ops.FAMILIES[name].prefix
    assert {f"cat_{prefix}_forward", f"cat_{prefix}_forward_float32"} <= set(
        before)


@pytest.mark.parametrize("name", BASES)
@pytest.mark.parametrize("m_t", [M, 14])
def test_tensor_core_backward_matches_jax_interpret(name, m_t):
    """dh, every dW and every db of the plain tensor-core pieces against
    the vjp of JAX's fused categorised likelihood (bf16, interpret mode),
    over all rows and over rows cycling on shared targets."""
    h, heads, cat_w, cat_b, t, g = _case(name, m_t=m_t)
    t[:, :4] = [0.0, K - 1.0, float(K), K + 2.0]
    t_full = np.tile(t, (M // m_t, 1))

    def jax_loss(h_, heads_, cw, cb):
        return jfl.fused_categorised_log_likelihood(
            name, h_, heads_, cw, cb, jnp.asarray(t_full),
            compute_dtype=jnp.bfloat16)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_loss, jnp.asarray(h),
                         jax.tree_util.tree_map(jnp.asarray, heads),
                         jnp.asarray(cat_w), jnp.asarray(cat_b))
        ref_dh, ref_dheads, ref_dcw, ref_dcb = vjp(jnp.asarray(g))

    h_, ws, bs, cw, cb, t_ = _torch_args(name, h, heads, cat_w, cat_b, t)
    _, dh, dw, db = _plain_tc_backward(name, torch.from_numpy(g), h_, ws, bs,
                                       cw, cb, t_)
    n_base = len(ws)
    assert dh.shape == (M, HIDDEN) and dw.shape == (n_base + K + 1, HIDDEN, F)
    assert_close(dh, ref_dh, 2e-3)
    for k, p in enumerate(ops.FAMILIES[name].heads):
        assert_close(dw[k], ref_dheads[p]["kernel"], 2e-3)
        assert_close(db[k], ref_dheads[p]["bias"], 2e-3)
    assert_close(dw[n_base:], ref_dcw, 2e-3)
    assert_close(db[n_base:], ref_dcb, 2e-3)


@pytest.mark.parametrize("m,hidden,f,n_heads,want", [
    # ZINB-cat, K = 10 (14 heads): dh 16 blocks over 448 stages in 6 splits
    # (17 clusters of 6 fit the H100 at once) would each sum 4,800 deep, so
    # the sums are promoted, on 32 blocks of 128 x 128 in clusters of 3 (39
    # fit, of 4 only 30); dW 2 x 112 blocks fill the card without a split
    (2048, 256, 2048, 14,
     dict(da=(2048, 28672), db_parts=(32, 28672), dh_splits=(3, 150, True),
          dw_splits=(1, 32, False))),
    # Poisson-cat, K = 30 (32 heads, the cap): depth 65,536; promoted as
    # ZINB-cat's, 3 splits of 342 stages; dW 2 x 256 blocks
    (2048, 256, 2048, 32,
     dict(da=(2048, 65536), db_parts=(32, 65536), dh_splits=(3, 342, True),
          dw_splits=(1, 32, False))),
    # a depth that is not a multiple of a stage: 5 heads of 2,000 genes =
    # 10,000 = 156.25 stages -> 157, in 8 splits of 20 (the last 17); dW's
    # 300 rows are 4.7 stages -> 5
    (300, 256, 2000, 5,
     dict(fp=2000, da=(300, 10000), db_parts=(5, 10000),
          dh_splits=(8, 20, False), dw_splits=(1, 5, False))),
    # 32 heads of 4,096 genes: promoted, 32 tiles of 128 x 128 in clusters
    # of 3, each split 43,712 deep
    (2048, 256, 4096, 32,
     dict(dh_splits=(3, 683, True), dw_splits=(1, 32, False))),
])
def test_tensor_core_plan_categorised_widths(m, hidden, f, n_heads, want):
    """The planner at the categorised widths: scratch shapes, the products'
    cluster splits (each of at least TC_MIN_SPLIT_DEPTH stages, covering
    the depth) and where it promotes the sums."""
    plan = tfl.tc_plan(m, hidden, f, n_heads)
    assert {k: plan[k] for k in want} == want
    for key, depth in (("dh_splits", n_heads * plan["fp"]),
                       ("dw_splits", m)):
        splits, per, promote = plan[key]
        k_tiles = -(-depth // tfl.TC_PRODUCT_DEPTH)
        assert (splits - 1) * per < k_tiles <= splits * per
        assert 1 <= splits <= tfl.TC_MAX_SPLITS
        assert promote or per * tfl.TC_PRODUCT_DEPTH <= tfl.TC_PROMOTE_DEPTH


@pytest.mark.parametrize("name", BASES)
def test_tensor_core_scratch_layout(name):
    """The plain gradient kernel's outputs in the kernel's layout: bf16(da)
    (M, NH·Fp) with the base heads first and zeros past F, equal to the
    rounded da of the plain categorised backward; row-tile column sums that
    add up to db; W (Hp, NH, Fp) holding the base, then the class heads."""
    h, heads, cat_w, cat_b, t, g = _case(name, m_t=14, seed=2)
    h_, ws, bs, cw, cb, t_ = _torch_args(name, h, heads, cat_w, cat_b, t)
    g_ = torch.from_numpy(g)
    grad, _, _, db = _plain_tc_backward(name, g_, h_, ws, bs, cw, cb, t_)
    n_heads = len(ws) + K + 1
    fp = tfl.tc_padded(F)
    assert grad.prefix == f"cat_{ops.FAMILIES[name].prefix}"
    assert grad.da.dtype == torch.bfloat16
    assert grad.da.shape == (M, n_heads * fp)
    assert grad.db_parts.shape == (-(-M // tfl.TC_ROW_TILE), n_heads * fp)
    da = grad.da.reshape(M, n_heads, fp)
    assert not da[:, :, F:].any()
    assert grad.w.shape == (tfl.tc_padded(HIDDEN), n_heads, fp)
    assert torch.equal(grad.w[:HIDDEN, len(ws):, :F],
                       cw.permute(1, 0, 2).to(torch.bfloat16))
    for k, w_k in enumerate(ws):
        assert torch.equal(grad.w[:HIDDEN, k, :F], w_k.to(torch.bfloat16))
    _, lse = ops.reference_categorised_forward(name, h_, ws, bs, cw, cb, t_,
                                               compute_dtype=torch.bfloat16)
    _, das = tfl._categorised_weighted_grads(name, g_, h_, ws, bs, cw, cb,
                                             t_, lse, torch.bfloat16)
    assert torch.equal(da[:, :, :F], torch.stack(das, 1).to(torch.bfloat16))
    assert_close(db, torch.stack([d.sum(0) for d in das]).numpy(), 1e-6)


@pytest.mark.parametrize("name", BASES)
def test_categorised_backward_on_the_cpu_is_plain(name):
    """``categorised_backward`` on CPU tensors is the plain dh and dW/db
    passes, bit for bit, in the order (dh, dW_0, db_0, …, dW_classes,
    db_classes), and launches nothing."""
    h, heads, cat_w, cat_b, t, g = _case(name, seed=3)
    args = _torch_args(name, h, heads, cat_w, cat_b, t)
    g_ = torch.from_numpy(g)
    _, lse = ops.categorised_forward(name, *args,
                                     compute_dtype=torch.bfloat16)
    before = dict(ops.launch_counts())
    for compute in (None, torch.bfloat16):
        got = ops.categorised_backward(name, g_, *args[:-1], args[-1], lse,
                                       compute_dtype=compute)
        want = (ops.reference_categorised_dh(name, g_, *args, lse,
                                             compute_dtype=compute),
                *ops.reference_categorised_dw(name, g_, *args, lse,
                                              compute_dtype=compute))
        assert len(got) == len(want) == 2 * len(args[1]) + 3
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ops.launch_counts() == before
    prefix = ops.FAMILIES[name].prefix
    assert {f"cat_{prefix}_backward_{kernel}{suffix}"
            for kernel in ("gradient", "dh", "dw")
            for suffix in ("", "_float32")} - {
                f"cat_{prefix}_backward_gradient_float32"} <= set(before)
