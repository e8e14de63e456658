"""The fused likelihood of every base family — Poisson, NB, ZIP, ZINB
(kernels K2 / K3; the CPU runs their plain versions through
``FusedLogLikelihood``) — against the JAX package's
``fused_log_likelihood`` and its VJP, the Pallas kernels in interpret mode.

Tolerances: float32 compute rtol 1e-5 (sums in another order); bf16 compute
rtol 2e-3 (h, W and da rounded to bf16 on both sides, a few products land on
a neighbouring bf16 value).  Absolute floors are the same fraction of the
largest |reference| value, for gradient entries near zero.  Elementwise
pieces: rtol 1e-6 (the same float32 formulas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops

HIDDEN, F = 20, 600  # F not a multiple of the TPU kernel's 512-gene tile
FAMILIES = list(ops.FAMILIES)
JAX_GRADS = {"poisson": jfl._poisson_grad, "negative binomial": jfl._nb_grads,
             "zero-inflated poisson": jfl._zip_grads,
             "zero-inflated negative binomial": jfl._zinb_grads}


def _case(name, m=40, m_t=None, seed=0):
    rng = np.random.RandomState(seed)
    m_t = m if m_t is None else m_t
    h = np.maximum(rng.randn(m, HIDDEN), 0.0).astype(np.float32)
    limit = np.sqrt(6.0 / (HIDDEN + F))
    heads = {
        head: {
            "kernel": rng.uniform(-limit, limit, (HIDDEN, F)).astype(np.float32) * 3,
            "bias": (0.3 * rng.randn(F)).astype(np.float32),
        }
        for head in ops.FAMILIES[name].heads
    }
    t = rng.poisson(2.0, (m_t, F)).astype(np.float32)  # 13% zeros
    g = rng.randn(m).astype(np.float32)
    return h, heads, t, g


def _jax_heads(heads):
    return jax.tree_util.tree_map(jnp.asarray, heads)


def _torch_heads(heads, requires_grad=False):
    return {
        name: {k: torch.from_numpy(v).requires_grad_(requires_grad)
               for k, v in head.items()}
        for name, head in heads.items()
    }


def _tols(compute):
    return 1e-5 if compute is None else 2e-3


def assert_close(ours, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours.detach().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("compute", [None, "bf16"])
@pytest.mark.parametrize("include_const", [True, False])
def test_forward_and_vjp_match_jax_interpret(name, compute, include_const):
    h, heads, t, g = _case(name)
    jax_dtype = None if compute is None else jnp.bfloat16
    torch_dtype = None if compute is None else torch.bfloat16

    def jax_loss(h_, heads_):
        return jfl.fused_log_likelihood(
            name, h_, heads_, jnp.asarray(t),
            compute_dtype=jax_dtype, include_lgamma_const=include_const,
        )

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_loss, jnp.asarray(h), _jax_heads(heads))
        ref_dh, ref_dheads = vjp(jnp.asarray(g))

    h_t = torch.from_numpy(h).requires_grad_(True)
    heads_t = _torch_heads(heads, requires_grad=True)
    out = ops.fused_log_likelihood(
        name, h_t, heads_t, torch.from_numpy(t),
        compute_dtype=torch_dtype, include_lgamma_const=include_const,
    )
    rtol = _tols(compute)
    assert_close(out, ref, rtol)
    names = ops.FAMILIES[name].heads
    leaves = [h_t] + [heads_t[n][k] for n in names for k in ("kernel", "bias")]
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    refs = [ref_dh] + [ref_dheads[n][k] for n in names
                       for k in ("kernel", "bias")]
    for ours, want in zip(grads, refs):
        assert_close(ours, want, rtol)


@pytest.mark.parametrize("name", FAMILIES)
def test_shared_targets_cycle_rows(name):
    """h with a leading sample axis (S, B, H) against t (B, F): rows cycle
    over the shared targets, as in the JAX package."""
    h, heads, t, _ = _case(name, m=2 * 16, m_t=16, seed=3)
    h3 = h.reshape(2, 16, HIDDEN)
    ref = jfl.reference_log_likelihood(
        name, jnp.asarray(h3), _jax_heads(heads), jnp.asarray(t)[None],
    )
    with pltpu.force_tpu_interpret_mode():
        fused = jfl.fused_log_likelihood(
            name, jnp.asarray(h3), _jax_heads(heads), jnp.asarray(t),
        )
    out = ops.fused_log_likelihood(
        name, torch.from_numpy(h3), _torch_heads(heads), torch.from_numpy(t),
    )
    assert out.shape == (2, 16)
    assert_close(out, ref, 1e-5)
    assert_close(out, fused, 1e-5)
    unfused = ops.reference_log_likelihood(
        name, torch.from_numpy(h3), _torch_heads(heads),
        torch.from_numpy(t)[None],
    )
    assert_close(unfused, ref, 1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_elementwise_grads_match_jax(name):
    """ll and its gradients per element, across and beyond every clip
    range, with a third of the targets zero (the zero-inflated branch)."""
    rng = np.random.RandomState(5)
    n_heads = len(ops.FAMILIES[name].heads)
    acts = [rng.uniform(-30, 30, 600).astype(np.float32)
            for _ in range(n_heads)]
    acts[-1] = rng.uniform(-12, 12, 600).astype(np.float32)  # log λ / log r
    t = rng.poisson(4.0, 600).astype(np.float32)
    t[::3] = 0.0
    fam = ops.FAMILIES[name]
    ours = fam.grads(*(torch.from_numpy(a) for a in acts), torch.from_numpy(t))
    ref = JAX_GRADS[name](*(jnp.asarray(a) for a in acts), jnp.asarray(t))
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(ours, ref, strict=True):
        assert_close(o, r, 1e-6)
    packed = jfl._BASE_LL[name](tuple(jnp.asarray(a) for a in acts),
                                jnp.asarray(t))
    assert_close(fam.ll(*(torch.from_numpy(a) for a in acts),
                        torch.from_numpy(t)), packed, 1e-6)
    # zero outside the clip range of the last head (log λ or log r)
    outside = (acts[-1] <= -10) | (acts[-1] >= 10)
    assert np.all(ours[-1].numpy()[outside] == 0.0)


@pytest.mark.parametrize("name", FAMILIES)
def test_cpu_wrappers_are_the_plain_versions(name):
    h, heads, t, g = _case(name, m=8)
    names = ops.FAMILIES[name].heads
    h_, t_, g_ = (torch.from_numpy(x) for x in (h, t, g))
    ws = [torch.from_numpy(heads[n]["kernel"]) for n in names]
    bs = [torch.from_numpy(heads[n]["bias"]) for n in names]
    before = dict(ops.launch_counts())
    fwd = ops.fused_forward(name, h_, ws, bs, t_, compute_dtype=torch.bfloat16)
    assert torch.equal(fwd, ops.reference_forward(
        name, h_, ws, bs, t_, compute_dtype=torch.bfloat16))
    back = ops.fused_backward(name, g_, h_, ws, bs, t_)
    want = ops.reference_backward(name, g_, h_, ws, bs, t_)
    assert len(back) == len(want) == 1 + 2 * len(names)
    for a, b in zip(back, want):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.fused_log_likelihood("bernoulli", h_, {}, t_)
    with pytest.raises(ValueError):  # one head short
        ops.fused_forward(name, h_, ws[:-1], bs[:-1], t_)


@pytest.mark.parametrize("m,hidden,f,n_heads,want", [
    # headline NB: 32 row tiles of 64; dh: 16 x 1 blocks of 128 x 256 over
    # 64 depth stages -> clusters of 6 splits of 11 (17 clusters of 6 fit
    # the H100 at once, of 7 only 15); dW: 2 x 16 blocks over 32 stages ->
    # 3 splits of 11 (39 clusters of 3 fit, of 4 only 30)
    (2048, 256, 2048, 2,
     dict(hp=256, fp=2048, row_sums=(32, 2048),
          da=(2048, 4096), db_parts=(32, 4096), dh_splits=(6, 11, False),
          dw_splits=(3, 11, False))),
    # GMVAE-NB's 20,480 rows: 160 dh blocks fill the card without a split;
    # dW's 32 blocks in 3 splits would each sum 6,848 deep, so its sums are
    # promoted, on 2 x 32 blocks of 128 x 128 in 2 splits (66 clusters of 2
    # fit, of 3 only 39)
    (20480, 256, 2048, 2,
     dict(row_sums=(32, 20480), db_parts=(320, 4096),
          dh_splits=(1, 64, False), dw_splits=(2, 160, True))),
    # ragged ZINB: H and F padded to multiples of 8; 15 dh stages -> 3
    # splits of 5 (at least 4 stages each); dW's 37 rows are one stage
    (37, 21, 301, 3,
     dict(hp=24, fp=304, row_sums=(5, 37), da=(37, 912),
          db_parts=(1, 912), dh_splits=(3, 5, False),
          dw_splits=(1, 1, False))),
])
def test_tensor_core_plan(m, hidden, f, n_heads, want):
    """Padded widths, grids, scratch shapes and depth splits of the bf16
    tensor-core K2/K3, which the kernels take from the wrapper, on the
    H100's cluster capacity."""
    from scvae_tpu_torch.ops import fused_likelihood as tfl

    plan = tfl.tc_plan(m, hidden, f, n_heads)
    assert {k: plan[k] for k in want} == want


def test_tensor_core_splits_and_operands():
    """Every split of a product has depth to cover and the splits cover
    all of it; the operands are bf16 copies, zero-padded to 16-byte rows."""
    from scvae_tpu_torch.ops import fused_likelihood as tfl

    for blocks in range(1, 700, 37):
        for depth in (0, 8, 300, 2048, 6144, 20480):
            splits, per = tfl.tc_splits(blocks, depth)
            k_tiles = max(1, -(-depth // tfl.TC_PRODUCT_DEPTH))
            assert (splits - 1) * per < k_tiles <= splits * per
            assert splits <= tfl.TC_MAX_SPLITS
            assert splits == 1 or per >= tfl.TC_MIN_SPLIT_DEPTH
            # the clusters of a split plan fit the card at once
            assert splits == 1 or blocks <= tfl.TC_CLUSTER_CAPACITY[splits]
            # promoted exactly where a full-width split would sum deeper
            # than TC_PROMOTE_DEPTH
            rows, cols = 128 * blocks, 256
            s_, p_, promote = tfl._product_plan(rows, cols, depth,
                                                tfl.TC_CLUSTER_CAPACITY)
            unpromoted = p_ if not promote else tfl.tc_splits(blocks, depth)[1]
            assert promote == (unpromoted * tfl.TC_PRODUCT_DEPTH
                               > tfl.TC_PROMOTE_DEPTH)
            assert promote or (s_, p_) == (splits, per)
    # a card that holds fewer clusters: fewer splits
    small = {s: 132 // (2 * s) for s in range(1, tfl.TC_MAX_SPLITS + 1)}
    assert tfl.tc_plan(2048, 256, 2048, 2, small)["dh_splits"] == (
        4, 16, False)
    rng = np.random.RandomState(0)
    h = torch.from_numpy(rng.randn(5, 21).astype(np.float32))
    ws = [torch.from_numpy(rng.randn(21, 13).astype(np.float32))
          for _ in range(2)]
    bs = [torch.from_numpy(rng.randn(13).astype(np.float32))
          for _ in range(2)]
    hb, w, b = tfl._tc_operands(h, ws, bs)
    assert hb.dtype == w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert hb.shape == (5, 24) and w.shape == (24, 2, 16) and b.shape == (2, 13)
    assert torch.equal(hb[:, :21], h.to(torch.bfloat16))
    assert not hb[:, 21:].any() and not w[21:].any() and not w[:, :, 13:].any()
    for k in range(2):
        assert torch.equal(w[:21, k, :13], ws[k].to(torch.bfloat16))
        assert torch.equal(b[k], bs[k])


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("m,m_t", [(40, 40), (150, 30)])
def test_tensor_core_plain_pieces_compose_to_the_backward(name, m, m_t):
    """The plain versions of the three bf16 backward kernels, in the
    kernels' padded layout (H = 20 and F = 597 padded to 24 and 600, rows
    off the 64-row tile, targets cycling), give the plain bf16 backward:
    bf16(da) zero past F, row-tile sums that add up to db, and the dh and
    dW products of the same bf16 operands."""
    from scvae_tpu_torch.ops import fused_likelihood as tfl

    h, heads, t, g = _case(name, m=m, m_t=m_t, seed=3)
    names = ops.FAMILIES[name].heads
    h_, t_, g_ = (torch.from_numpy(x) for x in (h, t[:, :597], g))
    ws = [torch.from_numpy(heads[n]["kernel"][:, :597]) for n in names]
    bs = [torch.from_numpy(heads[n]["bias"][:597]) for n in names]
    grad = tfl.reference_tc_gradient(name, g_, h_, ws, bs, t_)
    assert grad.da.dtype == torch.bfloat16
    assert grad.da.shape == (m, len(names) * 600)
    assert not grad.da.reshape(m, len(names), 600)[:, :, 597:].any()
    assert grad.h.shape == (m, 24) and grad.db_parts.shape == (
        -(-m // tfl.TC_ROW_TILE), len(names) * 600)
    got = (tfl.reference_tc_dh(grad), *tfl.reference_tc_dw(grad))
    want = ops.reference_backward(name, g_, h_, ws, bs, t_,
                                  compute_dtype=torch.bfloat16)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a, b.numpy(), 1e-5)
