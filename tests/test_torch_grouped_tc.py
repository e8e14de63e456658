"""The grouped bf16 backward's tensor-core design (the grouped gradient
kernel, then the dh and dW products of its scratch) in its plain versions,
against the VJP of the JAX package's ``fused_grouped_log_likelihood`` with
bf16 matmul inputs, its Pallas kernels in interpret mode.

The same inputs, made with numpy, go through both: h (G, M, H) against
targets t (M, F) shared by the groups (F ragged, not a multiple of 8) and
row cotangents as uneven as the GMVAE's q(y|x).  Interpret mode unrolls
the group loop, so JAX sees G = 1 and 3; G = 17 (past the JAX cap) is held
against the port's own per-group plain versions.  The scratch layout is
checked on its own: bf16(da) over the group-major rows, zero past F, and
the column sums per 64 target rows over every group.  On the CPU the
wrappers are these plain versions and launch nothing.

Tolerance: rtol 5e-3, atol 5e-4, as ``tests/test_torch_grouped.py`` holds
the bf16 gradients (a da rounded to the neighbouring bf16 value moves a
gradient entry by its last digits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu import ops as jops
from scvae_tpu_torch import ops
from scvae_tpu_torch.ops import fused_likelihood as fl

M, HIDDEN, F = 20, 16, 21
RTOL, ATOL = 5e-3, 5e-4


def _inputs(name, g, seed=0, m=M, hidden=HIDDEN, f=F):
    rng = np.random.RandomState(seed)
    h = (rng.randn(g, m, hidden) * 0.5).astype(np.float32)
    t = rng.poisson(2.0, (m, f)).astype(np.float32)
    limit = np.sqrt(6.0 / (hidden + f))
    heads = {p: {"kernel": rng.uniform(-limit, limit, (hidden, f))
                 .astype(np.float32),
                 "bias": (0.1 * rng.randn(f)).astype(np.float32)}
             for p in ops.FAMILIES[name].heads}
    logits = 2.0 * rng.randn(g, m)
    weights = (np.exp(logits) / np.exp(logits).sum(0) / m).astype(np.float32)
    return h, heads, t, weights


def _torch(name, h, heads, t, weights):
    order = ops.FAMILIES[name].heads
    return (torch.from_numpy(weights), torch.from_numpy(h),
            [torch.from_numpy(heads[p]["kernel"]) for p in order],
            [torch.from_numpy(heads[p]["bias"]) for p in order],
            torch.from_numpy(t))


def _tc_backward(name, g, h, ws, bs, t):
    """dh, dW (NH, H, F), db (NH, F) through the plain gradient kernel and
    the plain products of its scratch."""
    grad = fl.reference_grouped_tc_gradient(name, g, h, ws, bs, t)
    dw, db = fl.reference_tc_dw_stacked(grad)
    return fl.reference_tc_dh(grad).reshape(h.shape), dw, db


@pytest.mark.parametrize("name", list(ops.FAMILIES))
@pytest.mark.parametrize("n_groups", [1, 3])
def test_plain_design_matches_jax_vjp(name, n_groups):
    h, heads, t, weights = _inputs(name, n_groups, seed=n_groups)
    jheads = jax.tree_util.tree_map(jnp.asarray, heads)

    def fn(h_, heads_):
        return jops.fused_grouped_log_likelihood(
            name, h_, heads_, jnp.asarray(t), compute_dtype=jnp.bfloat16)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, jnp.asarray(h), jheads)
        want_dh, want_heads = vjp(jnp.asarray(weights))
    dh, dw, db = _tc_backward(name, *_torch(name, h, heads, t, weights))
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), rtol=RTOL,
                               atol=ATOL)
    for k, p in enumerate(ops.FAMILIES[name].heads):
        np.testing.assert_allclose(dw[k].numpy(),
                                   np.asarray(want_heads[p]["kernel"]),
                                   rtol=RTOL, atol=ATOL, err_msg=p)
        np.testing.assert_allclose(db[k].numpy(),
                                   np.asarray(want_heads[p]["bias"]),
                                   rtol=RTOL, atol=ATOL, err_msg=p)


@pytest.mark.parametrize("name", list(ops.FAMILIES))
def test_plain_design_past_the_group_cap(name):
    """G = 17 against the per-group plain versions with the same rounding."""
    h, heads, t, weights = _inputs(name, 17, seed=7, m=9, f=29)
    g, th, ws, bs, tt = _torch(name, h, heads, t, weights)
    dh, dw, db = _tc_backward(name, g, th, ws, bs, tt)
    kw = dict(compute_dtype=torch.bfloat16)
    torch.testing.assert_close(
        dh, ops.reference_grouped_dh(name, g, th, ws, bs, tt, **kw),
        rtol=RTOL, atol=ATOL)
    want = ops.reference_grouped_dw(name, g, th, ws, bs, tt, **kw)
    for k in range(len(ws)):
        torch.testing.assert_close(dw[k], want[2 * k], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(db[k], want[2 * k + 1], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("m", [64, 130])
def test_scratch_layout(m):
    """bf16(da) (G·M, NH·Fp): group-major rows, each group's block the flat
    gradient of that group, zero past F; db_parts (ceil(M / 64), NH·Fp):
    the column sums of every group's da over each 64 target rows."""
    name = "negative binomial"
    n_groups, f = 3, 21
    h, heads, t, weights = _inputs(name, n_groups, seed=3, m=m, f=f)
    g, th, ws, bs, tt = _torch(name, h, heads, t, weights)
    grad = fl.reference_grouped_tc_gradient(name, g, th, ws, bs, tt)
    fp = fl.tc_padded(f)
    assert grad.prefix == "nb_grouped"
    assert grad.da.dtype == torch.bfloat16
    assert tuple(grad.da.shape) == (n_groups * m, 2 * fp)
    assert tuple(grad.db_parts.shape) == (-(-m // 64), 2 * fp)
    assert tuple(grad.h.shape) == (n_groups * m, fl.tc_padded(HIDDEN))
    da = grad.da.float().reshape(n_groups, m, 2, fp)
    assert not da[..., f:].any()
    _, das = fl._weighted_grads(name, g.reshape(-1), th.reshape(-1, HIDDEN),
                                ws, bs, tt, torch.bfloat16)
    for k, da_k in enumerate(das):
        per_group = da_k.reshape(n_groups, m, f)
        assert torch.equal(da[..., k, :f], per_group.to(torch.bfloat16).float())
        for tile in range(grad.db_parts.shape[0]):
            rows = per_group[:, 64 * tile:64 * (tile + 1)]
            torch.testing.assert_close(
                grad.db_parts[tile, k * fp:k * fp + f], rows.sum((0, 1)),
                rtol=1e-6, atol=1e-7)
    plan = fl.grouped_tc_plan(n_groups, m, HIDDEN, f, 2)
    assert plan["db_parts"] == tuple(grad.db_parts.shape)
    assert plan["da"] == tuple(grad.da.shape)
    assert plan["grid"] == (-(-m // fl.GROUPED_TC_ROWS), 1)


@pytest.mark.parametrize("n_heads,hidden,chunk", [
    (1, 256, 256), (2, 256, 256), (3, 256, 256), (2, 1024, 384),
    (3, 1024, 256), (1, 21, 64)])
def test_plan_keeps_w_resident_where_it_fits(n_heads, hidden, chunk):
    """The gradient kernel keeps every head's W resident in 64-row slices:
    all of Hp at the headline width of 256 for every family, in chunks as
    large as the shared memory of a block allows past it."""
    plan = fl.grouped_tc_plan(10, 2048, hidden, 2048, n_heads)
    assert plan["w_chunk"] == chunk and chunk % 64 == 0
    assert plan["smem_bytes"] <= fl.GROUPED_TC_SMEM
    assert plan["dh_splits"] == fl.tc_plan(20480, hidden, 2048,
                                           n_heads)["dh_splits"]


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors the grouped backward is the plain design (bf16) or the
    per-group plain versions (float32), the grouped forward the per-group
    plain versions in either dtype, and nothing launches."""
    name = "zero-inflated negative binomial"
    h, heads, t, weights = _inputs(name, 3, seed=5)
    g, th, ws, bs, tt = _torch(name, h, heads, t, weights)
    ops.reset_launch_counts()
    got = ops.grouped_backward(name, g, th, ws, bs, tt,
                               compute_dtype=torch.bfloat16)
    dh, dw, db = _tc_backward(name, g, th, ws, bs, tt)
    assert torch.equal(got[0], dh)
    for k in range(len(ws)):
        assert torch.equal(got[1 + 2 * k], dw[k])
        assert torch.equal(got[2 + 2 * k], db[k])
    got32 = ops.grouped_backward(name, g, th, ws, bs, tt)
    want32 = (ops.reference_grouped_dh(name, g, th, ws, bs, tt),
              *ops.reference_grouped_dw(name, g, th, ws, bs, tt))
    for a, b in zip(got32, want32, strict=True):
        assert torch.equal(a, b)
    for compute in (torch.bfloat16, None):
        assert torch.equal(
            ops.grouped_forward(name, th, ws, bs, tt, compute_dtype=compute),
            ops.reference_grouped_forward(name, th, ws, bs, tt,
                                          compute_dtype=compute))
    assert not any(ops.launch_counts().values())
