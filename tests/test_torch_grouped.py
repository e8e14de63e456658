"""The grouped likelihood (kernels K4/K5) against the JAX package's
``fused_grouped_log_likelihood``, its Pallas kernels in interpret mode.

The same inputs, made with numpy, go through both: h (G, M, H) against
targets t (M, F) shared by the groups, and per-row weights of the groups as
uneven as the GMVAE's q(y|x) (``tests/test_ops.py:541-575``).  On the CPU the
port runs the kernels' plain versions.

Tolerances: forward rtol 1e-5 (atol 1e-4 on row sums of order 1e2, float32
sums taken in another order); gradients rtol 1e-4 (atol 1e-5) in float32,
and 5e-3 (atol 5e-4) with bf16 matmul inputs, where a da rounded to the
neighbouring bf16 value on one side moves a gradient entry by its last
digits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu import ops as jops
from scvae_tpu_torch import ops

G, M, HIDDEN, F = 3, 16, 16, 24


def _inputs(name, seed=0, g=G, m=M, hidden=HIDDEN, f=F):
    rng = np.random.RandomState(seed)
    h = (rng.randn(g, m, hidden) * 0.5).astype(np.float32)
    t = rng.poisson(2.0, (m, f)).astype(np.float32)
    limit = np.sqrt(6.0 / (hidden + f))
    heads = {p: {"kernel": rng.uniform(-limit, limit, (hidden, f))
                 .astype(np.float32),
                 "bias": (0.1 * rng.randn(f)).astype(np.float32)}
             for p in ops.FAMILIES[name].heads}
    weights = rng.rand(g, m).astype(np.float32)
    return h, heads, t, weights


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=grad), tree)


@pytest.mark.parametrize("name", list(ops.FAMILIES))
def test_forward_matches_jax(name):
    h, heads, t, _ = _inputs(name)
    with pltpu.force_tpu_interpret_mode():
        want = jops.fused_grouped_log_likelihood(
            name, jnp.asarray(h), _jax_tree(heads), jnp.asarray(t))
    got = ops.fused_grouped_log_likelihood(
        name, torch.from_numpy(h), _torch_tree(heads), torch.from_numpy(t))
    assert tuple(got.shape) == (G, M) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name", list(ops.FAMILIES))
@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_gradients_match_jax(name, compute):
    h, heads, t, weights = _inputs(name, seed=1)
    jdtype = None if compute is None else jnp.bfloat16
    tdtype = None if compute is None else torch.bfloat16

    def loss(h_, heads_):
        return jnp.sum(jnp.asarray(weights) * jops.fused_grouped_log_likelihood(
            name, h_, heads_, jnp.asarray(t), compute_dtype=jdtype))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), _jax_tree(heads))
    th = torch.tensor(h, requires_grad=True)
    theads = _torch_tree(heads, grad=True)
    out = ops.fused_grouped_log_likelihood(name, th, theads,
                                           torch.from_numpy(t),
                                           compute_dtype=tdtype)
    (torch.from_numpy(weights) * out).sum().backward()
    rtol, atol = (1e-4, 1e-5) if compute is None else (5e-3, 5e-4)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want[0]),
                               rtol=rtol, atol=atol)
    for p in heads:
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(theads[p][k].grad.numpy(),
                                       np.asarray(want[1][p][k]), rtol=rtol,
                                       atol=atol, err_msg=f"{p} {k}")


def test_grouped_matches_flat():
    """The GMVAE's leading axes (K, S) fold into the group axis, and the
    grouped path equals the flat one with cycled target rows, in both
    packages (``tests/test_ops.py:589-613``)."""
    name = "negative binomial"
    rng = np.random.RandomState(4)
    h = (rng.randn(4, 1, 8, 16) * 0.3).astype(np.float32)
    t = rng.poisson(1.5, (8, 24)).astype(np.float32)
    _, heads, _, _ = _inputs(name, seed=5, hidden=16, f=24)
    grouped = ops.fused_grouped_log_likelihood(
        name, torch.from_numpy(h), _torch_tree(heads), torch.from_numpy(t))
    flat = ops.fused_log_likelihood(
        name, torch.from_numpy(h), _torch_tree(heads), torch.from_numpy(t))
    assert tuple(grouped.shape) == (4, 1, 8)
    np.testing.assert_allclose(grouped.numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        jflat = jops.fused_log_likelihood(name, jnp.asarray(h),
                                          _jax_tree(heads), jnp.asarray(t))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(jflat), rtol=1e-5,
                               atol=1e-4)


def test_supports_matches_jax():
    names = list(ops.FAMILIES) + ["constrained poisson", "bernoulli"]
    for name in names:
        for g in (0, 1, 2, 10, 16, 17, 64):
            for k_max in (0, 4):
                assert ops.supports_grouped_likelihood(name, g, k_max) == (
                    jops.supports_grouped_likelihood(name, g, k_max)), (
                    name, g, k_max)


def test_plain_versions_and_errors():
    """The wrappers take the plain versions on CPU tensors; dW/db sum the
    groups' flat gradients; names outside the base families raise."""
    name = "zero-inflated negative binomial"
    h, heads, t, weights = _inputs(name, seed=2)
    th, tt, tg = (torch.from_numpy(a) for a in (h, t, weights))
    ws = [torch.from_numpy(heads[p]["kernel"]) for p in heads]
    bs = [torch.from_numpy(heads[p]["bias"]) for p in heads]
    ops.reset_launch_counts()
    dh, *dws = ops.grouped_backward(name, tg, th, ws, bs, tt)
    flat = ops.reference_dw(name, tg.reshape(-1), th.reshape(-1, HIDDEN), ws,
                            bs, tt)
    for a, b in zip(dws, flat, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert tuple(dh.shape) == (G, M, HIDDEN)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError):
        ops.fused_grouped_log_likelihood("constrained poisson", th,
                                         {"lambda": heads["pi"]}, tt)
