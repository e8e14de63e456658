"""The fused NB likelihood (kernels K2 / K3; the CPU runs their plain
versions through ``FusedNBLogLikelihood``) against the JAX package's
``fused_log_likelihood`` and its VJP, the Pallas kernels in interpret mode.

Tolerances: float32 compute rtol 1e-5 (sums in another order); bf16 compute
rtol 2e-3 (h, W and da rounded to bf16 on both sides, a few products land on
a neighbouring bf16 value).  Absolute floors are the same fraction of the
largest |reference| value, for gradient entries near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops

HIDDEN, F = 20, 600  # F not a multiple of the TPU kernel's 512-gene tile


def _case(m=40, m_t=None, seed=0):
    rng = np.random.RandomState(seed)
    m_t = m if m_t is None else m_t
    h = np.maximum(rng.randn(m, HIDDEN), 0.0).astype(np.float32)
    limit = np.sqrt(6.0 / (HIDDEN + F))
    heads = {
        name: {
            "kernel": rng.uniform(-limit, limit, (HIDDEN, F)).astype(np.float32) * 3,
            "bias": (0.3 * rng.randn(F)).astype(np.float32),
        }
        for name in ("p", "log_r")
    }
    t = rng.poisson(2.0, (m_t, F)).astype(np.float32)
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


@pytest.mark.parametrize("compute", [None, "bf16"])
@pytest.mark.parametrize("include_const", [True, False])
def test_forward_and_vjp_match_jax_interpret(compute, include_const):
    h, heads, t, g = _case()
    jax_dtype = None if compute is None else jnp.bfloat16
    torch_dtype = None if compute is None else torch.bfloat16

    def jax_loss(h_, heads_):
        return jfl.fused_log_likelihood(
            "negative binomial", h_, heads_, jnp.asarray(t),
            compute_dtype=jax_dtype, include_lgamma_const=include_const,
        )

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_loss, jnp.asarray(h), _jax_heads(heads))
        ref_dh, ref_dheads = vjp(jnp.asarray(g))

    h_t = torch.from_numpy(h).requires_grad_(True)
    heads_t = _torch_heads(heads, requires_grad=True)
    out = ops.fused_log_likelihood(
        "negative binomial", h_t, heads_t, torch.from_numpy(t),
        compute_dtype=torch_dtype, include_lgamma_const=include_const,
    )
    rtol = _tols(compute)
    assert_close(out, ref, rtol)
    leaves = [h_t] + [heads_t[n][k] for n in ("p", "log_r") for k in ("kernel", "bias")]
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    refs = [ref_dh] + [ref_dheads[n][k] for n in ("p", "log_r")
                       for k in ("kernel", "bias")]
    for ours, want in zip(grads, refs):
        assert_close(ours, want, rtol)


def test_shared_targets_cycle_rows():
    """h with a leading sample axis (S, B, H) against t (B, F): rows cycle
    over the shared targets, as in the JAX package."""
    h, heads, t, _ = _case(m=2 * 16, m_t=16, seed=3)
    h3 = h.reshape(2, 16, HIDDEN)
    ref = jfl.reference_log_likelihood(
        "negative binomial", jnp.asarray(h3), _jax_heads(heads),
        jnp.asarray(t)[None],
    )
    with pltpu.force_tpu_interpret_mode():
        fused = jfl.fused_log_likelihood(
            "negative binomial", jnp.asarray(h3), _jax_heads(heads),
            jnp.asarray(t),
        )
    out = ops.fused_log_likelihood(
        "negative binomial", torch.from_numpy(h3), _torch_heads(heads),
        torch.from_numpy(t),
    )
    assert out.shape == (2, 16)
    assert_close(out, ref, 1e-5)
    assert_close(out, fused, 1e-5)


def test_elementwise_grads_match_jax():
    rng = np.random.RandomState(5)
    a_p = rng.uniform(-30, 30, 500).astype(np.float32)
    a_r = rng.uniform(-12, 12, 500).astype(np.float32)
    t = rng.poisson(4.0, 500).astype(np.float32)
    ours = ops.reference_nb_grads(*(torch.from_numpy(a) for a in (a_p, a_r, t)))
    ref = jfl._nb_grads(jnp.asarray(a_p), jnp.asarray(a_r), jnp.asarray(t))
    for o, r in zip(ours, ref):
        assert_close(o, r, 1e-6)
    # zero outside the clip ranges
    outside = (a_r <= -10) | (a_r >= 10)
    assert np.all(ours[1].numpy()[outside] == 0.0)


def test_cpu_wrappers_are_the_plain_versions():
    h, heads, t, g = _case(m=8)
    args = [torch.from_numpy(x) for x in (
        h, heads["p"]["kernel"], heads["p"]["bias"],
        heads["log_r"]["kernel"], heads["log_r"]["bias"], t)]
    before = dict(ops.launch_counts())
    fwd = ops.nb_forward(*args, compute_dtype=torch.bfloat16)
    assert torch.equal(fwd, ops.reference_nb_log_likelihood(
        *args, compute_dtype=torch.bfloat16))
    back = ops.nb_backward(torch.from_numpy(g), *args)
    for a, b in zip(back, ops.reference_nb_backward(torch.from_numpy(g), *args)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before
    with pytest.raises(NotImplementedError):
        ops.fused_log_likelihood("poisson", args[0], {}, args[-1])
