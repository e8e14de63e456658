"""The fused constrained Poisson (kernels K6 / K7; the CPU runs their plain
versions through ``FusedConstrainedPoisson``) against the JAX package's
``_cp_fused_forward`` and ``_fused_constrained_poisson`` with its VJP, the
Pallas kernels in interpret mode, and against the unfused registry
composition ``Poisson(log(softmax(a)·n))``.

Tolerances: rtol 1e-5 against the fused JAX path (the same float32
formulas, summed in another order; nothing rounds but h, and it rounds to
bf16 on both sides), with an absolute floor of the same fraction of the
largest |reference| value.  rtol 2e-4 against the unfused composition, as
``tests/test_ops.py`` holds the JAX kernels to it (it clips the softmax to
float32-tiny where the fused form does not)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import ops
from scvae_tpu_torch.distributions import DISTRIBUTIONS

HIDDEN = 20
NAME = "constrained poisson"


def _case(m=24, f=600, seed=0):
    """F = 600 is not a multiple of the TPU kernel's 512-gene tile, so the
    JAX side pads and the port masks a ragged tail."""
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(m, HIDDEN), 0.0).astype(np.float32)
    w = (rng.randn(HIDDEN, f) * 0.3).astype(np.float32)
    b = (0.3 * rng.randn(f)).astype(np.float32)
    t = rng.poisson(2.0, (m, f)).astype(np.float32)
    n = (t.sum(-1, keepdims=True) + rng.uniform(0.5, 5.0, (m, 1))).astype(
        np.float32)
    g = rng.randn(m).astype(np.float32)
    return h, w, b, t, n, g


def assert_close(ours, ref, rtol=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        ours.detach().numpy(), ref, rtol=rtol,
        atol=rtol * float(np.abs(ref).max()),
    )


def _jax_h(h, round_h):
    return jnp.asarray(h).astype(jnp.bfloat16) if round_h else jnp.asarray(h)


@pytest.mark.parametrize("round_h", [False, True])
@pytest.mark.parametrize("f", [600, 512])
def test_forward_and_lse_match_jax_interpret(round_h, f):
    h, w, b, t, n, _ = _case(f=f)
    with pltpu.force_tpu_interpret_mode():
        ref_ll, ref_lse = jfl._cp_fused_forward(
            _jax_h(h, round_h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(t),
            jnp.asarray(n))
    hv = torch.from_numpy(h)
    if round_h:
        hv = hv.to(torch.bfloat16).float()
    ll, lse = ops.cp_forward(hv, torch.from_numpy(w), torch.from_numpy(b),
                             torch.from_numpy(t), torch.from_numpy(n)[:, 0])
    assert_close(ll, ref_ll)
    assert_close(lse, ref_lse)


@pytest.mark.parametrize("round_h", [False, True])
def test_vjp_matches_jax_interpret(round_h):
    """dh, dW, db and the count-sum cotangent dn = g·(Σt/n − 1).  With bf16
    h (the JAX caller casts the decoder output) JAX returns a float32 dh,
    which the port returns unrounded too."""
    h, w, b, t, n, g = _case(seed=1)

    def jax_loss(h_, w_, b_, n_):
        return jfl._fused_constrained_poisson(h_, w_, b_, jnp.asarray(t), n_)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_loss, _jax_h(h, round_h), jnp.asarray(w),
                           jnp.asarray(b), jnp.asarray(n))
        ref_grads = vjp(jnp.asarray(g))
    assert ref_grads[0].dtype == jnp.float32

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (h, w, b, n)]
    out = ops.fused_log_likelihood(
        NAME, leaves[0], {"lambda": {"kernel": leaves[1], "bias": leaves[2]}},
        torch.from_numpy(t), count_sum=leaves[3],
        compute_dtype=torch.bfloat16 if round_h else None,
    )
    assert_close(out, ref)
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    assert grads[0].dtype == torch.float32
    for ours, want in zip(grads, ref_grads, strict=True):
        assert_close(ours, want)


def test_count_sum_cotangent_matches_reference():
    """As ``tests/test_ops.py``: the fused dn against autograd through the
    unfused reference, in both frameworks."""
    h, w, b, t, n, _ = _case(seed=2)
    heads_j = {"lambda": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    ref = jax.grad(lambda n_: jnp.sum(jfl.reference_log_likelihood(
        NAME, jnp.asarray(h), heads_j, jnp.asarray(t), n_)))(jnp.asarray(n))
    heads_t = {"lambda": {"kernel": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)}}
    n_t = torch.from_numpy(n).requires_grad_(True)
    fused = ops.fused_log_likelihood(NAME, torch.from_numpy(h), heads_t,
                                     torch.from_numpy(t), count_sum=n_t)
    (dn,) = torch.autograd.grad(fused.sum(), [n_t])
    assert dn.shape == n_t.shape
    assert_close(dn, ref)
    n_u = torch.from_numpy(n).requires_grad_(True)
    unfused = ops.reference_log_likelihood(NAME, torch.from_numpy(h), heads_t,
                                           torch.from_numpy(t), count_sum=n_u)
    (dn_u,) = torch.autograd.grad(unfused.sum(), [n_u])
    assert_close(dn_u, ref)


def test_shared_targets_and_registry_composition():
    """h (2, B, H) against t (B, F) and count sums (B, 1): the port cycles
    target rows where JAX broadcasts them; both equal the unfused form and,
    to 2e-4, the registry's softmax → clip → Poisson(log(λ·n))."""
    h, w, b, t, n, _ = _case(m=32, seed=3)
    h3 = h.reshape(2, 16, HIDDEN)
    t2, n2 = t[:16], n[:16]
    heads_j = {"lambda": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    with pltpu.force_tpu_interpret_mode():
        fused_j = jfl.fused_log_likelihood(NAME, jnp.asarray(h3), heads_j,
                                           jnp.asarray(t2), jnp.asarray(n2))
    heads_t = {"lambda": {"kernel": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)}}
    out = ops.fused_log_likelihood(NAME, torch.from_numpy(h3), heads_t,
                                   torch.from_numpy(t2),
                                   count_sum=torch.from_numpy(n2))
    assert out.shape == (2, 16)
    assert_close(out, fused_j)
    ref = jfl.reference_log_likelihood(NAME, jnp.asarray(h3), heads_j,
                                       jnp.asarray(t2), jnp.asarray(n2))
    assert_close(ops.reference_log_likelihood(
        NAME, torch.from_numpy(h3), heads_t, torch.from_numpy(t2),
        count_sum=torch.from_numpy(n2)), ref)
    spec = DISTRIBUTIONS[NAME]
    a = torch.from_numpy(h3) @ heads_t["lambda"]["kernel"] + heads_t["lambda"]["bias"]
    dist = spec.build({"lambda": spec.parameters["lambda"].constrain(a)},
                      count_sum=torch.from_numpy(n2))
    composed = dist.log_prob(torch.from_numpy(t2)).sum(-1)
    assert_close(composed, ref, rtol=2e-4)


def test_cpu_wrappers_are_the_plain_versions():
    h, w, b, t, n, g = (torch.from_numpy(x) for x in _case(m=8, seed=4))
    n = n[:, 0]
    before = dict(ops.launch_counts())
    ll, lse = ops.cp_forward(h, w, b, t, n)
    ll_ref, lse_ref = ops.reference_cp_forward(h, w, b, t, n)
    assert torch.equal(ll, ll_ref) and torch.equal(lse, lse_ref)
    for a, b_ in zip(ops.cp_backward(g, h, w, b, t, lse),
                     (ops.reference_cp_dh(g, h, w, b, t, lse),
                      *ops.reference_cp_dw(g, h, w, b, t, lse)), strict=True):
        assert torch.equal(a, b_)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="count_sum"):
        ops.fused_log_likelihood(NAME, h, {"lambda": {"kernel": w, "bias": b}}, t)
