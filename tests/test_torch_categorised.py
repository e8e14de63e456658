"""The categorised (piecewise-categorical) likelihood of the port against the
JAX package: the elementwise pieces, the distributions, the class-logit
heads, the fused likelihood's plain versions (the CPU path of the categorised
K2/K3 kernels) against ``fused_categorised_log_likelihood`` in interpret mode,
and the VAE with ``number_of_reconstruction_classes`` > 0.

Tolerances: float32 compute rtol 1e-5 (sums in another order), bf16 compute
rtol 2e-3 (h, W and da rounded to bf16 on both sides), as
``tests/test_torch_fused_likelihood.py``, with absolute floors the same
fraction of the largest |reference| value; elementwise pieces and
distributions rtol 1e-6 (the same float32 formulas); the VAE objective as
``tests/test_torch_vae.py``."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu import distributions as jd
from scvae_tpu.models import networks as jnetworks
from scvae_tpu.models import vae as jvae
from scvae_tpu.ops import force_pallas
from scvae_tpu.ops import fused_likelihood as jfl
from scvae_tpu_torch import distributions as td
from scvae_tpu_torch import ops
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import api, networks
from scvae_tpu_torch.models import vae as tvae
from scvae_tpu_torch.ops import fused_likelihood as tfl
from scvae_tpu_torch.ops import special

BASES = list(ops.FAMILIES)
M, HIDDEN, F = 48, 16, 24  # the JAX package's own test sizes


def assert_close(ours, ref, rtol):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * max(1e-30, float(np.abs(ref).max())))


def _case(name, k_max, m=M, m_t=None, hidden=HIDDEN, f=F, seed=0):
    """h, base heads, class heads (K+1, H, F) / (K+1, F), Poisson(2)
    targets (13% zeros, and counts past K) and row cotangents."""
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
    t = rng.poisson(2.0, (m if m_t is None else m_t, f)).astype(np.float32)
    g = rng.randn(m).astype(np.float32)
    return h, heads, cat_w, cat_b, t, g


def _torch_heads(heads, requires_grad=False):
    return {p: {k: torch.from_numpy(v).requires_grad_(requires_grad)
                for k, v in head.items()} for p, head in heads.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# --------------------------------------------------------------------------
# Elementwise pieces, distributions, heads
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", BASES)
@pytest.mark.parametrize("k_max", [1, 4])
def test_elementwise_pieces_match_jax(name, k_max):
    """ll, the select and lse, and every gradient per element, with the
    boundary counts 0, K−1, K, K+1 among the targets."""
    rng = np.random.RandomState(1)
    n_heads = len(ops.FAMILIES[name].heads) + k_max + 1
    acts = [rng.uniform(-12, 12, 400).astype(np.float32)
            for _ in range(n_heads)]
    t = rng.poisson(float(k_max), 400).astype(np.float32)
    t[:4] = [0.0, k_max - 1.0, float(k_max), k_max + 1.0]
    ours_a = [torch.from_numpy(a) for a in acts]
    ref_a = tuple(jnp.asarray(a) for a in acts)
    n_base = len(ops.FAMILIES[name].heads)
    sel, lse = tfl.cat_select_and_lse(ours_a[n_base:], torch.from_numpy(t))
    ref_sel, ref_lse = jfl._cat_select_and_lse(ref_a[n_base:], jnp.asarray(t))
    assert_close(sel, ref_sel, 1e-6)
    assert_close(lse, ref_lse, 1e-6)
    ll = tfl.categorised_ll(name, k_max)(ours_a, torch.from_numpy(t))
    ref_ll = jfl._categorised_ll(name, n_base, k_max)(ref_a, jnp.asarray(t))
    assert_close(ll, ref_ll, 1e-6)
    ref_grads = jfl._categorised_grads(name, n_base, k_max)(ref_a,
                                                            jnp.asarray(t))
    # the class softmax from the lse, exp(a − lse), against JAX's
    # exp(a − max)/Σ: float32 rounding apart
    grads = tfl.categorised_grads(name, k_max)(ours_a, torch.from_numpy(t),
                                               lse)
    assert len(grads) == len(ref_grads) == n_heads
    for ours, ref in zip(grads, ref_grads):
        assert_close(ours, ref, 1e-5)


def _jax_categorised(name, h, heads, cat, t):
    spec = jd.DISTRIBUTIONS[name]
    theta = {p: spec.parameters[p].constrain(
        h @ heads[p]["kernel"] + heads[p]["bias"]) for p in heads}
    logits = jnetworks.apply_categorised_logits(cat, h)
    return jd.Categorised(dist=spec.build(theta),
                          cat=jd.Categorical(logits=logits))


@pytest.mark.parametrize("name", BASES)
def test_categorised_distribution_matches_jax(name):
    """The distribution library's composition (the evaluation path) and the
    port's unfused reference both equal JAX's; boundary counts included."""
    k_max = 4
    h, heads, cat_w, cat_b, t, _ = _case(name, k_max, m=12)
    t[:, :4] = [0.0, k_max - 1.0, float(k_max), k_max + 1.0]
    cat = {"kernel": cat_w, "bias": cat_b}
    ref = _jax_categorised(name, jnp.asarray(h), _jax(heads), _jax(cat), t)
    spec = td.DISTRIBUTIONS[name]
    th = _torch_heads(heads)
    hh = torch.from_numpy(h)
    theta = {p: spec.parameters[p].constrain(
        hh @ th[p]["kernel"] + th[p]["bias"]) for p in th}
    logits = networks.apply_categorised_logits(_torch_heads({"c": cat})["c"],
                                               hh)
    ours = td.Categorised(dist=spec.build(theta),
                          cat=td.Categorical(logits=logits))
    tt = torch.from_numpy(t)
    assert_close(ours.log_prob(tt), ref.log_prob(jnp.asarray(t)), 1e-6)
    assert_close(ours.mean(), ref.mean(), 1e-6)
    assert_close(ours.variance(), ref.variance(), 1e-5)
    assert_close(ours.cat.mean(), ref.cat.mean(), 1e-6)
    assert_close(ours.cat.variance(), ref.cat.variance(), 1e-6)
    unfused = ops.reference_categorised_log_likelihood(
        name, hh, th, torch.from_numpy(cat_w), torch.from_numpy(cat_b), tt)
    assert_close(unfused, jfl.reference_categorised_log_likelihood(
        name, jnp.asarray(h), _jax(heads), jnp.asarray(cat_w),
        jnp.asarray(cat_b), jnp.asarray(t)), 1e-5)
    assert_close(unfused, jnp.sum(ref.log_prob(jnp.asarray(t)), -1), 1e-5)


def test_categorised_heads_match_jax():
    """One wide Glorot draw stored class-major (K+1, H, F), and the logits
    (..., F, K+1) in float32 and with bf16 inputs."""
    gen = torch.Generator().manual_seed(0)
    head = networks.init_categorised_head(gen, 16, 24, 3)
    assert tuple(head["kernel"].shape) == (4, 16, 24)
    assert tuple(head["bias"].shape) == (4, 24) and not head["bias"].any()
    limit = np.sqrt(6.0 / (16 + 24 * 4))
    assert float(head["kernel"].abs().max()) <= limit
    rng = np.random.RandomState(2)
    cat = {"kernel": rng.randn(4, 16, 24).astype(np.float32),
           "bias": rng.randn(4, 24).astype(np.float32)}
    h = rng.randn(2, 5, 16).astype(np.float32)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        ref = jnetworks.apply_categorised_logits(_jax(cat), jnp.asarray(h),
                                                 compute_dtype=jdt)
        ours = networks.apply_categorised_logits(
            _torch_heads({"c": cat})["c"], torch.from_numpy(h),
            compute_dtype=tdt)
        assert ours.shape == (2, 5, 24, 4)
        assert_close(ours, ref, 1e-5)


def test_supports_matches_jax():
    for name in [*BASES, "constrained poisson", "bernoulli", "lomax"]:
        for k_max in (0, 1, 4, 10, 28, 29, 30, 31, 100):
            assert (ops.supports_fused_likelihood(name, k_max)
                    == jfl.supports_fused_likelihood(name, k_max)), (name,
                                                                    k_max)
    assert ops.supports_fused_likelihood("poisson", 30)  # 32 heads
    assert not ops.supports_fused_likelihood("poisson", 31)


# --------------------------------------------------------------------------
# The fused likelihood (plain versions of the kernels) against JAX's kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", BASES)
@pytest.mark.parametrize("k_max", [1, 4])
@pytest.mark.parametrize("compute", [None, "bf16"])
def test_forward_and_vjp_match_jax_interpret(name, k_max, compute):
    h, heads, cat_w, cat_b, t, g = _case(name, k_max)
    t[:, :4] = [0.0, k_max - 1.0, float(k_max), k_max + 1.0]
    jax_dtype = None if compute is None else jnp.bfloat16
    torch_dtype = None if compute is None else torch.bfloat16

    def jax_loss(h_, heads_, cw, cb):
        return jfl.fused_categorised_log_likelihood(
            name, h_, heads_, cw, cb, jnp.asarray(t), compute_dtype=jax_dtype)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(jax_loss, jnp.asarray(h), _jax(heads),
                           jnp.asarray(cat_w), jnp.asarray(cat_b))
        ref_dh, ref_dheads, ref_dcw, ref_dcb = vjp(jnp.asarray(g))

    h_t = torch.from_numpy(h).requires_grad_(True)
    heads_t = _torch_heads(heads, requires_grad=True)
    cw_t = torch.from_numpy(cat_w).requires_grad_(True)
    cb_t = torch.from_numpy(cat_b).requires_grad_(True)
    out = ops.fused_categorised_log_likelihood(
        name, h_t, heads_t, cw_t, cb_t, torch.from_numpy(t),
        compute_dtype=torch_dtype)
    rtol = 1e-5 if compute is None else 2e-3
    assert_close(out, ref, rtol)
    names = ops.FAMILIES[name].heads
    leaves = [h_t, cw_t, cb_t] + [heads_t[n][k] for n in names
                                  for k in ("kernel", "bias")]
    refs = [ref_dh, ref_dcw, ref_dcb] + [ref_dheads[n][k] for n in names
                                         for k in ("kernel", "bias")]
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    for ours, want in zip(grads, refs, strict=True):
        assert_close(ours, want, rtol)


def test_largest_case_32_heads():
    """Poisson with K = 30: 1 + 31 = 32 heads, the cap.  The plain forward
    against JAX's unfused reference and the fused backward against JAX's
    autodiff of it, float32."""
    name, k_max = "poisson", 30
    h, heads, cat_w, cat_b, t, g = _case(name, k_max, m=20, f=40, seed=4)
    t = np.random.RandomState(5).poisson(20.0, t.shape).astype(np.float32)

    def jax_loss(h_, heads_, cw, cb):
        return jfl.reference_categorised_log_likelihood(
            name, h_, heads_, cw, cb, jnp.asarray(t))

    ref, vjp = jax.vjp(jax_loss, jnp.asarray(h), _jax(heads),
                       jnp.asarray(cat_w), jnp.asarray(cat_b))
    ref_dh, ref_dheads, ref_dcw, ref_dcb = vjp(jnp.asarray(g))
    h_t = torch.from_numpy(h).requires_grad_(True)
    heads_t = _torch_heads(heads, requires_grad=True)
    cw_t = torch.from_numpy(cat_w).requires_grad_(True)
    cb_t = torch.from_numpy(cat_b).requires_grad_(True)
    out = ops.fused_categorised_log_likelihood(name, h_t, heads_t, cw_t, cb_t,
                                               torch.from_numpy(t))
    assert_close(out, ref, 1e-5)
    leaves = [h_t, cw_t, cb_t, heads_t["log_lambda"]["kernel"],
              heads_t["log_lambda"]["bias"]]
    refs = [ref_dh, ref_dcw, ref_dcb, ref_dheads["log_lambda"]["kernel"],
            ref_dheads["log_lambda"]["bias"]]
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.from_numpy(g))
    for ours, want in zip(grads, refs):
        assert_close(ours, want, 1e-5)


def test_shared_targets_cycle_rows_and_bf16_targets():
    """h (S, B, H) against t (B, F) rides the cycled rows (the GMVAE's
    K·S·B rows over B targets) and equals the broadcast targets; bfloat16
    targets (exact counts ≤ 256) give the float32 results bit for bit."""
    name, k_max = "zero-inflated negative binomial", 3
    h, heads, cat_w, cat_b, t, _ = _case(name, k_max, m=3 * 8, m_t=8, seed=6)
    h3 = torch.from_numpy(h.reshape(3, 8, HIDDEN))
    args = (_torch_heads(heads), torch.from_numpy(cat_w),
            torch.from_numpy(cat_b))
    tt = torch.from_numpy(t)
    out = ops.fused_categorised_log_likelihood(name, h3, *args, tt)
    assert out.shape == (3, 8)
    broadcast = ops.fused_categorised_log_likelihood(
        name, h3, *args, tt.expand(3, 8, F))
    assert torch.equal(out, broadcast)
    ref = jfl.reference_categorised_log_likelihood(
        name, jnp.asarray(h.reshape(3, 8, HIDDEN)), _jax(heads),
        jnp.asarray(cat_w), jnp.asarray(cat_b), jnp.asarray(t)[None])
    assert_close(out, ref, 1e-5)
    for compute in (None, torch.bfloat16):
        f32 = ops.fused_categorised_log_likelihood(name, h3, *args, tt,
                                                   compute_dtype=compute)
        bf16 = ops.fused_categorised_log_likelihood(
            name, h3, *args, tt.to(torch.bfloat16), compute_dtype=compute)
        assert torch.equal(f32, bf16)


@pytest.mark.parametrize("name", BASES)
def test_cpu_wrappers_are_the_plain_versions(name):
    h, heads, cat_w, cat_b, t, g = _case(name, 2, m=8)
    ws = [torch.from_numpy(heads[n]["kernel"]) for n in ops.FAMILIES[name].heads]
    bs = [torch.from_numpy(heads[n]["bias"]) for n in ops.FAMILIES[name].heads]
    args = (torch.from_numpy(h), ws, bs, torch.from_numpy(cat_w),
            torch.from_numpy(cat_b), torch.from_numpy(t))
    before = dict(ops.launch_counts())
    ll, lse = ops.categorised_forward(name, *args, compute_dtype=torch.bfloat16)
    ref_ll, ref_lse = ops.reference_categorised_forward(
        name, *args, compute_dtype=torch.bfloat16)
    assert torch.equal(ll, ref_ll) and torch.equal(lse, ref_lse)
    assert lse.shape == (8, F)
    gt = torch.from_numpy(g)
    dh, *dw = ops.categorised_backward(name, gt, *args, lse)
    assert torch.equal(dh, ops.reference_categorised_dh(name, gt, *args, lse))
    want = ops.reference_categorised_dw(name, gt, *args, lse)
    assert len(dw) == len(want) == 2 * len(ws) + 2
    assert dw[-2].shape == cat_w.shape and dw[-1].shape == cat_b.shape
    for a, b in zip(dw, want):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before
    assert {f"cat_{ops.FAMILIES[name].prefix}_{kernel}" for kernel in
            ("forward", "backward_dh", "backward_dw")} <= set(before)
    with pytest.raises(ValueError):
        ops.fused_categorised_log_likelihood("constrained poisson",
                                             args[0], {}, args[3], args[4],
                                             args[5])


# --------------------------------------------------------------------------
# The VAE with categorised heads
# --------------------------------------------------------------------------

VAE_F, LATENT, VAE_HIDDEN, B = 30, 4, (16, 12), 24


@contextlib.contextmanager
def _jax_kernels():
    """The JAX package's Pallas kernels, in interpret mode on the CPU."""
    with force_pallas(), pltpu.force_tpu_interpret_mode():
        yield


def _vae_setup(k_max, precision=None, name="zero-inflated negative binomial",
               seed=0):
    common = dict(feature_size=VAE_F, latent_size=LATENT,
                  hidden_sizes=VAE_HIDDEN, reconstruction_distribution=name,
                  number_of_reconstruction_classes=k_max, precision=precision)
    jconfig, tconfig = jvae.VAEConfig(**common), tvae.VAEConfig(**common)
    params, state = jvae.init(jconfig, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)),
        params)
    x = np.random.RandomState(seed).poisson(3.0, (B, VAE_F)).astype(np.float32)
    return jconfig, tconfig, params, state, x


def _port(tree):
    return tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("k_max", [0, 3])
@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_vae_objective_and_gradients_match_jax(k_max, precision):
    """The training objective and its whole gradient against JAX's
    ``loss_fn`` with ``fused_likelihood=True`` (its kernels in interpret
    mode) and JAX's own z draws: ELBO terms rtol 2e-4 (KL 2e-3), gradient
    ‖Δ‖/‖g‖ ≤ 1e-4 in float32 and 5e-3 in bf16 (as
    ``tests/test_torch_vae.py``)."""
    jconfig, tconfig, params, state, x = _vae_setup(k_max, precision)
    jconfig = jvae.VAEConfig(**{**jconfig.__dict__, "fused_likelihood": True})
    assert ("categorised_logits" in params) == bool(k_max)
    rng = jax.random.PRNGKey(3)
    batch = {"x": jnp.asarray(x), "t": jnp.asarray(x)}

    def jax_loss(p):
        return jvae.loss_fn(jconfig, p, state, batch, rng, warm_up_weight=0.5)

    with _jax_kernels():
        (_, (jm, _)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
            params)
    tp, ts = _port(params), _port(state)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    noise = np.array(jax.random.normal(jax.random.split(rng, 3)[2],
                                       (1, B, LATENT)))
    xt = torch.from_numpy(x)
    loss, (tm, _) = tvae.loss_fn(tconfig, tp, ts, {"x": xt, "t": xt}, None,
                                 warm_up_weight=0.5,
                                 noise=torch.from_numpy(noise))
    for key, rtol in (("lower_bound", 2e-4), ("lower_bound_weighted", 2e-4),
                      ("reconstruction_error", 2e-4),
                      ("kl_divergence", 2e-3)):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=rtol)
    ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert list(ref) == list(named)
    want = np.concatenate([np.ravel(g) for g in ref.values()])
    got = torch.cat([g.ravel() for g in torch.autograd.grad(loss, leaves)])
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= (1e-4 if precision is None else 5e-3), err


def test_vae_evaluation_matches_jax():
    """Evaluation builds the ``Categorised`` distribution (unfused)."""
    jconfig, tconfig, params, state, x = _vae_setup(3, name="poisson", seed=1)
    rng = jax.random.PRNGKey(5)
    jm, _ = jvae.elbo_terms(jconfig, params, state,
                            {"x": jnp.asarray(x), "t": jnp.asarray(x)}, rng,
                            training=False)
    noise = np.array(jax.random.normal(jax.random.split(rng, 3)[2],
                                       (1, B, LATENT)))
    xt = torch.from_numpy(x)
    tm, tout = tvae.elbo_terms(tconfig, _port(params), _port(state),
                               {"x": xt, "t": xt}, None, training=False,
                               noise=torch.from_numpy(noise))
    assert isinstance(tout.p_x, td.Categorised)
    for key in ("lower_bound", "reconstruction_error"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-4)


def test_staged_row_constant_is_off_for_categorised():
    """The categorised likelihood carries lgamma inside its shifted branch,
    so the dataset's staged Σ lgamma(1+t) must neither be staged nor
    subtracted: the objective with it in the batch equals the objective
    without it, and the API does not stage it for k_max > 0."""
    _, tconfig, params, state, x = _vae_setup(3, seed=2)
    tp, ts = _port(params), _port(state)
    noise = torch.from_numpy(np.random.RandomState(3).randn(1, B, LATENT)
                             .astype(np.float32))
    xt = torch.from_numpy(x)
    plain, _ = tvae.elbo_terms(tconfig, tp, ts, {"x": xt, "t": xt}, None,
                               training=True, noise=noise)
    staged = {"x": xt, "t": xt,
              "t_lgamma_rowsum": torch.sum(special.lgamma(1.0 + xt), -1)}
    with_const, _ = tvae.elbo_terms(tconfig, tp, ts, staged, None,
                                    training=True, noise=noise)
    for key in ("lower_bound", "reconstruction_error"):
        assert float(with_const[key]) == float(plain[key])
    data = {"x": xt, "t": xt}
    assert api._append_lgamma_rowsum(data, tconfig) is data
    base = tvae.VAEConfig(feature_size=VAE_F,
                          reconstruction_distribution="negative binomial")
    assert "t_lgamma_rowsum" in api._append_lgamma_rowsum(data, base)


def test_vae_over_the_head_cap_raises():
    """Past 32 heads, or over the constrained Poisson, the categorised
    likelihood has no fused kernel: it trains unfused, as in the JAX
    package, and ``fused_likelihood=True`` raises ``ValueError`` in both."""
    assert tvae.fused_path_enabled(tvae.VAEConfig(
        feature_size=10, reconstruction_distribution="poisson",
        number_of_reconstruction_classes=30))
    for name, k_max in (("poisson", 31), ("zero-inflated negative binomial",
                                          29), ("constrained poisson", 2)):
        config = tvae.VAEConfig(feature_size=10,
                                reconstruction_distribution=name,
                                number_of_reconstruction_classes=k_max)
        assert not tvae.fused_path_enabled(config)
        kwargs = dict(feature_size=10, reconstruction_distribution=name,
                      number_of_reconstruction_classes=k_max,
                      fused_likelihood=True)
        with pytest.raises(ValueError, match="no fused kernel"):
            tvae.VAEConfig(**kwargs)
        with pytest.raises(ValueError, match="no fused kernel"):
            jvae._fused_path_enabled(jvae.VAEConfig(**kwargs))


def test_vae_categorised_trains_on_cpu():
    """VAE-ZINB-cat trains through the config-level functions, as the JAX
    package's ``bench.py`` config 3 does: the API refuses a zero-inflated
    base with classes (``validate_model_parameters``)."""
    from scvae_tpu_torch.data.dataset import DataSet
    from scvae_tpu_torch.data.pipeline import (
        build_model_arrays,
        device_resident_data,
    )
    from scvae_tpu_torch.models import step, training

    x = np.random.RandomState(0).poisson(3.0, (256, 40)).astype(np.float32)
    config = tvae.VAEConfig(
        feature_size=40, latent_size=4, hidden_sizes=(16, 16),
        reconstruction_distribution="zero-inflated negative binomial",
        number_of_reconstruction_classes=3, learning_rate=1e-3,
    )
    optimizer = step.make_optimizer(config.learning_rate)
    ts = step.create_train_state(
        *tvae.init(config, torch.Generator().manual_seed(0)), optimizer)
    data = device_resident_data(
        build_model_arrays(DataSet("in-memory", values=x)), device="cpu")

    def loss(params, model_state, batch, generator, warm_up_weight,
             shard=None):
        return tvae.loss_fn(config, params, model_state, batch, generator,
                            warm_up_weight=warm_up_weight, shard=shard)

    run_epoch = training.device_epoch_runner(
        step.make_train_epoch(loss, optimizer), data, 256, 64, seed=0)
    generator = torch.Generator().manual_seed(0)
    curve = []
    for epoch in range(2):
        ts, metrics = run_epoch(ts, epoch, 1.0, generator)
        curve.append(metrics["lower_bound"])
    assert np.all(np.isfinite(curve)) and curve[1] > curve[0]
    assert ts.step == 8
    head = ts.params["categorised_logits"]
    assert tuple(head["kernel"].shape) == (4, 16, 40)
