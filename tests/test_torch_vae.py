"""The port's VAE objective against the JAX package's, with the same
parameters (moved with ``params_from_jax``) and the JAX model's own
standard-normal draws injected as the port's z noise, for every ported
reconstruction likelihood.  The JAX side's training objective runs its
fused Pallas kernels in interpret mode.

Tolerances (PARITY.md §1): ELBO and reconstruction term rtol 2e-4, KL rtol
2e-3; batch-norm running statistics and z rtol 1e-5."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu.models import vae as jvae
from scvae_tpu.ops import force_pallas
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import networks
from scvae_tpu_torch.models import vae as tvae
from scvae_tpu_torch.ops import special

F, LATENT, HIDDEN, B = 30, 4, (16, 12), 24
LIKELIHOODS = ("negative binomial", "poisson", "zero-inflated poisson",
               "zero-inflated negative binomial", "constrained poisson")


@contextlib.contextmanager
def _jax_kernels():
    """The JAX package's Pallas kernels, in interpret mode on the CPU."""
    with force_pallas(), pltpu.force_tpu_interpret_mode():
        yield


def _configs(name="negative binomial", **kwargs):
    common = dict(
        feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
        reconstruction_distribution=name, **kwargs,
    )
    return jvae.VAEConfig(**common), tvae.VAEConfig(**common)


def _batch(x, framework):
    """x, t and the per-cell count sums (B, 1) as one framework's arrays."""
    to = jnp.asarray if framework == "jax" else torch.from_numpy
    return {"x": to(x), "t": to(x),
            "count_sum": to(x.sum(-1, keepdims=True).astype(np.float32))}


def _setup(seed=0, name="negative binomial", **kwargs):
    jconfig, tconfig = _configs(name, **kwargs)
    rng = jax.random.PRNGKey(seed)
    params, state = jvae.init(jconfig, rng)
    # non-trivial batch-norm statistics and offsets
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)), params
    )
    x = np.random.RandomState(seed).poisson(2.0, (B, F)).astype(np.float32)
    return jconfig, tconfig, params, state, x


def _jax_noise(rng, n_samples):
    """The draws JAX's forward makes for z (vae.forward splits its key in
    three and samples the posterior with the last)."""
    rng_z = jax.random.split(rng, 3)[2]
    return np.array(jax.random.normal(rng_z, (n_samples, B, LATENT)))


def _port(params, state):
    return (tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
            tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, state)))


def _compare(jm, tm):
    for key, rtol in (("lower_bound", 2e-4), ("lower_bound_weighted", 2e-4),
                      ("reconstruction_error", 2e-4), ("kl_divergence", 2e-3)):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol)
    np.testing.assert_allclose(
        tm["kl_divergence_neurons"].detach().numpy(),
        np.asarray(jm["kl_divergence_neurons"]), rtol=2e-3, atol=1e-5,
    )


@pytest.mark.parametrize("name", LIKELIHOODS)
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("n_iw", [1, 2])
def test_elbo_terms_match_jax(name, training, n_iw):
    """Training: the fused path on both sides (the port's plain kernel
    versions, JAX's kernels in interpret mode); evaluation: the unfused
    registry path."""
    jconfig, tconfig, params, state, x = _setup(name=name)
    rng = jax.random.PRNGKey(7)
    with _jax_kernels() if training else contextlib.nullcontext():
        jm, jout = jvae.elbo_terms(jconfig, params, state, _batch(x, "jax"),
                                   rng, training=training, n_iw=n_iw,
                                   warm_up_weight=0.5)
    tp, ts = _port(params, state)
    tm, tout = tvae.elbo_terms(
        tconfig, tp, ts, _batch(x, "torch"), None, training=training,
        n_iw=n_iw, warm_up_weight=0.5,
        noise=torch.from_numpy(_jax_noise(rng, n_iw)),
    )
    _compare(jm, tm)
    np.testing.assert_allclose(tout.z.detach().numpy(), np.asarray(jout.z),
                               rtol=1e-5, atol=1e-6)
    # batch-norm running statistics (updated in training, kept in evaluation)
    for part in ("encoder", "decoder"):
        ours = tparams.flatten(tout.new_state[part])
        ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jout.new_state[part]))
        assert ours.keys() == ref.keys()
        for name in ref:
            np.testing.assert_allclose(ours[name].numpy(), ref[name],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_iw", [1, 2])
def test_bf16_training_objective_and_gradients_match_jax(n_iw):
    """bf16 matmul inputs with float32 accumulation and products (the GPU
    default) against JAX with ``precision="bfloat16"``: the objective at the
    float32 tolerances above, and the whole parameter gradient to 5e-3 in
    norm (‖Δ‖/‖g‖): float32 summation order flips a few bf16 roundings,
    which the backward carries.  Matmuls that return bf16 products fail
    this test."""
    jconfig, tconfig, params, state, x = _setup(seed=4, precision="bfloat16")
    rng = jax.random.PRNGKey(11)
    batch = {"x": jnp.asarray(x), "t": jnp.asarray(x)}

    def jax_loss(p):
        return jvae.loss_fn(jconfig, p, state, batch, rng, n_iw=n_iw,
                            warm_up_weight=0.5)

    (_, (jm, _)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tp, ts = _port(params, state)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    xt = torch.from_numpy(x)
    loss, (tm, _) = tvae.loss_fn(
        tconfig, tp, ts, {"x": xt, "t": xt}, None, n_iw=n_iw,
        warm_up_weight=0.5, noise=torch.from_numpy(_jax_noise(rng, n_iw)),
    )
    assert tconfig.compute_dtype(True, "cpu") == torch.bfloat16
    _compare(jm, {k: v.detach() for k, v in tm.items()})
    ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert list(ref) == list(named)
    want = np.concatenate([np.ravel(g) for g in ref.values()])
    got = torch.cat([g.ravel() for g in torch.autograd.grad(loss, leaves)])
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 5e-3, err


@pytest.mark.parametrize("name", LIKELIHOODS)
def test_staged_row_constant_matches_in_kernel_constant(name):
    """The training path with Σ lgamma(1+t) staged per row gives the same
    objective as the path that subtracts it inside the likelihood; the
    constrained Poisson's kernel keeps its own constant, so the staged one
    must not be applied to it a second time."""
    _, tconfig, params, state, x = _setup(seed=2, name=name)
    tp, ts = _port(params, state)
    noise = torch.from_numpy(np.random.RandomState(3).randn(1, B, LATENT)
                             .astype(np.float32))
    plain, _ = tvae.elbo_terms(tconfig, tp, ts, _batch(x, "torch"), None,
                               training=True, noise=noise)
    batch = _batch(x, "torch")
    batch["t_lgamma_rowsum"] = torch.sum(special.lgamma(1.0 + batch["t"]),
                                         dim=-1)
    staged, _ = tvae.elbo_terms(tconfig, tp, ts, batch, None, training=True,
                                noise=noise)
    for key in ("lower_bound", "reconstruction_error"):
        np.testing.assert_allclose(float(staged[key]), float(plain[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("n_iw", [1, 2])
def test_constrained_poisson_bf16_objective_and_gradients_match_jax(n_iw):
    """bf16 training with the constrained Poisson against JAX with its
    kernels forced on (interpret mode), so that the JAX side runs
    ``_cp_fused_forward`` / ``_cp_fused_backward`` on the bf16 decoder
    output with float32 weights.  The port's batch also carries the staged
    Σ lgamma(1+t), which the constrained Poisson must ignore.  Tolerances as
    the bf16 test above."""
    name = "constrained poisson"
    jconfig, tconfig, params, state, x = _setup(seed=5, name=name,
                                                precision="bfloat16")
    rng = jax.random.PRNGKey(13)

    def jax_loss(p):
        return jvae.loss_fn(jconfig, p, state, _batch(x, "jax"), rng,
                            n_iw=n_iw, warm_up_weight=0.5)

    with _jax_kernels():
        (_, (jm, _)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tp, ts = _port(params, state)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    batch = _batch(x, "torch")
    batch["t_lgamma_rowsum"] = torch.sum(special.lgamma(1.0 + batch["t"]),
                                         dim=-1)
    loss, (tm, _) = tvae.loss_fn(
        tconfig, tp, ts, batch, None, n_iw=n_iw, warm_up_weight=0.5,
        noise=torch.from_numpy(_jax_noise(rng, n_iw)),
    )
    _compare(jm, {k: v.detach() for k, v in tm.items()})
    ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert list(ref) == list(named)
    want = np.concatenate([np.ravel(g) for g in ref.values()])
    got = torch.cat([g.ravel() for g in torch.autograd.grad(loss, leaves)])
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 5e-3, err


@pytest.mark.parametrize("name", ["negative binomial",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
def test_params_round_trip_and_keystr_names(name):
    jconfig, _, params, state, _ = _setup(name=name)
    assert set(params["reconstruction"]) == set(
        jconfig.reconstruction_spec.parameters)
    flat_jax = {
        jax.tree_util.keystr(path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    tp = tparams.params_from_jax(flat_jax)  # a checkpoint-style flat mapping
    ours = tparams.flatten(tp)
    assert ours.keys() == flat_jax.keys()
    for name, leaf in flat_jax.items():
        np.testing.assert_array_equal(ours[name].numpy(), leaf)
    back = tparams.params_to_jax(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the layout is the JAX one: dense kernels are (in, out)
    assert tuple(tp["encoder"]["layers"][0]["kernel"].shape) == (F, HIDDEN[0])
    _, ts = _port(params, state)
    assert tparams.flatten(ts).keys() == {
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]
    }


def test_unported_options_raise():
    """What earlier slices refused now constructs: batch correction, the
    count sum feature, the LFM architectures, categorised heads over the
    32-head cap or a base without a kernel, and every reconstruction
    distribution (all of them train unfused).  What stays refused, as in
    the JAX package: ``fused_likelihood=True`` without a kernel, an unknown
    architecture, a parameterised VAE posterior; and the categorical as a
    reconstruction, on whose shapes the JAX VAE fails."""
    for kwargs in ({"number_of_reconstruction_classes": 30},  # 33 heads
                   {"batch_correction": True, "number_of_batches": 3},
                   {"count_sum": True}, {"inference_architecture": "LFM"},
                   {"generative_architecture": "LFM"}):
        config = tvae.VAEConfig(feature_size=F,
                                reconstruction_distribution="negative binomial",
                                **kwargs)
        jconfig = jvae.VAEConfig(feature_size=F,
                                 reconstruction_distribution="negative binomial",
                                 **kwargs)
        assert config.decoder_input_size() == jconfig.decoder_input_size()
        assert tvae.fused_path_enabled(config) == (
            "number_of_reconstruction_classes" not in kwargs)
    for name, k_max in (("poisson", 31), ("zero-inflated poisson", 30),
                        ("zero-inflated negative binomial", 29),
                        ("constrained poisson", 3)):
        config = tvae.VAEConfig(feature_size=F, reconstruction_distribution=name,
                                number_of_reconstruction_classes=k_max)
        assert not tvae.fused_path_enabled(config)
        with pytest.raises(ValueError, match="no fused kernel"):
            tvae.VAEConfig(feature_size=F, reconstruction_distribution=name,
                           number_of_reconstruction_classes=k_max,
                           fused_likelihood=True)
    for name in ("bernoulli", "lomax", "softplus gaussian"):
        assert not tvae.fused_path_enabled(
            tvae.VAEConfig(feature_size=F, reconstruction_distribution=name))
    with pytest.raises(ValueError, match="not a reconstruction"):
        tvae.VAEConfig(feature_size=F, reconstruction_distribution="categorical")
    with pytest.raises(ValueError, match="can only be MLP or LFM"):
        tvae.VAEConfig(feature_size=F, inference_architecture="CNN")
    with pytest.raises(ValueError):  # as the JAX package's validation
        tvae.VAEConfig(feature_size=F, parameterise_latent_posterior=True)


def test_inverted_dropout():
    """Kept units are scaled by 1/keep, dropped ones are 0, and about a
    fraction keep survive (the generator's bits differ from JAX's, so the
    mask itself is not compared)."""
    x = torch.ones(200, 50)
    gen = torch.Generator().manual_seed(0)
    y = networks.dropout(x, 0.8, gen)
    values = set(torch.unique(y).tolist())
    assert values <= {0.0, 1.25}
    assert abs(float((y > 0).float().mean()) - 0.8) < 0.02
    assert networks.dropout(x, 1.0, gen) is x
    h, _ = networks.apply_mlp(
        {"layers": [{"kernel": torch.eye(50), "bias": torch.zeros(50)}]}, {},
        x, training=True, generator=gen, input_dropout_keep_prob=0.5,
    )
    assert set(torch.unique(h).tolist()) <= {0.0, 2.0}
