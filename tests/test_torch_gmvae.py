"""The port's GMVAE against the JAX package's, with the same parameters
(moved with ``params_from_jax``) and the JAX model's own standard-normal z
draws (S, K, B, D) injected as the port's noise.  The JAX side's training
objective runs its fused Pallas kernels in interpret mode (one flat launch
over the K·S·B decoder rows against the shared (B, F) targets).

Tolerances (as ``tests/test_torch_vae.py``): ELBO and reconstruction terms
rtol 2e-4, KL terms 2e-3, z and the per-cluster batch-norm running
statistics rtol 1e-5; the whole parameter gradient ‖Δ‖/‖g‖ ≤ 1e-4 in
float32 and 5e-3 with bf16 matmul inputs."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from scvae_tpu import distributions as jd
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import networks as jnetworks
from scvae_tpu.ops import force_pallas
from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder
from scvae_tpu_torch import distributions as td
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import gmvae as tgmvae
from scvae_tpu_torch.models import networks

F, LATENT, HIDDEN, B, K = 20, 3, (12, 10), 16, 3


@contextlib.contextmanager
def _jax_kernels():
    """The JAX package's Pallas kernels, in interpret mode on the CPU."""
    with force_pallas(), pltpu.force_tpu_interpret_mode():
        yield


def _setup(name="negative binomial", seed=0, **kwargs):
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  reconstruction_distribution=name,
                  number_of_latent_clusters=K, **kwargs)
    jconfig = jgmvae.GMVAEConfig(**common, fused_likelihood=True)
    tconfig = tgmvae.GMVAEConfig(**common)
    params, state = jgmvae.init(jconfig, jax.random.PRNGKey(seed))
    # non-trivial offsets and batch-norm running statistics
    wave = lambda s: lambda a: a + s * jnp.cos(  # noqa: E731
        jnp.arange(a.size).reshape(a.shape))
    params = jax.tree_util.tree_map(wave(0.05), params)
    state = jax.tree_util.tree_map(wave(0.1), state)
    x = np.random.RandomState(seed).poisson(2.0, (B, F)).astype(np.float32)
    return jconfig, tconfig, params, state, x


def _batch(x, framework):
    to = jnp.asarray if framework == "jax" else torch.from_numpy
    return {"x": to(x), "t": to(x),
            "count_sum": to(x.sum(-1, keepdims=True).astype(np.float32))}


def _jax_noise(rng, n_samples):
    """The draws JAX's forward makes for z: it splits its key in four and
    samples (S, K, B, D) with the third."""
    return np.array(jax.random.normal(jax.random.split(rng, 4)[2],
                                      (n_samples, K, B, LATENT)))


def _port(tree):
    return tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _compare(jm, tm):
    for key, rtol in (("lower_bound", 2e-4), ("lower_bound_weighted", 2e-4),
                      ("reconstruction_error", 2e-4), ("kl_divergence", 2e-3),
                      ("kl_divergence_z", 2e-3), ("kl_divergence_y", 2e-3)):
        np.testing.assert_allclose(float(tm[key].detach()), float(jm[key]),
                                   rtol=rtol, err_msg=key)
    np.testing.assert_allclose(
        tm["kl_divergence_neurons"].detach().numpy(),
        np.asarray(jm["kl_divergence_neurons"]), rtol=2e-3, atol=1e-5)


def _compare_states(tout, jout):
    for part in ("q_y", "q_z", "decoder"):
        ours = tparams.flatten(tout.new_state[part])
        ref = tparams.flatten(jax.tree_util.tree_map(np.asarray,
                                                     jout.new_state[part]))
        assert ours.keys() == ref.keys() and ref
        for name in ref:
            np.testing.assert_allclose(ours[name].numpy(), ref[name],
                                       rtol=1e-5, atol=1e-6)


CASES = {
    "nb": dict(name="negative binomial"),
    "zinb-free-nats": dict(name="zero-inflated negative binomial",
                           proportion_of_free_nats_for_y_kl_divergence=0.5),
    "cp-learned-prior": dict(name="constrained poisson",
                             prior_probabilities_method="learn"),
    "nb-categorised-learned": dict(name="negative binomial",
                                   number_of_reconstruction_classes=2,
                                   prior_probabilities_method="learn"),
    "poisson-custom-prior": dict(name="poisson",
                                 prior_probabilities_method="custom",
                                 prior_probabilities=(0.5, 0.3, 0.2)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("training", [True, False])
def test_elbo_terms_match_jax(case, training):
    """Training: the fused path on both sides (the port's plain kernel
    versions over the K·S·B rows, JAX's kernels in interpret mode, two
    importance samples); evaluation: the unfused registry path.  The
    per-cluster batch-norm running statistics (the mean over clusters of
    each cluster's update) match JAX's ``vmap``."""
    kwargs = dict(CASES[case])
    name = kwargs.pop("name")
    jconfig, tconfig, params, state, x = _setup(name, **kwargs)
    rng = jax.random.PRNGKey(7)
    n_iw = 2 if training else 1
    with _jax_kernels() if training else contextlib.nullcontext():
        jm, jout = jgmvae.elbo_terms(jconfig, params, state, _batch(x, "jax"),
                                     rng, training=training, n_iw=n_iw,
                                     warm_up_weight=0.5)
    tm, tout = tgmvae.elbo_terms(
        tconfig, _port(params), _port(state), _batch(x, "torch"), None,
        training=training, n_iw=n_iw, warm_up_weight=0.5,
        noise=torch.from_numpy(_jax_noise(rng, n_iw)),
    )
    _compare(jm, tm)
    assert tout.z.shape == (n_iw, K, B, LATENT)
    assert tout.decoder_hidden.shape == (K, n_iw, B, HIDDEN[0])
    np.testing.assert_allclose(tout.z.detach().numpy(), np.asarray(jout.z),
                               rtol=1e-5, atol=1e-6)
    _compare_states(tout, jout)


@pytest.mark.parametrize("case,precision", [
    ("nb", None), ("nb-categorised-learned", None), ("cp-learned-prior", None),
    ("nb", "bfloat16"), ("zinb-free-nats", "bfloat16"),
])
def test_loss_gradients_match_jax(case, precision):
    """The training objective and its whole parameter gradient.  The bf16
    cases take the split first layer (x W[:F] rounded, the one-hot row
    added in float32) and the float32 q(y|x) and p(z|y) heads, as JAX
    does."""
    kwargs = dict(CASES[case])
    name = kwargs.pop("name")
    jconfig, tconfig, params, state, x = _setup(name, seed=1,
                                                precision=precision, **kwargs)
    rng = jax.random.PRNGKey(11)

    def jax_loss(p):
        return jgmvae.loss_fn(jconfig, p, state, _batch(x, "jax"), rng,
                              warm_up_weight=0.5)

    with _jax_kernels():
        (_, (jm, _)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
            params)
    tp = _port(params)
    named = tparams.flatten(tp)
    leaves = [leaf.requires_grad_(True) for leaf in named.values()]
    loss, (tm, _) = tgmvae.loss_fn(
        tconfig, tp, _port(state), _batch(x, "torch"), None,
        warm_up_weight=0.5, noise=torch.from_numpy(_jax_noise(rng, 1)))
    assert (tconfig.compute_dtype(True, "cpu") is None) == (precision is None)
    _compare(jm, tm)
    ref = tparams.flatten(jax.tree_util.tree_map(np.asarray, jgrads))
    assert list(ref) == list(named)
    want = np.concatenate([np.ravel(g) for g in ref.values()])
    got = torch.cat([g.ravel() for g in torch.autograd.grad(loss, leaves)])
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= (1e-4 if precision is None else 5e-3), err


def test_concatenated_input_branch_matches_jax():
    """With input dropout active, both frameworks feed concat(x, y_k) to the
    q(z|x,y) encoder instead of splitting its first layer.  A keep
    probability of 1 − 1e-6 keeps every unit on both sides here (checked),
    so the two runs see the same, all-kept, masks."""
    jconfig, tconfig, params, state, x = _setup(
        seed=2, dropout_keep_probabilities=(1.0, 1.0 - 1e-6))
    assert tconfig.dropout_keep_probability_x < 1.0
    rng = jax.random.PRNGKey(5)
    with _jax_kernels():
        jm, jout = jgmvae.elbo_terms(jconfig, params, state, _batch(x, "jax"),
                                     rng, training=True)
    generator = torch.Generator().manual_seed(0)
    tm, tout = tgmvae.elbo_terms(
        tconfig, _port(params), _port(state), _batch(x, "torch"), generator,
        training=True, noise=torch.from_numpy(_jax_noise(rng, 1)))
    _compare(jm, tm)
    _compare_states(tout, jout)


def test_per_cluster_batch_norm():
    """Statistics per cluster of the leading axis; the running state is the
    mean over clusters of each cluster's update (JAX: ``vmap`` over the
    clusters, then ``_mean_over_clusters``)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 5).astype(np.float32) * np.arange(1, 5)[:, None, None]
    params = {"beta": rng.randn(5).astype(np.float32)}
    state = {"mean": rng.randn(5).astype(np.float32),
             "var": rng.rand(5).astype(np.float32) + 0.5}

    def one(xk):
        return jnetworks.apply_batch_norm(params, state, xk, training=True)

    ref_y, ref_state = jax.vmap(one)(jnp.asarray(x))
    y, new_state = networks.apply_batch_norm(
        _port(params), _port(state), torch.from_numpy(x), training=True,
        clusters=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5,
                               atol=1e-6)
    for key in ("mean", "var"):
        np.testing.assert_allclose(new_state[key].numpy(),
                                   np.asarray(ref_state[key]).mean(0),
                                   rtol=1e-5, atol=1e-7)
    # without the cluster axis, one set of statistics over every row
    flat, _ = networks.apply_batch_norm(_port(params), _port(state),
                                        torch.from_numpy(x), training=True)
    ref_flat, _ = jnetworks.apply_batch_norm(params, state, jnp.asarray(x),
                                             training=True)
    np.testing.assert_allclose(flat.numpy(), np.asarray(ref_flat), rtol=1e-5,
                               atol=1e-6)


def test_softplus_gaussian_and_gmvae_names_match_jax():
    rng = np.random.RandomState(4)
    raw = {p: rng.uniform(-30, 30, (5, 3)).astype(np.float32)
           for p in ("mean", "softplus_scale")}
    z = rng.randn(2, 5, 3).astype(np.float32)
    for name in ("softplus gaussian", "modified gaussian"):
        j_spec, t_spec = jd.DISTRIBUTIONS[name], td.DISTRIBUTIONS[name]
        assert list(j_spec.parameters) == list(t_spec.parameters)
        ref = j_spec.build({k: j_spec.parameters[k].constrain(jnp.asarray(v))
                            for k, v in raw.items()})
        ours = t_spec.build({k: t_spec.parameters[k].constrain(
            torch.from_numpy(v)) for k, v in raw.items()})
        np.testing.assert_allclose(ours.log_prob(torch.from_numpy(z)).numpy(),
                                   np.asarray(ref.log_prob(jnp.asarray(z))),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours.variance().numpy(),
                                   np.asarray(ref.variance()), rtol=1e-6)
    for alias in ("gaussian mixture", "Legacy Gaussian Mixture"):
        name = td.parse_distribution(alias, "GMVAE")
        assert name == jd.parse_distribution(alias, "GMVAE")
        assert (td.GAUSSIAN_MIXTURE_DISTRIBUTIONS[name]
                == jd.GAUSSIAN_MIXTURE_DISTRIBUTIONS[name])
    assert td.parse_distribution("categorical") == "categorical"
    name = td.parse_distribution("Full-Covariance Gaussian Mixture", "GMVAE")
    assert name == jd.parse_distribution("Full-Covariance Gaussian Mixture",
                                         "GMVAE")
    assert (td.GAUSSIAN_MIXTURE_DISTRIBUTIONS[name]
            == jd.GAUSSIAN_MIXTURE_DISTRIBUTIONS[name])


def test_prior_centroids_and_latent_means_match_jax():
    jconfig, tconfig, params, state, x = _setup(
        seed=3, prior_probabilities_method="learn")
    params["p_y_logits"] = jnp.asarray([0.2, -0.1, 0.4], jnp.float32)
    ref = jgmvae.prior_centroids(jconfig, params)
    ours = tgmvae.prior_centroids(tconfig, _port(params))
    for key in ("probabilities", "means", "covariance_matrices"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=1e-7)
    ref_z = jgmvae.latent_means(jconfig, params, state, jnp.asarray(x))
    z = tgmvae.latent_means(tconfig, _port(params), _port(state),
                            torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["nb-categorised-learned", "cp-learned-prior"])
def test_params_round_trip(case):
    """The GMVAE tree (q_y, q_z, p_z, p_y_logits, decoder, reconstruction,
    categorised_logits (K+1, H, F)) moves to the port and back unchanged,
    from a nested tree and from a checkpoint-style flat mapping."""
    kwargs = dict(CASES[case])
    name = kwargs.pop("name")
    jconfig, tconfig, params, state, _ = _setup(name, **kwargs)
    assert "p_y_logits" in params
    flat_jax = {jax.tree_util.keystr(path): np.asarray(leaf)
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(params)[0]}
    for source in (flat_jax, jax.tree_util.tree_map(np.asarray, params)):
        tp = tparams.params_from_jax(source)
        ours = tparams.flatten(tp)
        assert ours.keys() == flat_jax.keys()
        for key, leaf in flat_jax.items():
            np.testing.assert_array_equal(ours[key].numpy(), leaf)
        back = tparams.params_to_jax(tp)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, np.asarray(b))
    # the port's own init has the JAX package's tree and shapes
    ours_init, ours_state = tgmvae.init(tconfig, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in tparams.flatten(ours_init).items()} == {
        k: tuple(v.shape) for k, v in flat_jax.items()}
    assert tparams.flatten(ours_state).keys() == tparams.flatten(
        jax.tree_util.tree_map(np.asarray, state)).keys()
    if jconfig.k_max:
        assert tuple(tp["categorised_logits"]["kernel"].shape) == (
            jconfig.k_max + 1, HIDDEN[0], F)


@pytest.fixture
def in_tmp_path(tmp_path, monkeypatch):
    """Run in a fresh working directory: a model given no log directory
    writes its run under ``./models``, and would resume another test's."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("kwargs", [
    dict(reconstruction_distribution="negative binomial"),
    dict(reconstruction_distribution="zero-inflated negative binomial",
         number_of_reconstruction_classes=3,
         prior_probabilities_method="learn",
         proportion_of_free_nats_for_y_kl_divergence=0.5),
])
def test_train_on_cpu_rises(kwargs, in_tmp_path):
    """A few GMVAE steps through the VAE API's ``train`` (the model hooks):
    a finite, rising ELBO."""
    x = np.random.RandomState(0).poisson(2.0, (256, 40)).astype(np.float32)
    model = GaussianMixtureVariationalAutoencoder(
        feature_size=40, latent_size=4, hidden_sizes=[16, 16],
        number_of_latent_clusters=3, learning_rate=1e-3, **kwargs)
    result = model.train(x, number_of_epochs=2, minibatch_size=64,
                         device="cpu", verbose=False)
    curve = result.history["training"]["lower_bound"]
    assert len(curve) == 2 and np.all(np.isfinite(curve))
    assert curve[1] > curve[0]
    assert result.steps_per_epoch == 4 and result.train_state.step == 8
    assert set(result.train_state.params) >= {"q_y", "q_z", "p_z", "decoder",
                                              "reconstruction"}


def test_unported_options_raise(monkeypatch, in_tmp_path):
    def model(**kwargs):
        return GaussianMixtureVariationalAutoencoder(
            feature_size=10, latent_size=2, hidden_sizes=[8],
            reconstruction_distribution="negative binomial", **kwargs)

    assert model().number_of_latent_clusters == 1  # the reference default
    assert model().config.latent_distribution == "gaussian mixture"
    # ported in this slice: each constructs; the last two train unfused
    for kwargs, fused in (
            ({"latent_distribution": "full-covariance gaussian mixture"}, True),
            ({"batch_correction": True}, True), ({"count_sum": True}, True),
            ({"number_of_reconstruction_classes": 30}, False),  # 33 heads
            ({"fused_likelihood": False}, False)):
        assert tgmvae.fused_path_enabled(model(**kwargs).config) is fused
    assert not tgmvae.fused_path_enabled(GaussianMixtureVariationalAutoencoder(
        feature_size=10, reconstruction_distribution="bernoulli").config)
    gmvae = model(number_of_latent_clusters=2)
    x = np.ones((32, 10), np.float32)
    with pytest.raises(FileNotFoundError, match="train the model first"):
        gmvae.sample(device="cpu")  # nothing under the default directory
    # labels are ported: a labelled set trains with its accuracy and
    # evaluates with the labels its clusters map to
    from scvae_tpu_torch import DataSet

    labelled = DataSet("in-memory", values=x,
                       labels=np.array(["a", "b", "No class", "b"] * 8))
    history = gmvae.train(labelled, number_of_epochs=1, minibatch_size=16,
                          device="cpu", verbose=False).history
    assert 0.0 <= history["training"]["accuracy"][0] <= 1.0
    evaluated = gmvae.evaluate(labelled, output_versions="transformed",
                               device="cpu", verbose=False)
    assert evaluated.predicted_labels.shape == (32,)
    assert set(evaluated.predicted_labels) <= {"a", "b"}
    # a caches directory is ported: the GMVAE trains there on the CPU,
    # resuming the run above for its second epoch
    result = gmvae.train(labelled, device="cpu", caches_directory="caches",
                         number_of_epochs=2, minibatch_size=16, verbose=False)
    curve = result.history["training"]["lower_bound"]
    assert len(curve) == 2 and np.isfinite(curve).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gmvae.train(x, number_of_epochs=1, minibatch_size=16, verbose=False)
