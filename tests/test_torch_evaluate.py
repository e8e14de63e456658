"""Evaluation and sampling in the port against the JAX package.

* ``evaluation_outputs`` of the VAE (every likelihood the port trains, the
  categorised ones and the constrained Poisson included) and of the GMVAE
  (with q(y|x), the cluster ids and the per-cluster marginalisation) on the
  same weights and the JAX model's own z draws;
* sampling: the GMVAE's ancestral draws (y by the inverse of p(y)'s
  cumulative probabilities at given uniforms, z from p(z|y) with given
  standard-normal draws) and the decoder means E[x|z] of both models against
  the JAX package's ``sample`` arithmetic;
* the API on the CPU: train with a validation set and a log directory, then
  ``evaluate`` (the output sets, the standard deviations kept for the
  evaluation subset only, the GMVAE's cluster ids and y set) and ``sample``.

Tolerances: the latent means, z, q(y|x) and the prior draws rtol 1e-5 (atol
1e-6); the reconstruction's means and standard deviations and the decoded
means rtol 1e-4 (atol 1e-6), since they leave the decoder through exp and
carry the activations' float32 rounding as a relative error; the ELBO and
reconstruction term rtol 2e-4 and the KL terms 2e-3, as in
``tests/test_torch_vae.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from scvae_tpu import distributions as jd
from scvae_tpu.data.utilities import indices_for_evaluation_subset as jsubset
from scvae_tpu.models import checkpoints as jcheckpoints
from scvae_tpu.models import gmvae as jgmvae
from scvae_tpu.models import networks as jnetworks
from scvae_tpu.models import vae as jvae
from scvae_tpu.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
)
from scvae_tpu_torch import (
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.data import DataSet, indices_for_evaluation_subset
from scvae_tpu_torch.models import checkpoints
from scvae_tpu_torch.models import gmvae as tgmvae
from scvae_tpu_torch.models import vae as tvae

F, LATENT, HIDDEN, B, K = 18, 3, (12, 10), 16, 3

VAE_CASES = {
    "nb": dict(reconstruction_distribution="negative binomial"),
    "poisson": dict(reconstruction_distribution="poisson"),
    "zip": dict(reconstruction_distribution="zero-inflated poisson"),
    "zinb": dict(reconstruction_distribution="zero-inflated negative binomial"),
    "cp": dict(reconstruction_distribution="constrained poisson"),
    "zinb-cat": dict(reconstruction_distribution=(
        "zero-inflated negative binomial"), number_of_reconstruction_classes=3),
    "poisson-cat": dict(reconstruction_distribution="poisson",
                        number_of_reconstruction_classes=2),
}
GMVAE_CASES = {
    "nb": dict(reconstruction_distribution="negative binomial"),
    "zinb-cat-learn": dict(
        reconstruction_distribution="zero-inflated negative binomial",
        number_of_reconstruction_classes=2, prior_probabilities_method="learn"),
    "poisson-custom": dict(reconstruction_distribution="poisson",
                           prior_probabilities_method="custom",
                           prior_probabilities=(0.5, 0.3, 0.2)),
}


def _wave(scale):
    return lambda a: a + scale * jnp.cos(jnp.arange(a.size).reshape(a.shape))


def _setup(module, seed=0, **kwargs):
    common = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  **kwargs)
    if module is jgmvae:
        common["number_of_latent_clusters"] = K
        jconfig, tconfig = jgmvae.GMVAEConfig(**common), tgmvae.GMVAEConfig(**common)
    else:
        jconfig, tconfig = jvae.VAEConfig(**common), tvae.VAEConfig(**common)
    params, state = module.init(jconfig, jax.random.PRNGKey(seed))
    # non-trivial offsets and batch-norm running statistics
    params = jax.tree_util.tree_map(_wave(0.05), params)
    state = jax.tree_util.tree_map(_wave(0.1), state)
    x = np.random.RandomState(seed).poisson(2.0, (B, F)).astype(np.float32)
    x[1::2] = np.random.RandomState(seed + 1).poisson(4.0, (B // 2, F))
    return jconfig, tconfig, params, state, x


def _port(tree):
    return tparams.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _batch(x, to):
    return {"x": to(x), "t": to(x),
            "count_sum": to(x.sum(-1, keepdims=True).astype(np.float32))}


def _compare(got, want, arrays):
    for key, rtol in arrays:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, atol=1e-6, err_msg=key)
    for key, rtol in (("lower_bound", 2e-4), ("reconstruction_error", 2e-4),
                      ("kl_divergence", 2e-3)):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=rtol, err_msg=key)


RECONSTRUCTION = (("p_x_mean", 1e-4), ("p_x_stddev", 1e-4),
                  ("stddev_of_p_x_given_z_mean", 1e-4))


@pytest.mark.parametrize("case", list(VAE_CASES))
@pytest.mark.parametrize("n_iw", [1, 2])
def test_vae_evaluation_outputs_match_jax(case, n_iw):
    jconfig, tconfig, params, state, x = _setup(jvae, **VAE_CASES[case])
    rng = jax.random.PRNGKey(5)
    want = jvae.evaluation_outputs(jconfig, params, state,
                                   _batch(x, jnp.asarray), rng, n_iw=n_iw)
    noise = np.array(jax.random.normal(jax.random.split(rng, 3)[2],
                                       (n_iw, B, LATENT)))
    got = tvae.evaluation_outputs(tconfig, _port(params), _port(state),
                                  _batch(x, torch.from_numpy), None,
                                  n_iw=n_iw, noise=torch.from_numpy(noise))
    _compare(got, want, RECONSTRUCTION + (("q_z_mean", 1e-5), ("z", 1e-5)))
    assert got["p_x_mean"].shape == (B, F)
    assert got["q_z_mean"].shape == (B, LATENT)


@pytest.mark.parametrize("case", list(GMVAE_CASES))
def test_gmvae_evaluation_outputs_match_jax(case):
    jconfig, tconfig, params, state, x = _setup(jgmvae, **GMVAE_CASES[case])
    rng = jax.random.PRNGKey(6)
    want = jgmvae.evaluation_outputs(jconfig, params, state,
                                     _batch(x, jnp.asarray), rng)
    noise = np.array(jax.random.normal(jax.random.split(rng, 4)[2],
                                       (1, K, B, LATENT)))
    got = tgmvae.evaluation_outputs(tconfig, _port(params), _port(state),
                                    _batch(x, torch.from_numpy), None,
                                    noise=torch.from_numpy(noise))
    _compare(got, want, RECONSTRUCTION + (
        ("q_z_mean", 1e-5), ("z", 1e-5), ("y_probs", 1e-5),
        ("q_y_probabilities", 1e-5)))
    for key in ("kl_divergence_z", "kl_divergence_y"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-3, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["cluster_ids"].numpy(),
                                  np.asarray(want["cluster_ids"]))


def _jax_decode_means(module, jconfig, params, state, z):
    """E[x|z] as the JAX package's ``sample`` computes it; the categorised
    GMVAE's class logits as its ``gmvae.forward`` computes them (its
    ``sample`` cannot: see ``test_categorised_gmvae_sample``)."""
    dec_h, _ = jnetworks.apply_mlp(params["decoder"], state.get("decoder", {}),
                                   z[None], training=False)
    if module is jvae:
        return jvae._build_reconstruction(jconfig, params, dec_h, {"x": z}
                                          ).mean()[0]
    theta = jgmvae._build_theta(jconfig.reconstruction_spec,
                                params["reconstruction"], dec_h)
    p_x = jconfig.reconstruction_spec.build(theta)
    if jconfig.k_max:
        logits = jnetworks.apply_categorised_logits(
            params["categorised_logits"], dec_h)
        p_x = jd.Categorised(dist=p_x, cat=jd.Categorical(logits=logits))
    return p_x.mean()[0]


@pytest.mark.parametrize("case", ["nb", "zinb-cat"])
def test_vae_sample_decode_matches_jax(case):
    jconfig, tconfig, params, state, _ = _setup(jvae, **VAE_CASES[case])
    z = np.random.RandomState(2).randn(40, LATENT).astype(np.float32)
    want = _jax_decode_means(jvae, jconfig, params, state, jnp.asarray(z))
    got = tvae.decode_means(tconfig, _port(params), _port(state),
                            torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("case", list(GMVAE_CASES))
def test_gmvae_sample_matches_jax(case):
    """y by the inverse of the cumulative p(y) at given uniforms, z from
    p(z|y) with the standard-normal draws JAX's ``p_z.sample`` makes from
    its key, then the decoder means."""
    jconfig, tconfig, params, state, _ = _setup(jgmvae, **GMVAE_CASES[case])
    n = 50
    uniforms = np.random.RandomState(3).rand(n).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, (n, K, LATENT)))
    prior_spec = jd.DISTRIBUTIONS[jconfig.z_prior_name]
    p_z = prior_spec.build(jgmvae._build_theta(
        prior_spec, params["p_z"]["heads"], jnp.eye(K, dtype=jnp.float32)))
    z_all = np.asarray(p_z.sample(key, (n,)))  # (N, K, D), JAX's own draw
    probabilities = np.asarray(jax.nn.softmax(jgmvae._p_y_logits(jconfig,
                                                                  params)))
    want_ys = np.minimum(np.searchsorted(np.cumsum(probabilities), uniforms,
                                         side="right"), K - 1)
    ys, z = tgmvae.sample_prior(tconfig, _port(params), n, None,
                                y_uniforms=torch.from_numpy(uniforms),
                                noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(ys.numpy(), want_ys)
    assert len(set(want_ys.tolist())) > 1
    np.testing.assert_allclose(z.numpy(), z_all[np.arange(n), want_ys],
                               rtol=1e-5, atol=1e-6)
    want = _jax_decode_means(jgmvae, jconfig, params, state,
                             jnp.asarray(z.numpy()))
    got = tvae.decode_means(tconfig, _port(params), _port(state), z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_categorised_gmvae_sample(tmp_path):
    """The JAX package's GMVAE ``sample`` applies the class-logit head as a
    dense (H, F·(K+1)) layer (``scvae_tpu/models/gmvae_api.py:653-661``),
    but the head is class-major (K+1, H, F) (``networks.init_categorised_head``),
    so it raises for every categorised GMVAE.  The port decodes the head as
    the JAX forward does, and samples from the same checkpoint."""
    kwargs = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  reconstruction_distribution="negative binomial",
                  number_of_reconstruction_classes=2,
                  number_of_latent_clusters=K, log_directory=str(tmp_path))
    jax_model = JaxGMVAE(**kwargs)
    ts = jax_model._init_state(jax.random.PRNGKey(0))
    jcheckpoints.save_checkpoint(jax_model.log_directory(), ts, epoch=1,
                                 step=0)
    with pytest.raises(ValueError, match="broadcasting"):
        jax_model.sample(5)
    samples = GaussianMixtureVariationalAutoencoder(**kwargs).sample(
        5, device="cpu")
    assert samples.values.shape == (5, F)
    assert np.all(np.isfinite(samples.values)) and np.all(samples.values >= 0)


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_evaluate_and_sample_on_cpu(kind, tmp_path):
    rng = np.random.RandomState(0)
    train, valid = (rng.poisson(2.0, (n, F)).astype(np.float32)
                    for n in (96, 40))
    kwargs = dict(feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
                  reconstruction_distribution="negative binomial",
                  learning_rate=1e-3, log_directory=str(tmp_path))
    if kind == "gmvae":
        model = GaussianMixtureVariationalAutoencoder(
            number_of_latent_clusters=K, **kwargs)
    else:
        model = VariationalAutoencoder(**kwargs)
    result = model.train(train, valid, number_of_epochs=2, minibatch_size=32,
                         device="cpu", verbose=False)
    assert result.best_epoch is not None and not result.stopped_early
    assert len(result.history["validation"]["lower_bound"]) == 2
    directory = model.log_directory()
    assert checkpoints.checkpoint_exists(
        model.log_directory(best_model=True))
    if kind == "gmvae":
        centroids = checkpoints.load_centroids(directory)
        assert centroids["means"].shape == (2, K, LATENT)

    valid_set = DataSet("valid", values=scipy.sparse.csr_matrix(valid),
                        example_names=np.array([f"c{i}" for i in range(40)]))
    subset = indices_for_evaluation_subset(valid_set)
    np.testing.assert_array_equal(subset, jsubset(valid_set))
    transformed, reconstructed, latent = model.evaluate(
        valid_set, minibatch_size=16, use_best_model=True, device="cpu",
        verbose=False)
    assert transformed is valid_set
    assert reconstructed.values.shape == (40, F)
    assert np.all(np.isfinite(reconstructed.values))
    assert np.all(reconstructed.values >= 0)
    assert reconstructed.version == "reconstructed"
    assert list(reconstructed.example_names) == list(valid_set.example_names)
    for stddevs in (reconstructed.total_standard_deviations,
                    reconstructed.explained_standard_deviations):
        assert stddevs.shape == (40, F)
        rows = np.unique(stddevs.nonzero()[0])
        assert set(rows.tolist()) <= set(subset.tolist())
    metrics = model._last_evaluation_metrics
    assert all(np.isfinite(v) for v in metrics.values())
    if kind == "gmvae":
        z_set, y_set = latent["z"], latent["y"]
        assert y_set.values.shape == (40, K) and y_set.version == "y"
        np.testing.assert_allclose(y_set.values.sum(-1), 1.0, rtol=1e-5)
        ids = y_set.values.argmax(-1)
        for data_set in (transformed, reconstructed, z_set, y_set):
            np.testing.assert_array_equal(data_set.predicted_cluster_ids, ids)
    else:
        z_set = latent
    assert z_set.values.shape == (40, LATENT) and z_set.version == "z"

    samples = model.sample(70, minibatch_size=32, device="cpu")
    assert samples.values.shape == (70, F) and samples.kind == "sample"
    assert np.all(np.isfinite(samples.values)) and np.all(samples.values >= 0)
    # a GMVAE labels its samples with their clusters, as JAX's does
    clusters = samples.labels
    if kind == "gmvae":
        assert clusters.shape == (70,)
        assert set(clusters) <= {str(k) for k in range(K)}
    else:
        assert clusters is None
