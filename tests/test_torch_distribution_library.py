"""The rest of the distribution library against the JAX package's classes on
the same parameters: the log-normal, Bernoulli, gamma, Lomax and
exponentially modified Gaussian; ``fill_triangular`` and the diagonal and
full-covariance multivariate Gaussians; the Gaussian mixture, with stacked
components and with the reconstruction heads' layout; the registry entries
of all of them.  Support edges included, non-finite values too (they must
agree position by position).

Tolerances: rtol 1e-6 (floor 1e-6 · max(1, max|finite reference|)) where
both compute the same float32 formula from the same elementary functions;
rtol 1e-5 where a transcendental function comes from another library
(``erfc`` / ``ndtr`` of the EMG, ``pow`` of the Lomax cdf, the triangular
solve and the matrix products of the multivariate Gaussians).  Samples,
whose draws differ between the frameworks, are held to their moments:
within 5 standard errors over 200,000 draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu import distributions as jd
from scvae_tpu.distributions import normal as jnormal
from scvae_tpu_torch import distributions as td

TINY = float(np.finfo(np.float32).tiny)


def assert_close(ours, ref, rtol=1e-6):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    finite = np.isfinite(ref)
    # NaN, +inf and −inf at the same places
    np.testing.assert_array_equal(np.isfinite(ours), finite)
    np.testing.assert_array_equal(ours[~finite], ref[~finite])
    if finite.any():
        scale = max(1.0, float(np.abs(ref[finite]).max()))
        np.testing.assert_allclose(ours[finite], ref[finite], rtol=rtol,
                                   atol=rtol * scale)


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a, np.float32)) for a in arrays]


def _methods(ours, ref, x, names, rtol=1e-6):
    for name in names:
        if name in ("log_prob", "prob", "cdf", "log_cdf"):
            got = getattr(ours, name)(torch.from_numpy(x))
            want = getattr(ref, name)(jnp.asarray(x))
        else:
            got, want = getattr(ours, name)(), getattr(ref, name)()
        assert_close(got, want, rtol=rtol)


def test_log_normal_matches_jax():
    rng = np.random.RandomState(0)
    loc = rng.uniform(-2, 2, (4, 9)).astype(np.float32)
    scale = np.exp(rng.uniform(-1, 1, (4, 9))).astype(np.float32)
    x = rng.lognormal(0.0, 1.0, (4, 9)).astype(np.float32)
    x[0, :3] = (0.0, -1.0, TINY / 2)  # clamped to tiny before the log
    ours = td.LogNormal(*_t(loc, scale))
    ref = jd.LogNormal(*_j(loc, scale))
    _methods(ours, ref, x, ("log_prob", "prob", "mean", "variance", "stddev",
                            "mode"))


def test_bernoulli_matches_jax():
    rng = np.random.RandomState(1)
    logits = np.concatenate([rng.uniform(-30, 30, (3, 10)),
                             [[-100.0, 100.0, 0.0] + [1.0] * 7]])
    x = rng.randint(0, 2, logits.shape).astype(np.float32)
    ours = td.Bernoulli(*_t(logits))
    ref = jd.Bernoulli(*_j(logits))
    _methods(ours, ref, x, ("log_prob", "prob", "mean", "variance", "mode"))


def test_gamma_matches_jax_at_the_support_edge():
    """x = 0: xlogy(a − 1, 0) is −inf for a > 1, +inf for a < 1 and 0 for
    a = 1 in both packages."""
    rng = np.random.RandomState(2)
    a = np.exp(rng.uniform(-2, 2, (3, 8))).astype(np.float32)
    a[0, :3] = (0.5, 1.0, 2.0)
    b = np.exp(rng.uniform(-2, 2, (3, 8))).astype(np.float32)
    x = rng.gamma(2.0, 1.0, (3, 8)).astype(np.float32)
    x[0, :3] = 0.0
    ours = td.Gamma(*_t(a, b))
    ref = jd.Gamma(*_j(a, b))
    _methods(ours, ref, x, ("log_prob", "mean", "variance", "mode"))
    lp = ours.log_prob(torch.from_numpy(x))[0, :3].numpy()
    assert lp[0] == np.inf and np.isfinite(lp[1]) and lp[2] == -np.inf


def test_lomax_matches_jax():
    """The mean is NaN for α ≤ 1, the variance NaN for α ≤ 1 and inf for
    1 < α ≤ 2; the variance is the corrected λ²α/((α−1)²(α−2))."""
    rng = np.random.RandomState(3)
    a = np.exp(rng.uniform(-1, 2, (3, 8))).astype(np.float32)
    a[0, :3] = (0.5, 1.5, 3.0)
    lam = np.exp(rng.uniform(-1, 1, (3, 8))).astype(np.float32)
    x = rng.exponential(1.0, (3, 8)).astype(np.float32)
    x[1, 0] = 0.0
    ours = td.Lomax(*_t(a, lam))
    ref = jd.Lomax(*_j(a, lam))
    _methods(ours, ref, x, ("log_prob", "mean", "variance", "mode"))
    _methods(ours, ref, x, ("cdf", "log_cdf"), rtol=1e-5)
    var = ours.variance()[0, :3].numpy()
    assert np.isnan(var[0]) and var[1] == np.inf
    np.testing.assert_allclose(var[2], lam[0, 2] ** 2 * 3.0 / (4.0 * 1.0),
                               rtol=1e-6)


def test_exponentially_modified_normal_matches_jax():
    """Far in the right tail erfc underflows: both clip it to tiny, so
    log_prob is finite there and its gradient too."""
    rng = np.random.RandomState(4)
    loc = rng.uniform(-1, 1, (3, 8)).astype(np.float32)
    scale = np.exp(rng.uniform(-1, 1, (3, 8))).astype(np.float32)
    rate = np.exp(rng.uniform(-1, 1, (3, 8))).astype(np.float32)
    x = (loc + rng.randn(3, 8) + rng.exponential(1.0, (3, 8))).astype(
        np.float32)
    x[0, :2] = (-50.0, 1e4)  # erfc → 2 and erfc → 0 (clipped)
    ours = td.ExponentiallyModifiedNormal(*_t(loc, scale, rate))
    ref = jd.ExponentiallyModifiedNormal(*_j(loc, scale, rate))
    _methods(ours, ref, x, ("log_prob", "cdf"), rtol=1e-5)
    _methods(ours, ref, x, ("mean", "variance"))
    params = [p.requires_grad_(True) for p in _t(loc, scale, rate)]
    lp = td.ExponentiallyModifiedNormal(*params).log_prob(torch.from_numpy(x))
    grads = torch.autograd.grad(lp.sum(), params)
    assert all(torch.isfinite(g).all() for g in grads)


def test_fill_triangular_matches_jax():
    for m in (1, 3, 6):
        x = np.random.RandomState(m).randn(2, 5, m * (m + 1) // 2)
        ours = td.fill_triangular(*_t(x), m)
        ref = jnormal.fill_triangular(*_j(x), m)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert np.all(np.triu(ours.numpy(), 1) == 0)
    with pytest.raises(ValueError):
        td.fill_triangular(torch.zeros(5), 3)


def _tril(rng, shape, m):
    scales = np.exp(rng.uniform(-0.5, 0.5, shape + (m * (m + 1) // 2,)))
    return np.asarray(jnormal.fill_triangular(
        jnp.asarray(scales.astype(np.float32)), m))


def test_multivariate_normals_match_jax():
    """Full covariance with the parameters of a GMVAE's posterior (K, B, m)
    and prior (K, 1, m) against samples (S, K, B, m); the diagonal one on
    the same locations."""
    rng = np.random.RandomState(5)
    k, b, m, s = 3, 4, 5, 2
    loc = rng.randn(k, b, m).astype(np.float32)
    tril = _tril(rng, (k, b), m)
    prior_loc = rng.randn(k, 1, m).astype(np.float32)
    prior_tril = _tril(rng, (k, 1), m)
    z = rng.randn(s, k, b, m).astype(np.float32)
    for args in ((loc, tril), (prior_loc, prior_tril)):
        ours = td.MultivariateNormalTriL(*_t(*args))
        ref = jd.MultivariateNormalTriL(*_j(*args))
        _methods(ours, ref, z, ("log_prob",), rtol=1e-5)
        _methods(ours, ref, z, ("mean", "covariance", "variance", "mode"),
                 rtol=1e-5)
        # the sample: loc + L ε on the same ε
        noise = rng.randn(s, *ref.mean().shape).astype(np.float32)
        want = np.asarray(ref.loc) + np.einsum("...ij,...j->...i",
                                               np.asarray(ref.scale_tril),
                                               noise)
        assert_close(ours.sample(None, (s,), noise=torch.from_numpy(noise)),
                     want, rtol=1e-5)
    scale_diag = np.exp(rng.uniform(-1, 1, (k, b, m))).astype(np.float32)
    ours = td.MultivariateNormalDiag(*_t(loc, scale_diag))
    ref = jd.MultivariateNormalDiag(*_j(loc, scale_diag))
    _methods(ours, ref, z, ("log_prob", "mean", "variance", "covariance",
                            "stddev"))


@pytest.mark.parametrize("layout", ["stacked", "heads"])
def test_gaussian_mixture_matches_jax(layout):
    """``stacked``: K components (K, B, D) with weights (B, K), as a latent
    mixture; ``heads``: the reconstruction's layout, every parameter
    (S, B, F) from a head, where the weights' axis is the features and the
    components broadcast over it (see ``distributions/mixture.py``)."""
    rng = np.random.RandomState(6)
    if layout == "stacked":
        logits = rng.randn(4, 3)
        means = rng.randn(3, 4, 5)
        log_sigmas = rng.uniform(-1, 1, (3, 4, 5))
        x = rng.randn(4, 5)
    else:
        logits = rng.randn(2, 4, 6)
        means = rng.randn(2, 4, 6)
        log_sigmas = rng.uniform(-1, 1, (2, 4, 6))
        x = rng.poisson(2.0, (4, 6))
    ours = td.GaussianMixture(*_t(logits, means, np.exp(log_sigmas)))
    ref = jd.GaussianMixture(*_j(logits, means, np.exp(log_sigmas)))
    _methods(ours, ref, x.astype(np.float32), ("log_prob", "mean",
                                               "variance"), rtol=1e-5)


def _moments(samples, mean, variance, n):
    samples = samples.double()
    se = torch.sqrt(variance.double() / n)
    assert torch.all(torch.abs(samples.mean(0) - mean.double()) <= 5 * se)


def test_samples_have_the_moments():
    n = 200_000
    g = torch.Generator().manual_seed(0)
    cases = [
        td.Bernoulli(torch.tensor([-1.0, 0.5])),
        td.Gamma(torch.tensor([0.7, 3.0]), torch.tensor([2.0, 0.5])),
        td.Lomax(torch.tensor([5.0, 9.0]), torch.tensor([1.0, 2.0])),
        td.ExponentiallyModifiedNormal(torch.tensor([0.0, 1.0]),
                                       torch.tensor([1.0, 0.5]),
                                       torch.tensor([2.0, 0.7])),
        td.LogNormal(torch.tensor([0.0, -1.0]), torch.tensor([0.5, 0.3])),
        td.GaussianMixture(torch.tensor([[0.0, 1.0]]),
                           torch.tensor([[[-2.0, 0.0]], [[3.0, 1.0]]]),
                           torch.tensor([[[1.0, 0.5]], [[0.2, 2.0]]])),
    ]
    for dist in cases:
        samples = dist.sample(g, (n,))
        assert samples.shape == (n,) + tuple(dist.mean().shape)
        _moments(samples, dist.mean(), dist.variance(), n)


NEW = ("multivariate gaussian", "gaussian mixture", "log-normal",
       "exponentially_modified_gaussian", "gamma", "bernoulli", "lomax")


@pytest.mark.parametrize("name", NEW)
def test_registry_build_matches_jax(name):
    """Heads → activation and clip → build → log_prob, mean and variance,
    with the multivariate Gaussian's scales head F(F+1)/2 wide."""
    rng = np.random.RandomState(7)
    f = 6
    j_spec, t_spec = jd.DISTRIBUTIONS[name], td.DISTRIBUTIONS[name]
    assert list(t_spec.parameters) == list(j_spec.parameters)
    raw = {}
    for param, spec in j_spec.parameters.items():
        width = spec.size_fn(f)
        assert td.DISTRIBUTIONS[name].parameters[param].size_fn(f) == width
        raw[param] = rng.uniform(-3, 3, (2, 5, width)).astype(np.float32)
    x = rng.poisson(2.0, (5, f)).astype(np.float32) + (name == "gamma")
    if name == "bernoulli":
        x = np.minimum(x, 1.0)
    ref = j_spec.build({k: j_spec.parameters[k].constrain(jnp.asarray(v))
                        for k, v in raw.items()})
    ours = t_spec.build({k: t_spec.parameters[k].constrain(torch.from_numpy(v))
                         for k, v in raw.items()})
    rtol = 1e-6 if name in ("log-normal", "gamma", "bernoulli") else 1e-5
    _methods(ours, ref, x, ("log_prob", "mean", "variance"), rtol=rtol)
    assert t_spec.event == (name in ("multivariate gaussian",
                                     "gaussian mixture"))
