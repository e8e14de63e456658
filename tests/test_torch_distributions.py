"""The port's distributions against the JAX package's on the same inputs:
support clipping (with its zero gradient outside the support), Poisson, NB,
their zero-inflated forms, the constrained-Poisson composition and Normal
log_prob / mean / variance, the analytic Normal KL, and name parsing.  Both
compute the same float32 formulas: rtol 1e-6 with an absolute floor of
1e-6 · max(1, max|reference|) for values near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu import distributions as jd
from scvae_tpu_torch import distributions as td


def assert_close(ours, ref, rtol=1e-6):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=rtol, atol=rtol * max(1.0, float(np.abs(ref).max()))
    )


@pytest.mark.parametrize(
    "dist,param",
    [("negative binomial", "p"), ("negative binomial", "log_r"),
     ("gaussian", "log_sigma"), ("gaussian", "mu"),
     ("poisson", "log_lambda"), ("zero-inflated poisson", "pi"),
     ("zero-inflated negative binomial", "pi"),
     ("constrained poisson", "lambda")],
)
def test_constrain_and_gradient(dist, param):
    raw = np.concatenate([
        np.linspace(-40.0, 40.0, 161), [-1e30, 1e30, 0.0]
    ]).astype(np.float32)
    j_spec = jd.DISTRIBUTIONS[dist].parameters[param]
    t_spec = td.DISTRIBUTIONS[dist].parameters[param]
    x = torch.from_numpy(raw).requires_grad_(True)
    ours = t_spec.constrain(x)
    (grad,) = torch.autograd.grad(ours.sum(), x)
    ref = j_spec.constrain(jnp.asarray(raw))
    ref_grad = jax.grad(lambda r: jnp.sum(j_spec.constrain(r)))(jnp.asarray(raw))
    assert_close(ours, ref)
    assert_close(grad, ref_grad)
    lo, hi = t_spec.support
    value = ours.detach().numpy()
    assert np.all(value > np.float32(lo)) and np.all(value < np.float32(hi))
    # zero gradient wherever the clip is active
    clipped = (value == value.min()) | (value == value.max())
    if dist == "negative binomial":
        assert np.all(grad.numpy()[clipped & (np.abs(raw) > 20)] == 0.0)


def _nb_case(seed=0, shape=(7, 40)):
    rng = np.random.RandomState(seed)
    r = np.exp(rng.uniform(-3, 3, shape)).astype(np.float32)
    p = rng.uniform(0.01, 0.99, shape).astype(np.float32)
    x = rng.poisson(3.0, shape).astype(np.float32)
    return r, p, x


def test_negative_binomial_matches_jax():
    r, p, x = _nb_case()
    ours = td.NegativeBinomial(torch.from_numpy(r), torch.from_numpy(p))
    ref = jd.NegativeBinomial(total_count=jnp.asarray(r), probs=jnp.asarray(p))
    assert_close(ours.log_prob(torch.from_numpy(x)), ref.log_prob(jnp.asarray(x)))
    assert_close(ours.mean(), ref.mean())
    assert_close(ours.variance(), ref.variance())


def _assert_same(ours, ref, x):
    assert_close(ours.log_prob(torch.from_numpy(x)), ref.log_prob(jnp.asarray(x)))
    assert_close(ours.mean(), ref.mean())
    assert_close(ours.variance(), ref.variance())


def test_poisson_matches_jax():
    rng = np.random.RandomState(2)
    log_rate = rng.uniform(-10, 10, (7, 40)).astype(np.float32)
    x = rng.poisson(3.0, (7, 40)).astype(np.float32)  # zeros included
    _assert_same(td.Poisson(torch.from_numpy(log_rate)),
                 jd.Poisson(log_rate=jnp.asarray(log_rate)), x)


def _clip_edges(values, lo, hi):
    """The first columns at the clip edges of a support."""
    values[:, 0], values[:, 1] = lo, hi
    return values


@pytest.mark.parametrize("base", ["poisson", "negative binomial"])
def test_zero_inflated_matches_jax(base):
    """t = 0 and t > 0 branches, with π, p and log r at their clip edges."""
    from scvae_tpu.distributions.zero_inflated import ZeroInflated

    tiny = float(np.finfo(np.float32).tiny)
    p_hi = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    l_lo = float(np.nextafter(np.float32(-10.0), np.float32(np.inf)))
    l_hi = float(np.nextafter(np.float32(10.0), np.float32(-np.inf)))
    r, p, x = _nb_case(seed=3)
    rng = np.random.RandomState(4)
    pi = _clip_edges(rng.uniform(0.01, 0.99, r.shape).astype(np.float32),
                     tiny, p_hi)
    x[::2] = 0.0
    if base == "poisson":
        log_rate = _clip_edges(rng.uniform(-10, 10, r.shape).astype(np.float32),
                               l_lo, l_hi)
        ours = td.ZeroInflated(td.Poisson(torch.from_numpy(log_rate)),
                               torch.from_numpy(pi))
        ref = ZeroInflated(dist=jd.Poisson(log_rate=jnp.asarray(log_rate)),
                           pi=jnp.asarray(pi))
    else:
        r = _clip_edges(r, float(np.exp(np.float32(l_lo))),
                        float(np.exp(np.float32(l_hi))))
        p = _clip_edges(p, tiny, p_hi)
        ours = td.ZeroInflated(
            td.NegativeBinomial(torch.from_numpy(r), torch.from_numpy(p)),
            torch.from_numpy(pi))
        ref = ZeroInflated(
            dist=jd.NegativeBinomial(total_count=jnp.asarray(r),
                                     probs=jnp.asarray(p)),
            pi=jnp.asarray(pi))
    _assert_same(ours, ref, x)


@pytest.mark.parametrize("name", ["poisson", "zero-inflated poisson",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
def test_registry_build_matches_jax(name):
    """Heads → constrain → build (with the count sum for the constrained
    Poisson: Poisson(log(clip(softmax(a))·n))) → log_prob."""
    rng = np.random.RandomState(6)
    raw = {param: rng.uniform(-15, 15, (5, 30)).astype(np.float32)
           for param in jd.DISTRIBUTIONS[name].parameters}
    x = rng.poisson(2.0, (5, 30)).astype(np.float32)
    count_sum = (x.sum(-1, keepdims=True) + 1.0).astype(np.float32)
    j_spec, t_spec = jd.DISTRIBUTIONS[name], td.DISTRIBUTIONS[name]
    assert t_spec.uses_count_sum == j_spec.uses_count_sum
    assert list(t_spec.parameters) == list(j_spec.parameters)
    ref = j_spec.build(
        {k: j_spec.parameters[k].constrain(jnp.asarray(v)) for k, v in raw.items()},
        count_sum=jnp.asarray(count_sum))
    ours = t_spec.build(
        {k: t_spec.parameters[k].constrain(torch.from_numpy(v))
         for k, v in raw.items()},
        count_sum=torch.from_numpy(count_sum))
    assert_close(ours.log_prob(torch.from_numpy(x)),
                 ref.log_prob(jnp.asarray(x)))


def test_normal_matches_jax():
    rng = np.random.RandomState(1)
    loc = rng.randn(5, 3).astype(np.float32)
    scale = np.exp(rng.uniform(-2, 2, (5, 3))).astype(np.float32)
    z = rng.randn(2, 5, 3).astype(np.float32)
    ours = td.Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    ref = jd.Normal(loc=jnp.asarray(loc), scale=jnp.asarray(scale))
    assert_close(ours.log_prob(torch.from_numpy(z)), ref.log_prob(jnp.asarray(z)))
    assert_close(ours.mean(), ref.mean())
    assert_close(ours.variance(), ref.variance())
    noise = rng.randn(2, 5, 3).astype(np.float32)
    sample = ours.sample(None, (2,), noise=torch.from_numpy(noise))
    assert_close(sample, loc + scale * noise)
    prior_t = td.Normal(torch.zeros(()), torch.ones(()))
    prior_j = jd.Normal(loc=jnp.zeros(()), scale=jnp.ones(()))
    assert_close(td.kl_divergence(ours, prior_t), jd.kl_divergence(ref, prior_j))


def test_parse_distribution():
    for alias in ("negative binomial", "Negative-Binomial", "negative_binomial"):
        assert td.parse_distribution(alias) == jd.parse_distribution(alias)
    for alias in ("gaussian", "unit-variance gaussian"):
        assert td.parse_distribution(alias, "VAE") == jd.parse_distribution(
            alias, "VAE")
    for alias in ("poisson", "Zero-Inflated Poisson", "constrained_poisson",
                  "zero-inflated negative binomial"):
        assert td.parse_distribution(alias) == jd.parse_distribution(alias)
    for alias in ("bernoulli", "Multivariate Gaussian", "gaussian_mixture",
                  "log-normal", "exponentially modified gaussian", "gamma",
                  "lomax"):
        assert td.parse_distribution(alias) == jd.parse_distribution(alias)
    assert list(td.DISTRIBUTIONS) == list(jd.DISTRIBUTIONS)
    for alias in ("gaussian mixture", "legacy gaussian mixture",
                  "full-covariance gaussian mixture"):
        assert td.parse_distribution(alias, "GMVAE") == jd.parse_distribution(
            alias, "GMVAE")
    assert list(td.GAUSSIAN_MIXTURE_DISTRIBUTIONS) == list(
        jd.GAUSSIAN_MIXTURE_DISTRIBUTIONS)
    with pytest.raises(ValueError):
        td.parse_distribution("no such distribution")
