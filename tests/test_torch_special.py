"""The port's series lgamma / digamma against the JAX package's.

Both evaluate the same shift-3 Stirling series in float32, operation for
operation, so they agree to a few float32 ulps: rtol 1e-6, with an absolute
floor of 1e-6 where lgamma crosses zero (x = 1, 2) and the relative error of
any float32 evaluation is unbounded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu.ops import special as jax_special
from scvae_tpu_torch.ops import special

X = np.concatenate([
    np.linspace(0.05, 2.0, 60),
    np.linspace(2.0, 50.0, 60),
    np.geomspace(50.0, 2e4, 30),
    np.arange(1.0, 300.0),  # integer counts + 1, as the likelihoods use
]).astype(np.float32)


@pytest.mark.parametrize("name", ["lgamma", "digamma"])
def test_matches_jax_series(name):
    ours = getattr(special, name)(torch.from_numpy(X)).numpy()
    ref = np.asarray(getattr(jax_special, name)(jnp.asarray(X)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["lgamma", "digamma"])
def test_matches_torch_builtin(name):
    """The series is a faithful lgamma / digamma (float32 arithmetic noise
    at large x, as in ``tests/test_ops.py``)."""
    x = torch.from_numpy(X)
    ours = getattr(special, name)(x)
    ref = getattr(torch, name)(x.double()).float()
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_logaddexp_matches_jax():
    """Finite pairs over a wide range, and the infinities and NaN that the
    zero-inflated likelihoods' t = 0 branch can meet."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-100, 100, 200).astype(np.float32)
    y = rng.uniform(-100, 100, 200).astype(np.float32)
    edges = np.array([-np.inf, np.inf, np.nan, 0.0, -np.inf, 3.0],
                     np.float32)
    x = np.concatenate([x, edges, edges[::-1]])
    y = np.concatenate([y, edges[::-1], edges])
    ours = special.logaddexp(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ref = np.asarray(jnp.logaddexp(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
