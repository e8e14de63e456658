"""Device-resident staging in the port against the JAX package's decisions:
the narrowest exact count dtype, which fields may come out of the gather as
bf16, the model's fields (with the per-cell count sums of the constrained
Poisson), and the staged per-row Σ lgamma(1+t) constants (rtol 1e-6: the
same float32 series on both sides, summed in another order), which the
constrained Poisson does not use."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from scvae_tpu.data import dataset as jdataset
from scvae_tpu.data import pipeline as jpipeline
from scvae_tpu.models import api as japi
from scvae_tpu.models import vae as jvae
from scvae_tpu.ops import force_pallas
from scvae_tpu.ops.special import lgamma as jlgamma
from scvae_tpu_torch.data import DataSet, pipeline
from scvae_tpu_torch.models import api
from scvae_tpu_torch.models import vae as tvae

RNG = np.random.RandomState(0)
CASES = {
    "small counts": RNG.poisson(3.0, (40, 12)).astype(np.float32),
    "counts over 256": (RNG.poisson(3.0, (40, 12)) * 100).astype(np.float32),
    "counts over int16": (RNG.poisson(3.0, (40, 12)) * 20_000).astype(np.float32),
    "non-integral": RNG.gamma(2.0, 1.0, (40, 12)).astype(np.float32),
    "sparse counts": scipy.sparse.random(
        40, 12, density=0.2, random_state=1,
        data_rvs=lambda n: RNG.poisson(5.0, n) + 1.0,
    ).tocsr().astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_dtype_and_bf16_fields_match_jax(case):
    values = CASES[case]
    assert pipeline.narrowest_count_dtype(values) == (
        jpipeline.narrowest_count_dtype(values))
    common = dict(feature_size=12, reconstruction_distribution="negative binomial",
                  precision="bfloat16")
    arrays = {"x": values, "t": values}
    with force_pallas():
        ref = japi._bf16_batch_dtypes(arrays, jvae.VAEConfig(**common))
    ours = api._bf16_batch_dtypes(arrays, tvae.VAEConfig(**common), "cpu")
    assert (ours is None) == (ref is None)
    if ref is not None:
        assert set(ours) == set(ref) and set(ours.values()) == {torch.bfloat16}


def test_device_staging_and_row_constants():
    values = CASES["sparse counts"]
    data = pipeline.device_resident_data({"x": values, "t": values},
                                         device="cpu")
    assert data["x"] is data["t"] and data["x"].dtype == torch.int16
    np.testing.assert_array_equal(data["x"].numpy(), values.toarray())
    floats = pipeline.device_resident_data(
        {"x": CASES["non-integral"]}, device="cpu")["x"]
    assert floats.dtype == torch.float32
    config = tvae.VAEConfig(feature_size=12,
                            reconstruction_distribution="negative binomial")
    rowsum = api._append_lgamma_rowsum(data, config, chunk=16)["t_lgamma_rowsum"]
    ref = jnp.sum(jlgamma(1.0 + jnp.asarray(values.toarray())), axis=-1)
    np.testing.assert_allclose(rowsum.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["poisson", "zero-inflated poisson",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
@pytest.mark.parametrize("case", ["small counts", "sparse counts"])
def test_model_arrays_and_row_constants_match_jax(name, case):
    """``build_model_arrays``: the count sums (N, 1) float32 only for the
    constrained Poisson, equal to the JAX ``DataSet.count_sum``; and
    ``_append_lgamma_rowsum`` stages its constants for every likelihood but
    the constrained Poisson, as the JAX package does on its kernel path."""
    values = CASES[case]
    jconfig = jvae.VAEConfig(feature_size=12, reconstruction_distribution=name)
    tconfig = tvae.VAEConfig(feature_size=12, reconstruction_distribution=name)
    assert tconfig.use_count_sum_as_parameter == (
        jconfig.use_count_sum_as_parameter)
    ref = jpipeline.build_model_arrays(
        jdataset.DataSet("test", values=values),
        use_count_sum_as_parameter=jconfig.use_count_sum_as_parameter)
    ours = pipeline.build_model_arrays(
        DataSet("test", values=values), use_count_sum_as_parameter=(
            tconfig.use_count_sum_as_parameter))
    assert set(ours) == set(ref)
    if "count_sum" in ref:
        assert ours["count_sum"].dtype == ref["count_sum"].dtype == np.float32
        np.testing.assert_array_equal(ours["count_sum"], ref["count_sum"])
    data = pipeline.device_resident_data(ours, device="cpu")
    staged = api._append_lgamma_rowsum(data, tconfig)
    with force_pallas():
        ref_staged = japi._append_lgamma_rowsum(
            {k: jnp.asarray(np.asarray(v.todense() if hasattr(v, "todense")
                                       else v)) for k, v in ref.items()},
            jconfig)
    assert ("t_lgamma_rowsum" in staged) == ("t_lgamma_rowsum" in ref_staged)
    assert ("t_lgamma_rowsum" in staged) == (name != "constrained poisson")
