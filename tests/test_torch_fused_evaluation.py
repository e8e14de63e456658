"""The per-epoch evaluation on the fused forward (``vae.elbo_terms`` with
``fused_evaluation=True``, which ``VariationalAutoencoder._eval_fn`` takes
on CUDA), run on the CPU through the kernels' plain versions.

For every likelihood with a kernel (the four base families, the
constrained Poisson and a categorised one) and one and two importance
samples, with the staged Σ lgamma(1+t) row constants and without them, the
fused evaluation's metrics against the unfused ``elbo_terms(training=
False)`` from the same parameters and draws: the lower bound and the
reconstruction term within 1e-6 relative, the KL terms equal, and no
reconstruction distribution built.  The choice itself: CUDA alone, and
neither with ``fused_likelihood=False``, nor for a likelihood without a
kernel, nor for a GMVAE; a CPU ``train`` counts its evaluation passes as
``eval.unfused_passes``; the device evaluator forced onto the fused path on
the CPU gives the unfused run's curves and counts ``eval.fused_passes``;
and a gene split's two blocks, with no group, add up to the whole-F
evaluation.  The card's own runs are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from scvae_tpu_torch import (
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch.models import vae
from scvae_tpu_torch.ops import lgamma
from scvae_tpu_torch.parallel import GeneSplit
from scvae_tpu_torch.utils import tracing

F, B = 30, 24
# (likelihood, classes): every likelihood that has a fused kernel
CASES = [
    ("poisson", 0),
    ("negative binomial", 0),
    ("zero-inflated poisson", 0),
    ("zero-inflated negative binomial", 0),
    ("constrained poisson", 0),
    ("zero-inflated negative binomial", 4),
]
BOUND_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _case(name, k_max, staged, seed=0, **options):
    config = vae.VAEConfig(feature_size=F, latent_size=3, hidden_sizes=(16,),
                           reconstruction_distribution=name,
                           number_of_reconstruction_classes=k_max, **options)
    params, state = vae.init(config, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    x = rng.poisson(2.0, (B, F)).astype(np.float32)
    if k_max:  # every other row reaches K: the base branch runs
        x[1::2] = rng.poisson(k_max + 1, (B // 2, F))
    x = torch.from_numpy(x)
    batch = {"x": x, "t": x, "count_sum": x.sum(-1, keepdim=True)}
    if staged:
        batch["t_lgamma_rowsum"] = torch.sum(lgamma(1.0 + x), dim=-1)
    return config, params, state, batch


def _evaluate(config, params, state, batch, n_iw, fused, genes=None):
    return vae.elbo_terms(config, params, state, batch,
                          torch.Generator().manual_seed(7), training=False,
                          n_iw=n_iw, genes=genes, fused_evaluation=fused)


def _relative(got, want) -> float:
    return float(abs(got - want) / abs(want))


@pytest.mark.parametrize("name,k_max", CASES)
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("n_iw", [1, 2])
def test_fused_evaluation_matches_unfused(name, k_max, staged, n_iw):
    config, params, state, batch = _case(name, k_max, staged)
    assert vae.fused_path_enabled(config)
    got, outputs = _evaluate(config, params, state, batch, n_iw, True)
    want, unfused = _evaluate(config, params, state, batch, n_iw, False)
    assert outputs.p_x is None and unfused.p_x is not None
    assert torch.equal(outputs.z, unfused.z)
    for key in ("lower_bound", "lower_bound_weighted",
                "reconstruction_error"):
        assert _relative(got[key], want[key]) <= BOUND_RTOL, key
    for key in ("kl_divergence", "kl_divergence_neurons"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name,options,fused", [
    ("negative binomial", {}, True),
    ("constrained poisson", {}, True),
    ("negative binomial", {"fused_likelihood": False}, False),
    ("gaussian", {}, False),
    ("lomax", {}, False),
])
def test_the_evaluation_takes_the_fused_path_on_cuda_only(name, options,
                                                          fused):
    model = VariationalAutoencoder(feature_size=F, latent_size=3,
                                   hidden_sizes=[16],
                                   reconstruction_distribution=name,
                                   **options)
    assert model._fused_evaluation(torch.device("cuda")) is fused
    assert model._fused_evaluation("cuda") is fused
    assert model._fused_evaluation("cpu") is False
    if not fused:  # asked for, the fused evaluation stays unfused
        config = model.config
        params, state = vae.init(config, torch.Generator().manual_seed(0))
        x = torch.from_numpy(np.random.RandomState(0).poisson(
            2.0, (B, F)).astype(np.float32))
        batch = {"x": x, "t": x}
        got, outputs = _evaluate(config, params, state, batch, 1, True)
        want, _ = _evaluate(config, params, state, batch, 1, False)
        assert outputs.p_x is not None
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_a_gmvae_evaluation_stays_unfused():
    model = GaussianMixtureVariationalAutoencoder(
        feature_size=F, latent_size=3, hidden_sizes=[16],
        number_of_latent_clusters=2,
        reconstruction_distribution="negative binomial")
    assert model._fused_evaluation("cuda") is False


def _model(log_directory, name="negative binomial"):
    return VariationalAutoencoder(
        feature_size=12, latent_size=2, hidden_sizes=[8],
        reconstruction_distribution=name, log_directory=str(log_directory))


def _values(n=96):
    return np.random.RandomState(0).poisson(2.0, (n, 12)).astype(np.float32)


EPOCHS = 2


@pytest.mark.parametrize("placement", ["device", "streaming"])
def test_a_cpu_train_counts_unfused_passes(tmp_path, placement):
    tracing.enable()
    _model(tmp_path).train(
        _values(), _values(40), number_of_epochs=EPOCHS, minibatch_size=32,
        device="cpu", verbose=False, data_placement=placement)
    tracing.disable()
    counters = tracing.counters()
    assert counters.get("eval.unfused_passes") == 2 * EPOCHS
    assert "eval.fused_passes" not in counters


@pytest.mark.parametrize("placement", ["device", "streaming"])
@pytest.mark.parametrize("name", ["negative binomial", "poisson"])
def test_the_fused_device_evaluator_gives_the_unfused_curves(
        tmp_path, monkeypatch, placement, name):
    """``train``'s per-epoch evaluation of the training set (100 rows in
    batches of 32: a remainder batch) and of a validation set, forced onto
    the fused path on the CPU, against the same run unfused: the same
    training, the evaluation curves within 1e-6."""
    curves = {}
    for fused in (False, True):
        monkeypatch.setattr(VariationalAutoencoder, "_fused_evaluation",
                            lambda self, device, fused=fused: fused)
        tracing.reset()
        tracing.enable()
        result = _model(tmp_path / str(fused), name).train(
            _values(100), _values(40), number_of_epochs=EPOCHS,
            minibatch_size=32, device="cpu", verbose=False, seed=0,
            data_placement=placement)
        tracing.disable()
        passes = "eval.fused_passes" if fused else "eval.unfused_passes"
        assert tracing.counters() == {passes: 2 * EPOCHS}
        curves[fused] = result.history
    for subset in ("training", "validation"):
        for key in ("lower_bound", "reconstruction_error", "kl_divergence"):
            got = np.asarray(curves[True][subset][key])
            want = np.asarray(curves[False][subset][key])
            assert got.shape == want.shape == (EPOCHS,)
            assert np.all(np.abs(got - want) <= BOUND_RTOL * np.abs(want)), (
                subset, key)


@pytest.mark.parametrize("name", ["negative binomial",
                                  "zero-inflated poisson"])
def test_gene_blocks_add_up_to_the_whole_evaluation(name):
    """Two gene blocks of F/2 (a ``GeneSplit`` of no group: each block's
    row sums alone, less the whole row constant) against the whole-F fused
    evaluation, one importance sample: the blocks' reconstruction terms
    and the row constant's mean add up to the whole one, and each block's
    KL terms are the whole one's."""
    config, params, state, batch = _case(name, 0, True)
    whole, _ = _evaluate(config, params, state, batch, 1, True)
    total = torch.mean(batch["t_lgamma_rowsum"])
    for split in (GeneSplit(0, 2), GeneSplit(1, 2)):
        cut = {**params, "reconstruction": {
            head: {k: split.block(v).contiguous() for k, v in leaf.items()}
            for head, leaf in params["reconstruction"].items()}}
        block, outputs = _evaluate(config, cut, state, batch, 1, True,
                                   genes=split)
        assert outputs.p_x is None
        for key in ("kl_divergence", "kl_divergence_neurons"):
            assert torch.equal(block[key], whole[key]), key
        total = total + block["reconstruction_error"]
    assert _relative(total, whole["reconstruction_error"]) <= BOUND_RTOL
