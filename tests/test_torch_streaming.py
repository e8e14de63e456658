"""The streaming path of the port against the JAX package, on the CPU.

* ``BatchPipeline`` against JAX's on the same arrays and seed, its batches
  turned to numpy and compared exactly: the batch order over two epochs
  (an int32 field of row numbers rides along), the dense values and their
  wire dtypes, the CSR wire's capacity, ``data``, ``cols`` and ``rows``,
  the "auto" decision on each side of its density rule, the dense fallback
  of a batch built to overflow the capacity, ``drop_remainder``, a field
  shared by ``x`` and ``t`` built once;
* ``materialize_batch`` of JAX's wire arrays against JAX's, exactly,
  padding and a shorter last batch included;
* ``_choose_device_placement`` against JAX's on counts, on counts with
  float preprocessed values (4 bytes an entry, though the counts fit in
  2) and the path ``train`` takes, noisy preprocessing streaming in both;
* noisy preprocessing: after ``np.random.seed(s)`` the per-epoch training
  arrays (and the full training-set evaluation's) equal JAX's;
* streaming training of the golden configurations (VAE-NB, GMVAE-NB with
  3 clusters) for three epochs on the development split from JAX's initial
  weights and JAX's z draws, substituted as in ``tests/test_torch_golden.
  py``: the curves within rtol 1e-3 of JAX's streaming run (the VAE's
  lower bounds for the epoch before it parts from JAX's run, as the
  golden test's device run parts, and for all three epochs with the
  leaves that drive that parting frozen), the GMVAE's accuracies within
  0.01; on the port's own draws, streaming and device runs give finite
  curves;
* ``caches_directory``: the run's files end in the permanent directory, the
  scratch copy is gone, a second ``train`` resumes from the permanent copy;
* ``evaluate`` through the pipeline (a sparse set on the CSR wire with a
  shorter last batch) on a checkpoint the JAX package wrote, against JAX's
  ``evaluate`` on JAX's z draws: the latent means (no noise) rtol 1e-5,
  the ELBO and reconstruction term rtol 2e-4 and the KL terms 2e-3, as in
  ``tests/test_torch_evaluate.py``; the reconstruction means and the
  subset's standard deviations rtol 1e-3, not that file's 1e-4: both
  packages compute NB's mean as r·p/(1 − p) in float32, which multiplies
  the rounding of p by p/(1 − p), and the trained model here has p near 1
  in places (a mean of 316 reads 2.7e-4 apart, every other element under
  2.3e-5).
"""

import collections
import os

import jax
import numpy as np
import pytest
import scipy.sparse
import torch

from scvae_tpu.data import DataSet as JaxDataSet
from scvae_tpu.data import pipeline as jpipeline
from scvae_tpu.models import api as japi
from scvae_tpu.models import step as jstep
from scvae_tpu.models import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
    VariationalAutoencoder as JaxVAE,
)
from scvae_tpu_torch import (
    DataSet,
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.data import pipeline
from scvae_tpu_torch.distributions.normal import Normal
from scvae_tpu_torch.models import api, naming
from scvae_tpu_torch.models import step as tstep

COUNT_DTYPES = (np.int16, np.int32)


def _counts(n, f, density, seed=0):
    """Poisson(3) + 1 counts at ``density``, CSR float32."""
    rng = np.random.RandomState(seed)
    dense = (rng.poisson(3.0, (n, f)) + 1) * (rng.uniform(size=(n, f))
                                              < density)
    return scipy.sparse.csr_matrix(dense.astype(np.float32))


def _arrays(values, shared=True):
    """x and t (one object, or two equal ones) and the row numbers."""
    rows = np.arange(values.shape[0], dtype=np.int32)[:, None]
    t = values if shared else values.copy()
    return {"x": values, "t": t, "row": rows}


def _numpy(array):
    return array.numpy() if isinstance(array, torch.Tensor) else (
        np.asarray(array))


def _as_numpy(value):
    """(kind, dense shape, arrays) of a batch field of either package."""
    if isinstance(value, (jpipeline.CSRWire, pipeline.CSRWire)):
        return ("wire", value.shape,
                [_numpy(getattr(value, k)) for k in ("data", "cols", "rows")])
    return "dense", None, [_numpy(value)]


def _assert_same_epochs(jax_pipeline, port_pipeline, epochs=2):
    """Every batch of ``epochs`` epochs equal field by field, in dtype
    and in which fields share an object; returns the count of each
    field's (name, kind)."""
    kinds = collections.Counter()
    for _ in range(epochs):
        want = list(jax_pipeline.epoch())
        got = list(port_pipeline.epoch())
        assert len(got) == len(want) == jax_pipeline.batches_per_epoch()
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for name in w:
                (kind, shape, arrays), (kind_w, shape_w, arrays_w) = (
                    _as_numpy(g[name]), _as_numpy(w[name]))
                assert (kind, shape) == (kind_w, shape_w), name
                for a, b in zip(arrays, arrays_w, strict=True):
                    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
                    np.testing.assert_array_equal(a, b, err_msg=name)
                kinds[(name, kind)] += 1
            assert (g["x"] is g["t"]) == (w["x"] is w["t"])
    return kinds


@pytest.mark.parametrize("case, kwargs, density", [
    ("auto-wire", dict(wire_format="auto"), 0.07),
    ("csr-dense-data", dict(wire_format="csr"), 0.5),
    ("dense", dict(wire_format="dense"), 0.07),
    ("drop-remainder", dict(drop_remainder=True), 0.07),
    ("no-count-dtype", dict(count_dtype=None), 0.07),
    ("unshuffled", dict(shuffle=False, prefetch=0), 0.07),
])
def test_pipeline_matches_jax(case, kwargs, density):
    values = _counts(203, 40, density, seed=1)
    options = dict(dict(seed=3, count_dtype=COUNT_DTYPES), **kwargs)
    arrays = _arrays(values)
    jax_pipeline = jpipeline.BatchPipeline(arrays, 32, **options)
    port_pipeline = pipeline.BatchPipeline(arrays, 32, device="cpu",
                                           **options)
    assert port_pipeline._csr_wire == jax_pipeline._csr_wire
    assert port_pipeline._wire_dtypes == jax_pipeline._wire_dtypes
    kinds = _assert_same_epochs(jax_pipeline, port_pipeline)
    wire = case in ("auto-wire", "csr-dense-data", "drop-remainder",
                    "unshuffled")
    assert bool(kinds[("x", "wire")]) == wire
    if wire:
        assert port_pipeline._csr_wire["x"]["capacity"] % 1024 == 0


def test_pipeline_unshared_and_float_fields_match_jax():
    values = _counts(150, 24, 0.1, seed=2)
    floats = np.random.RandomState(0).gamma(2.0, 1.0, (150, 24)).astype(
        np.float64)
    for arrays in (_arrays(values, shared=False),
                   {"x": floats, "t": floats, "row": _arrays(values)["row"],
                    "count_sum": floats.sum(1, keepdims=True)}):
        options = dict(seed=0, count_dtype=COUNT_DTYPES)
        _assert_same_epochs(jpipeline.BatchPipeline(arrays, 64, **options),
                            pipeline.BatchPipeline(arrays, 64, device="cpu",
                                                   **options))


@pytest.mark.parametrize("density, wire", [(0.15, True), (0.18, False)])
def test_auto_wire_rule_matches_jax(density, wire):
    """int16 data, columns and rows: 6 bytes an entry against 2 dense, so
    "auto" takes the wire below a density of 1/6."""
    values = _counts(400, 60, density, seed=4)
    assert abs(values.nnz / (400 * 60) - density) < 0.01
    options = dict(seed=0, count_dtype=COUNT_DTYPES, wire_format="auto")
    arrays = _arrays(values)
    jax_pipeline = jpipeline.BatchPipeline(arrays, 50, **options)
    port_pipeline = pipeline.BatchPipeline(arrays, 50, device="cpu",
                                           **options)
    assert port_pipeline._csr_wire == jax_pipeline._csr_wire
    assert bool(port_pipeline._csr_wire) == wire
    _assert_same_epochs(jax_pipeline, port_pipeline, epochs=1)


def test_overflowing_batch_goes_dense_as_in_jax():
    """16 full rows first, then rows of 2 entries: unshuffled, the first
    batch of 16 holds 3,200 entries against a capacity of 1,024 and goes
    dense; the others ship the wire."""
    dense = np.zeros((256, 200), np.float32)
    dense[:16] = 1 + np.random.RandomState(0).poisson(3.0, (16, 200))
    dense[16:, :2] = 5
    values = scipy.sparse.csr_matrix(dense)
    options = dict(shuffle=False, count_dtype=COUNT_DTYPES,
                   wire_format="csr")
    arrays = _arrays(values)
    jax_pipeline = jpipeline.BatchPipeline(arrays, 16, **options)
    port_pipeline = pipeline.BatchPipeline(arrays, 16, device="cpu",
                                           **options)
    assert port_pipeline._csr_wire["x"]["capacity"] == 1024
    kinds = _assert_same_epochs(jax_pipeline, port_pipeline, epochs=1)
    assert kinds[("x", "dense")] == 1 and kinds[("x", "wire")] == 15
    first = next(port_pipeline.epoch())
    assert first["x"].dtype == torch.int16
    np.testing.assert_array_equal(first["x"].numpy(), dense[:16])


@pytest.mark.parametrize("shared", [True, False])
def test_materialize_matches_jax(shared):
    values = _counts(75, 33, 0.1, seed=5)
    batches = list(jpipeline.BatchPipeline(
        _arrays(values, shared), 32, seed=1, count_dtype=COUNT_DTYPES,
        wire_format="csr").epoch())
    assert [b["x"].n_rows for b in batches] == [32, 32, 11]
    for batch in batches:
        want = jstep.materialize_batch(batch)
        port, made = {}, {}
        for name, value in batch.items():
            if id(value) not in made:
                made[id(value)] = (pipeline.CSRWire(
                    *(torch.tensor(np.asarray(getattr(value, k)))
                      for k in ("data", "cols", "rows")),
                    value.n_rows, value.n_cols)
                    if isinstance(value, jpipeline.CSRWire)
                    else torch.tensor(np.asarray(value)))
            port[name] = made[id(value)]
        # the padding entries point one row past the batch
        assert int(port["x"].rows.max()) == port["x"].n_rows
        got = tstep.materialize_batch(port)
        assert (got["x"] is got["t"]) == shared
        for name in ("x", "t"):
            assert got[name].dtype == torch.float32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_materialize_adds_duplicate_entries():
    """A non-canonical wire's repeated (row, column) entries add, as JAX's
    scatter adds them."""
    data = np.array([1, 2, 3, 0], np.int16)
    cols = np.array([4, 4, 1, 0], np.int16)
    rows = np.array([0, 0, 1, 2], np.int16)  # the last is padding
    wire = jpipeline.CSRWire(data, cols, rows, 2, 6)
    want = np.asarray(jstep.materialize_batch({"x": wire})["x"])
    got = tstep.materialize_batch({"x": pipeline.CSRWire(
        *map(torch.from_numpy, (data, cols, rows)), 2, 6)})["x"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 4] == 3


def _placement_sets(case):
    counts = _counts(300, 50, 0.3, seed=6)  # int16 counts: 30,000 bytes
    extra = {}
    if case == "log":
        extra["preprocessed_values"] = counts.log1p()  # float: 60,000
    if case == "noisy":
        extra["noisy_preprocessing_methods"] = ["normalise", "binarise"]
    return (JaxDataSet("in-memory", values=counts, **extra),
            DataSet("in-memory", values=counts, **extra))


@pytest.mark.parametrize("case", ["counts", "log", "noisy"])
def test_choose_device_placement_matches_jax(case):
    jax_set, port_set = _placement_sets(case)
    kwargs = dict(feature_size=50, latent_size=2, hidden_sizes=[8])
    jax_model, model = JaxVAE(**kwargs), VariationalAutoencoder(**kwargs)
    for budget in (29_999, 30_000, 45_000, 59_999, 60_000):
        jax_model.DEVICE_DATA_BUDGET_BYTES = budget
        model.DEVICE_DATA_BUDGET_BYTES = budget
        for placement in ("auto", "device", "streaming"):
            assert model._choose_device_placement(port_set, placement) == (
                jax_model._choose_device_placement(jax_set, placement)), (
                    budget, placement)
    for chooser, data_set in ((model, port_set), (jax_model, jax_set)):
        with pytest.raises(ValueError, match="auto, device, or streaming"):
            chooser._choose_device_placement(data_set, "host")


@pytest.mark.parametrize("case, staged", [("counts", True), ("log", False),
                                          ("noisy", False)])
def test_train_takes_jax_path(case, staged, tmp_path, monkeypatch):
    """Under a budget of 45,000 bytes the int16 counts (30,000) are staged,
    their float preprocessed values (60,000) stream, as does any set with
    noisy preprocessing: in both packages."""
    jax_set, port_set = _placement_sets(case)
    calls = {"jax": 0, "port": 0}

    def counting(side, function):
        def staged_on_device(*args, **kwargs):
            calls[side] += 1
            return function(*args, **kwargs)
        return staged_on_device

    monkeypatch.setattr(jpipeline, "device_resident_data",
                        counting("jax", jpipeline.device_resident_data))
    monkeypatch.setattr(api, "device_resident_data",
                        counting("port", api.device_resident_data))
    kwargs = dict(feature_size=50, latent_size=2, hidden_sizes=[8],
                  reconstruction_distribution=(
                      "bernoulli" if case == "noisy" else "poisson"))
    for side, model_class, data_set in (("jax", JaxVAE, jax_set),
                                        ("port", VariationalAutoencoder,
                                         port_set)):
        model = model_class(log_directory=str(tmp_path / side), **kwargs)
        model.DEVICE_DATA_BUDGET_BYTES = 45_000
        extra = {} if side == "jax" else {"device": "cpu"}
        result = model.train(data_set, number_of_epochs=1, minibatch_size=64,
                             full_train_evaluation=False, verbose=False,
                             **extra)
        assert np.isfinite(result.history["training"]["lower_bound"]).all()
    assert calls == {"jax": int(staged), "port": int(staged)}


def _recording(monkeypatch, module, seen):
    """Record the x of every pipeline ``module`` builds."""
    class Recording(module.BatchPipeline):
        def __init__(self, arrays, *args, **kwargs):
            seen.append(arrays["x"])
            super().__init__(arrays, *args, **kwargs)

    monkeypatch.setattr(module, "BatchPipeline", Recording)


def test_noisy_arrays_match_jax(tmp_path, monkeypatch):
    """Each training epoch and each full training-set evaluation draws new
    binarised values from numpy's global generator, in the same order in
    both packages; the validation set draws nothing."""
    counts = _counts(120, 30, 0.3, seed=7)
    methods = ["normalise", "binarise"]
    seen = {"jax": [], "port": []}
    _recording(monkeypatch, japi, seen["jax"])
    _recording(monkeypatch, api, seen["port"])
    kwargs = dict(feature_size=30, latent_size=2, hidden_sizes=[8],
                  reconstruction_distribution="bernoulli")
    for side, model_class, set_class, extra in (
            ("jax", JaxVAE, JaxDataSet, {}),
            ("port", VariationalAutoencoder, DataSet, {"device": "cpu"})):
        training_set = set_class("in-memory", values=counts,
                                 noisy_preprocessing_methods=methods)
        validation_set = set_class("in-memory", values=counts[:40])
        np.random.seed(11)
        model_class(log_directory=str(tmp_path / side), **kwargs).train(
            training_set, validation_set, number_of_epochs=2,
            minibatch_size=32, verbose=False, **extra)
    # per epoch: training, full training-set evaluation, validation
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for got, want in zip(seen["port"], seen["jax"]):
        assert got.format == want.format and got.dtype == want.dtype
        np.testing.assert_array_equal(got.toarray(), want.toarray())
    training = [a.toarray() for a in seen["port"][0::3]]
    assert set(np.unique(training[0])) <= {0.0, 1.0}
    assert not np.array_equal(training[0], training[1])
    assert not np.array_equal(training[0], seen["port"][1].toarray())


# -- the golden configurations, streamed ----------------------------------

MINIBATCH = 100
COMMON = dict(feature_size=25, latent_size=2, hidden_sizes=[32],
              reconstruction_distribution="negative binomial")
TRAIN = dict(minibatch_size=MINIBATCH, learning_rate=1e-3, seed=0,
             verbose=False)
EPOCHS = 3
# name: (model kwargs, keys split per forward pass)
GOLDEN = {
    "vae": (dict(number_of_warm_up_epochs=5), 3),
    "gmvae": (dict(number_of_latent_clusters=3), 4),
}


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """(JAX's, the port's) development splits, each with its own cache."""
    def split(data_set_class):
        directory = str(tmp_path_factory.mktemp("data"))
        return data_set_class("development", directory=directory,
                              example_filter=["random", 1000]).split(
                                  method="random", fraction=0.9)

    return split(JaxDataSet), split(DataSet)


@pytest.fixture
def jax_draws(monkeypatch):
    """Route the port's z draws through a queue of JAX's draws."""
    queue = collections.deque()
    original = Normal.sample

    def sample(self, generator, sample_shape=(), noise=None):
        if noise is None:
            noise = queue.popleft()
        return original(self, generator, sample_shape, noise=noise)

    monkeypatch.setattr(Normal, "sample", sample)
    return queue


def _normal(key, keys_per_pass, shape):
    """A forward pass's standard-normal z draws from ``key`` (split in
    three by the VAE, in four by the GMVAE; z takes the third)."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key, keys_per_pass)[2], shape)))


def _rows(n):
    return [min(MINIBATCH, n - start) for start in range(0, n, MINIBATCH)]


def _jax_streaming_draws(n_training, n_validation, keys_per_pass, z_shape):
    """Every z draw of JAX's streaming run in the port's order: each
    epoch's training steps, one key split per batch, the shorter last
    batch included (``scvae_tpu/models/training.py:96-110``), then the
    training set's and the validation set's evaluation, one key split per
    batch (``:62-93``)."""
    draws = []
    rng, _ = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]))

    def batches(key, n):
        for rows in _rows(n):
            key, sub = jax.random.split(key)
            draws.append(_normal(sub, keys_per_pass, z_shape(rows)))

    for _ in range(EPOCHS):
        rng, sub = jax.random.split(rng)
        batches(sub, n_training)
        for n in (n_training, n_validation):
            rng, sub = jax.random.split(rng)
            batches(sub, n)
    return draws


def _golden_models(name, directory):
    kwargs = GOLDEN[name][0]
    classes = {"vae": (JaxVAE, VariationalAutoencoder),
               "gmvae": (JaxGMVAE, GaussianMixtureVariationalAutoencoder)}
    return tuple(model_class(**COMMON, **kwargs,
                             log_directory=str(directory / where))
                 for model_class, where in zip(classes[name],
                                               ("jax", "port")))


def _jax_initial_state(jax_model, monkeypatch, model):
    """Give the port model JAX's initial weights from the run's key."""
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    init_key = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]))[1]
    start = jax_model._init_state(init_key)

    def init_state(generator, optimizer, device):
        return api._place(tparams.params_from_jax(as_numpy(start.params)),
                          tparams.params_from_jax(as_numpy(start.model_state)),
                          optimizer, device)

    monkeypatch.setattr(model, "_init_state", init_state)


def _noise_driven(key):
    """The VAE's leaves whose gradient is zero in exact arithmetic (see
    ``tests/test_torch_golden.py``): the biases right before batch norm,
    and the posterior mean's bias while the KL weight is 0."""
    return (("['layers']" in key and key.endswith("['bias']"))
            or key == "['posterior']['mu']['bias']")


def _freeze_noise_driven(monkeypatch):
    """Set the updates of the noise-driven leaves to zero in JAX's and in
    the port's optimiser (otherwise each is ``clip(1.0)`` then Adam)."""
    import optax

    def jax_optimizer(learning_rate):
        def mask(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: _noise_driven(jax.tree_util.keystr(path)),
                params)
        return optax.chain(optax.masked(optax.set_to_zero(), mask),
                           optax.clip(1.0), optax.adam(learning_rate))

    class FrozenClipAdam(tstep.ClipAdam):
        def update_(self, params, grads, opt_state):
            frozen = {id(leaf) for key, leaf in tparams.flatten(params).items()
                      if _noise_driven(key)}
            grads = [torch.zeros_like(grad) if id(leaf) in frozen else grad
                     for leaf, grad in zip(tstep.tree_leaves(params), grads)]
            super().update_(params, grads, opt_state)

    monkeypatch.setattr(jstep, "make_optimizer", jax_optimizer)
    monkeypatch.setattr(tstep, "make_optimizer", FrozenClipAdam)


@pytest.mark.parametrize("name, frozen", [("vae", False), ("vae", True),
                                          ("gmvae", False)],
                         ids=["vae", "vae-frozen", "gmvae"])
def test_streaming_golden_run_on_jax_draws(name, frozen, splits, jax_draws,
                                           tmp_path, monkeypatch):
    """The VAE parts from JAX's run where ``tests/test_torch_golden.py``
    finds its device run parting (Adam's full steps on the rounding noise
    of exactly-zero gradients): unfrozen its lower bounds follow JAX's
    within rtol 1e-3 in the first epoch (6.6e-4 apart) and its KL terms
    in all three; with those leaves frozen in both optimisers, every curve
    follows JAX's within 1e-3 throughout."""
    (jax_train, jax_valid, _), (train_set, valid_set, _) = splits
    jax_model, model = _golden_models(name, tmp_path)
    if frozen:
        _freeze_noise_driven(monkeypatch)
    want = jax_model.train(jax_train, jax_valid, number_of_epochs=EPOCHS,
                           data_placement="streaming", **TRAIN).history
    _jax_initial_state(jax_model, monkeypatch, model)
    clusters = () if name == "vae" else (model.number_of_latent_clusters,)
    jax_draws.extend(_jax_streaming_draws(
        train_set.number_of_examples, valid_set.number_of_examples,
        GOLDEN[name][1],
        lambda rows: (1,) + clusters + (rows, COMMON["latent_size"])))
    result = model.train(train_set, valid_set, number_of_epochs=EPOCHS,
                         data_placement="streaming", device="cpu", **TRAIN)
    assert not jax_draws  # every draw of JAX's run was used, in turn
    assert result.steps_per_epoch == len(_rows(810)) == 9
    got = result.history
    followed = 1 if name == "vae" and not frozen else EPOCHS
    for kind in ("training", "validation"):
        assert len(got[kind]["lower_bound"]) == EPOCHS
        np.testing.assert_allclose(got[kind]["kl_divergence"],
                                   want[kind]["kl_divergence"], rtol=1e-3,
                                   err_msg=kind)
        np.testing.assert_allclose(got[kind]["lower_bound"][:followed],
                                   want[kind]["lower_bound"][:followed],
                                   rtol=1e-3, err_msg=kind)
        if name == "gmvae":
            np.testing.assert_allclose(got[kind]["accuracy"],
                                       want[kind]["accuracy"], atol=0.01,
                                       err_msg=kind)


@pytest.mark.parametrize("name", ["vae", "gmvae"])
def test_streaming_and_device_runs_on_own_draws(name, splits, tmp_path):
    _, (train_set, valid_set, _) = splits
    for placement in ("streaming", "device"):
        model = _golden_models(name, tmp_path / placement)[1]
        result = model.train(train_set, valid_set, number_of_epochs=2,
                             data_placement=placement, device="cpu", **TRAIN)
        for kind in ("training", "validation"):
            curve = result.history[kind]["lower_bound"]
            assert len(curve) == 2 and np.all(np.isfinite(curve))
        assert result.steps_per_epoch == (9 if placement == "streaming"
                                          else 8)


def test_caches_directory_moves_results(tmp_path):
    """The counterpart of ``tests/test_intermediate.py``'s test of the JAX
    package, and a second run that resumes from the permanent copy."""
    counts = _counts(96, 20, 0.3, seed=8)
    model = VariationalAutoencoder(
        feature_size=20, latent_size=2, hidden_sizes=[16],
        reconstruction_distribution="negative binomial",
        log_directory=str(tmp_path / "models"))
    scratch = str(tmp_path / "scratch")
    first = model.train(counts, number_of_epochs=1, minibatch_size=32,
                        caches_directory=scratch, device="cpu", verbose=False)
    permanent = model.log_directory()
    assert os.path.exists(os.path.join(permanent, "checkpoint.npz"))
    assert os.path.exists(os.path.join(permanent, "learning_curves.json"))
    assert not os.path.exists(naming.log_directory(scratch, model.name))
    second = model.train(counts, number_of_epochs=2, minibatch_size=32,
                         caches_directory=scratch, device="cpu",
                         verbose=False)
    curve = second.history["training"]["lower_bound"]
    assert len(curve) == 2
    assert curve[0] == first.history["training"]["lower_bound"][0]
    assert second.train_state.step == 3 * 2  # 3 steps in each epoch
    assert not os.path.exists(naming.log_directory(scratch, model.name))


EVAL = dict(feature_size=24, latent_size=3, hidden_sizes=[12, 10],
            reconstruction_distribution="negative binomial")


@pytest.mark.parametrize("kind", ["vae", "gmvae"])
def test_evaluate_through_pipeline_matches_jax(kind, tmp_path, jax_draws):
    counts = _counts(200, 24, 0.08, seed=9)
    evaluation = _counts(70, 24, 0.08, seed=10)  # batches of 32, 32 and 6
    names = np.array([f"cell {i}" for i in range(70)])
    classes = ((JaxVAE, VariationalAutoencoder) if kind == "vae"
               else (JaxGMVAE, GaussianMixtureVariationalAutoencoder))
    extra = {} if kind == "vae" else {"number_of_latent_clusters": 3}
    jax_model, model = (model_class(**EVAL, **extra,
                                    log_directory=str(tmp_path))
                        for model_class in classes)
    jax_model.train(JaxDataSet("in-memory", values=counts),
                    number_of_epochs=2, minibatch_size=32, verbose=False)
    jax_set = JaxDataSet("in-memory", values=evaluation, example_names=names)
    port_set = DataSet("in-memory", values=evaluation, example_names=names)
    want = jax_model.evaluate(jax_set, minibatch_size=32, verbose=False)
    # JAX's draws: a key split per batch after the restore's
    clusters = () if kind == "vae" else (3,)
    rng, _ = jax.random.split(jax.random.PRNGKey(0))
    for rows in (32, 32, 6):
        rng, sub = jax.random.split(rng)
        jax_draws.append(_normal(sub, 3 if kind == "vae" else 4,
                                 (1,) + clusters + (rows, 3)))
    pipelines = []

    class Recording(pipeline.BatchPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pipelines.append(self)

    api.BatchPipeline, original = Recording, api.BatchPipeline
    try:
        got = model.evaluate(port_set, minibatch_size=32, device="cpu",
                             verbose=False)
    finally:
        api.BatchPipeline = original
    assert not jax_draws
    assert pipelines and pipelines[0]._csr_wire  # the set rode the wire
    (_, got_r, got_l), (_, want_r, want_l) = got, want
    if kind == "gmvae":
        np.testing.assert_allclose(got_l["y"].values, want_l["y"].values,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got_l["z"].predicted_cluster_ids,
                                      want_l["z"].predicted_cluster_ids)
        got_l, want_l = got_l["z"], want_l["z"]
    np.testing.assert_allclose(got_l.values, want_l.values, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_r.values, want_r.values, rtol=1e-3,
                               atol=1e-6)
    for attribute in ("total_standard_deviations",
                      "explained_standard_deviations"):
        a, b = (getattr(r, attribute) for r in (got_r, want_r))
        np.testing.assert_array_equal(np.unique(a.nonzero()[0]),
                                      np.unique(b.nonzero()[0]))
        np.testing.assert_allclose(a.toarray(), b.toarray(), rtol=1e-3,
                                   atol=1e-6)
    metrics = model._last_evaluation_metrics
    for key, value in jax_model._last_evaluation_metrics.items():
        rtol = 2e-3 if key.startswith("kl_divergence") else 2e-4
        np.testing.assert_allclose(metrics[key], value, rtol=rtol,
                                   atol=1e-5, err_msg=key)
