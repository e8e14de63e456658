"""Training in the port against the JAX package, and the port's boundaries.

* 20 clip + Adam steps from the same initial parameters on the same batches
  follow the JAX trajectory (PARITY.md §2: rtol 1e-3), with a deterministic
  z (unfused path) and with JAX's own z draws injected (the port's fused
  path against JAX's unfused one);
* ``epoch_permutation`` gives the JAX package's minibatch order;
* ``VariationalAutoencoder(...).train(..., device="cpu")`` gives a finite,
  rising ELBO with every ported likelihood;
* the package imports with JAX blocked and imports neither JAX nor
  ``scvae_tpu``; entry points need CUDA unless ``device="cpu"``;
* both packages' constructors take ``fused_likelihood`` (the port refuses
  False until its unfused training path is ported).
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scvae_tpu.models import step as jstep
from scvae_tpu.models import vae as jvae
from scvae_tpu_torch import VariationalAutoencoder
from scvae_tpu_torch import params as tparams
from scvae_tpu_torch.models import step as tstep
from scvae_tpu_torch.models import vae as tvae

REPO = pathlib.Path(__file__).resolve().parents[1]
F, LATENT, HIDDEN, B, LR, STEPS = 12, 3, (8,), 16, 1e-3, 20


def _trajectories(deterministic_z):
    config_kwargs = dict(
        feature_size=F, latent_size=LATENT, hidden_sizes=HIDDEN,
        reconstruction_distribution="negative binomial",
    )
    jconfig = jvae.VAEConfig(**config_kwargs)
    tconfig = tvae.VAEConfig(**config_kwargs)
    params, state = jvae.init(jconfig, jax.random.PRNGKey(0))
    data = np.random.RandomState(1234).poisson(2.0, (64, F)).astype(np.float32)
    batches = [data[(i % 4) * B:(i % 4 + 1) * B] for i in range(STEPS)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]

    def jax_loss(params, model_state, batch, rng, wuw):
        metrics, outputs = jvae.elbo_terms(
            jconfig, params, model_state, batch, rng, training=True,
            deterministic_z=deterministic_z, warm_up_weight=wuw,
        )
        return -metrics["lower_bound_weighted"], (metrics, outputs.new_state)

    optimizer = jstep.make_optimizer(LR)
    ts = jstep.create_train_state(params, state, optimizer)
    train_step = jstep.make_train_step(jax_loss, optimizer, donate=False)
    jax_curve = []
    for batch, key in zip(batches, keys):
        ts, metrics = train_step(
            ts, {"x": jnp.asarray(batch), "t": jnp.asarray(batch)}, key, 1.0
        )
        jax_curve.append(float(metrics["lower_bound"]))

    # the draws JAX's forward makes for z from each step's key
    noises = iter([
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(key, 3)[2], (1, B, LATENT))))
        for key in keys
    ])

    def port_loss(params, model_state, batch, generator, wuw, shard=None):
        metrics, outputs = tvae.elbo_terms(
            tconfig, params, model_state, batch, generator, training=True,
            deterministic_z=deterministic_z, warm_up_weight=wuw,
            noise=None if deterministic_z else next(noises), shard=shard,
        )
        return -metrics["lower_bound_weighted"], (metrics, outputs.new_state)

    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    t_optimizer = tstep.make_optimizer(LR)
    tts = tstep.create_train_state(
        tparams.params_from_jax(as_numpy(params)),
        tparams.params_from_jax(as_numpy(state)), t_optimizer,
    )
    t_step = tstep.make_train_step(port_loss, t_optimizer)
    port_curve = []
    for batch in batches:
        xt = torch.from_numpy(batch)
        tts, metrics = t_step(tts, {"x": xt, "t": xt}, None, 1.0)
        port_curve.append(float(metrics["lower_bound"]))
    return jax_curve, port_curve, ts, tts


@pytest.mark.parametrize("deterministic_z", [True, False])
def test_trajectory_matches_jax(deterministic_z):
    jax_curve, port_curve, ts, tts = _trajectories(deterministic_z)
    np.testing.assert_allclose(port_curve, jax_curve, rtol=1e-3)
    assert tts.step == int(ts.step) == STEPS
    flat_jax = tparams.flatten(jax.tree_util.tree_map(np.asarray, ts.params))
    for name, leaf in tparams.flatten(tts.params).items():
        if "['layers']" in name and name.endswith("['bias']"):
            # a bias right before batch norm has an exactly zero gradient;
            # Adam scales each side's float noise up to a full step
            continue
        np.testing.assert_allclose(leaf.numpy(), flat_jax[name],
                                   rtol=1e-3, atol=1e-5)


def test_epoch_permutation_matches_jax():
    for n, batch, seed in ((1000, 64, 0), (68_579, 2048, 3)):
        ours = tstep.epoch_permutation(n, batch, np.random.RandomState(seed))
        ref = jstep.epoch_permutation(n, batch, np.random.RandomState(seed))
        assert ours.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(ours, ref)


def test_warm_up_weight_matches_jax():
    from scvae_tpu.models import objectives as jobjectives
    from scvae_tpu_torch.models import objectives

    for warm_up in (0, 1, 5):
        for epoch in range(8):
            assert objectives.warm_up_weight(epoch, warm_up) == (
                jobjectives.warm_up_weight(epoch, warm_up))


@pytest.fixture
def in_tmp_path(tmp_path, monkeypatch):
    """Run in a fresh working directory: a model given no log directory
    writes its run under ``./models``, and would resume another test's."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", ["negative binomial", "poisson",
                                  "zero-inflated poisson",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
def test_train_on_cpu_rises(name, in_tmp_path):
    x = np.random.RandomState(0).poisson(2.0, (256, 40)).astype(np.float32)
    model = VariationalAutoencoder(
        feature_size=40, latent_size=4, hidden_sizes=[16, 16],
        reconstruction_distribution=name, learning_rate=1e-3,
    )
    result = model.train(x, number_of_epochs=2, minibatch_size=64,
                         device="cpu", verbose=False)
    curve = result.history["training"]["lower_bound"]
    assert len(curve) == 2 and np.all(np.isfinite(curve))
    assert curve[1] > curve[0]
    assert result.steps_per_epoch == 4 and result.train_state.step == 8


def test_entry_points_need_cuda_unless_cpu(monkeypatch, in_tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = VariationalAutoencoder(
        feature_size=10, latent_size=2, hidden_sizes=[8],
        reconstruction_distribution="negative binomial",
    )
    x = np.ones((32, 10), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.train(x, number_of_epochs=1, minibatch_size=16, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.evaluate(x)
    # streaming and a caches directory are ported: each trains on the CPU
    for ported in ({"data_placement": "streaming"},
                   {"caches_directory": "caches"}):
        result = model.train(x, number_of_epochs=1, minibatch_size=16,
                             device="cpu", verbose=False, reset_training=True,
                             **ported)
        assert np.isfinite(result.history["training"]["lower_bound"]).all()
        assert result.train_state.step == 2
    # a mesh of two devices needs a world of two processes (torchrun)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        model.evaluate(x, device="cpu", number_of_devices=2)
    # the reference default, Poisson, is ported, and so is every other
    # reconstruction distribution (Bernoulli trains unfused)
    assert VariationalAutoencoder(feature_size=10).config.reconstruction_distribution == "poisson"
    bernoulli = VariationalAutoencoder(feature_size=10,
                                       reconstruction_distribution="bernoulli")
    assert not tvae.fused_path_enabled(bernoulli.config)


@pytest.mark.parametrize("name", ["zero-inflated poisson",
                                  "zero-inflated negative binomial",
                                  "constrained poisson"])
def test_api_refuses_what_jax_refuses(name):
    """The VAE API refuses a zero-inflated or constrained base with classes
    with the JAX API's error (``validate_model_parameters``); the GMVAE
    constructors of both packages do not validate, so both take ZINB with
    classes."""
    from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
    from scvae_tpu.models.gmvae_api import (
        GaussianMixtureVariationalAutoencoder as JaxGMVAE,
    )
    from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder

    kwargs = dict(feature_size=10, reconstruction_distribution=name,
                  number_of_reconstruction_classes=3)
    with pytest.raises(ValueError) as jax_error:
        JaxVAE(**kwargs)
    with pytest.raises(ValueError) as port_error:
        VariationalAutoencoder(**kwargs)
    assert str(port_error.value) == str(jax_error.value)
    assert "cannot be piecewise categorical" in str(port_error.value)
    if name == "zero-inflated negative binomial":
        for cls in (JaxGMVAE, GaussianMixtureVariationalAutoencoder):
            assert cls(**kwargs).config.k_max == 3


@pytest.mark.parametrize("fused", [None, True, False])
def test_fused_likelihood_switch(fused):
    """Both packages' VAE and GMVAE constructors take ``fused_likelihood``
    and keep it in the configuration; False trains the unfused path, None
    and True the fused kernels where the likelihood has them (JAX's None
    also turns its kernels off off the TPU).  True with a likelihood that
    has no kernel raises ``ValueError`` in both packages."""
    from scvae_tpu.models.api import VariationalAutoencoder as JaxVAE
    from scvae_tpu.models.gmvae_api import (
        GaussianMixtureVariationalAutoencoder as JaxGMVAE,
    )
    from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder

    kwargs = dict(feature_size=10, reconstruction_distribution="negative binomial",
                  fused_likelihood=fused)
    for jax_cls, port_cls in ((JaxVAE, VariationalAutoencoder),
                              (JaxGMVAE, GaussianMixtureVariationalAutoencoder)):
        assert jax_cls(**kwargs).config.fused_likelihood is fused
        model = port_cls(**kwargs)
        assert model.config.fused_likelihood is fused
        assert model.config.reconstruction_distribution == "negative binomial"
        assert tvae.fused_path_enabled(model.config) is (fused is not False)
    lomax = dict(feature_size=10, reconstruction_distribution="lomax",
                 fused_likelihood=fused)
    if fused:
        with pytest.raises(ValueError, match="no fused kernel"):
            jvae._fused_path_enabled(JaxVAE(**lomax).config)
        with pytest.raises(ValueError, match="no fused kernel"):
            VariationalAutoencoder(**lomax)
    else:
        assert not tvae.fused_path_enabled(
            VariationalAutoencoder(**lomax).config)
    with pytest.raises(TypeError, match="unexpected arguments"):
        VariationalAutoencoder(feature_size=10, fused_likelihoods=True)


def _package_modules():
    package = REPO / "scvae_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in package.rglob("*.py")
    )


def test_imports_with_jax_blocked():
    modules = _package_modules()
    assert "scvae_tpu_torch.models.vae" in modules
    assert "scvae_tpu_torch.data.pipeline" in modules
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scvae_tpu'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'scvae_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_no_jax_or_reference_imports():
    files = sorted((REPO / "scvae_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "scvae_tpu", "optax"), (
                    f"{path.relative_to(REPO)} imports {name}"
                )


def test_package_files_are_tracked():
    """The package's models/ and data/ directories are not caught by an
    ignore rule meant for the repository root."""
    paths = ["scvae_tpu_torch/models/vae.py", "scvae_tpu_torch/data/pipeline.py"]
    out = subprocess.run(["git", "check-ignore", *paths], cwd=REPO,
                         capture_output=True, text=True)
    if out.returncode == 128:
        pytest.skip(f"not a git checkout: {out.stderr.strip()}")
    assert out.stdout.strip() == ""


def test_chip_smoke_config_level_training_on_cpu(monkeypatch):
    """``chip_smoke.train_config_level`` (phases 4 and 4b on the card, and
    ``tools/profile_torch_step.py``) runs its data and training path on the
    CPU: one epoch of a small VAE on a count matrix."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    counts = chip_smoke.make_counts(chip_smoke.BATCH * 2, 16)
    config = tvae.VAEConfig(feature_size=16, latent_size=2, hidden_sizes=(8,),
                            reconstruction_distribution="negative binomial")
    result = chip_smoke.train_config_level(config, counts, device="cpu",
                                           epochs=1)
    assert result.steps_per_epoch == 2 and result.train_state.step == 2
    assert np.isfinite(result.history["training"]["lower_bound"][0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chip_smoke_majority_vote_matches_the_package(seed, monkeypatch):
    """``chip_smoke.majority_vote`` (phase 5b's host recomputation of the
    GMVAE's accuracy) gives the package's cluster-to-label mapping and
    accuracy: ties to the first name, excluded classes left out, a cluster
    of excluded rows only left unmapped."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from scvae_tpu_torch.analyses.prediction import (
        labels_of_clusters,
        map_cluster_ids_to_label_ids,
    )

    rng = np.random.RandomState(seed)
    names = np.array(["alpha", "beta", "delta", "gamma"])
    labels = names[rng.randint(0, 4, 60)]
    clusters = rng.randint(0, 5, 60)
    # cluster 5: a tie of beta and gamma; cluster 6: excluded rows only
    labels = np.concatenate([labels, ["gamma", "beta", "gamma", "beta"],
                             ["delta", "delta"]])
    clusters = np.concatenate([clusters, [5, 5, 5, 5], [6, 6]])
    excluded = ["delta"]
    to_id = {name: i for i, name in enumerate(names)}
    mapping, accuracy = chip_smoke.majority_vote(labels, clusters, excluded)
    assert mapping[5] == "beta" and 6 not in mapping
    predicted = labels_of_clusters(
        labels, to_id, dict(enumerate(names)), excluded, clusters)
    np.testing.assert_array_equal(
        predicted, [mapping.get(c, names[0]) for c in clusters.tolist()])
    label_ids = np.array([to_id[name] for name in labels])
    predicted_ids = map_cluster_ids_to_label_ids(label_ids, clusters,
                                                 [to_id["delta"]])
    keep = labels != "delta"
    assert accuracy == float((predicted_ids[keep] == label_ids[keep]).mean())
