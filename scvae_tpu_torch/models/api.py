"""High-level model API: ``VariationalAutoencoder`` with the reference's
``train`` surface (the ported part of ``scvae_tpu/models/api.py``).  The
model-specific parts are the hooks ``_init_state``, ``_loss_fn`` and
``_eval_fn``, which ``GaussianMixtureVariationalAutoencoder``
(``models/gmvae_api.py``) overrides to train through the same ``train``.

Training runs on the device-resident path: the count matrix is staged on the
device once as row-major int16, each step gathers a shuffled minibatch with
the row-gather kernel and trains through the fused likelihood kernels.
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU they raise.  Arguments that need parts not ported yet (validation and
early stopping, checkpoints, resume, streaming, meshes, deferred metric
fetch, analyses) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.data.dataset import DataSet
from scvae_tpu_torch.data.pipeline import (
    build_model_arrays,
    device_resident_data,
    narrowest_count_dtype,
)
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import step, training, vae
from scvae_tpu_torch.models.utilities import parse_numbers_of_samples
from scvae_tpu_torch.ops.special import lgamma

_CONFIG_KWARGS = (
    "parameterise_latent_posterior", "analytical_kl_term",
    "inference_architecture", "generative_architecture", "count_sum",
    "dropout_keep_probabilities", "kl_weight", "learning_rate",
    "precision",
)
_SAMPLE_KWARGS = ("number_of_monte_carlo_samples", "number_of_importance_samples")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def _append_lgamma_rowsum(data: dict[str, torch.Tensor], config,
                          chunk: int = 8192) -> dict[str, torch.Tensor]:
    """Stage the per-row Σ_f lgamma(1+t) constants once per dataset.

    The −lgamma(1+t) term is constant in the parameters and additive per
    row, so it is computed here as an (N,) vector, gathered per batch and
    subtracted outside the forward kernel (``vae.fused_log_p_x``), which
    then skips the lgamma chain.  Not for the
    constrained Poisson, whose kernel keeps its own lgamma, nor for the
    categorised likelihoods (``k_max`` > 0), whose lgamma sits inside the
    shifted branch and is not row-separable (as in the JAX package)."""
    if (config.k_max
            or config.reconstruction_distribution == "constrained poisson"):
        return data
    t = data["t"]
    rowsum = torch.cat([
        torch.sum(lgamma(1.0 + t[start:start + chunk].float()), dim=-1)
        for start in range(0, t.shape[0], chunk)
    ])
    return {**data, "t_lgamma_rowsum": rowsum}


def _bf16_batch_dtypes(arrays: dict[str, Any], config,
                       device: torch.device) -> dict[str, torch.dtype] | None:
    """Gather-output dtype overrides for mixed-precision training.

    When the trunk computes in bf16, the (B, F) count fields can come out of
    the row gather as bf16 directly, provided that is value-exact: integral
    data in [0, 256] (bf16 holds every integer up to 256).  The likelihood
    math still runs in float32: every kernel and plain version converts t
    to float32 before any arithmetic, the categorised ones' shifted lgamma
    included (the JAX package keeps float32 t for those, whose jnp code
    would compute t − K and its lgamma in bf16).  None when
    inapplicable."""
    if config.compute_dtype(True, device) is None:
        return None
    overrides: dict[str, torch.dtype] = {}
    checked: dict[int, bool] = {}
    for field in ("x", "t"):
        arr = arrays.get(field)
        if arr is None:
            continue
        key = id(arr)
        if key not in checked:
            exact = narrowest_count_dtype(arr, (np.int16, np.int32)) is not None
            if exact:
                data = arr.data if scipy.sparse.issparse(arr) else np.asarray(arr)
                exact = data.size == 0 or (
                    float(np.max(data)) <= 256 and float(np.min(data)) >= 0
                )
            checked[key] = exact
        if checked[key]:
            overrides[field] = torch.bfloat16
    return overrides or None


def _place(params, model_state, optimizer, device) -> step.TrainState:
    to_device = lambda x: x.to(device)  # noqa: E731
    return step.create_train_state(
        step.tree_map(to_device, params),
        step.tree_map(to_device, model_state),
        optimizer,
    )


class VariationalAutoencoder:
    """VAE with the reference's ``train`` (the evaluate and sample surfaces
    are not ported yet)."""

    type = "VAE"
    # Datasets whose dense device form fits under this budget are staged on
    # the device once (the only data path ported so far).
    DEVICE_DATA_BUDGET_BYTES = 8 << 30
    DEVICE_COUNT_DTYPES = (np.int16, np.int32)

    def __init__(
        self,
        feature_size: int,
        latent_size: int | None = None,
        hidden_sizes=None,
        reconstruction_distribution: str | None = None,
        number_of_reconstruction_classes: int | None = None,
        latent_distribution: str | None = None,
        minibatch_normalisation: bool | None = None,
        batch_correction: bool | None = None,
        number_of_batches: int | None = None,
        number_of_warm_up_epochs: int | None = None,
        log_directory: str | None = None,
        **kwargs: Any,
    ):
        unknown = set(kwargs) - set(_CONFIG_KWARGS) - set(_SAMPLE_KWARGS) - {"mesh"}
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        if log_directory is not None:
            raise NotImplementedError("checkpoints and log directories are not ported yet")
        if kwargs.get("mesh") is not None:
            raise NotImplementedError("device meshes are not ported yet")

        def default(value, *path):
            return get_default(*path) if value is None else value

        samples = {
            name: parse_numbers_of_samples(
                default(kwargs.get(name), "models", "number_of_samples")
            )
            for name in _SAMPLE_KWARGS
        }
        self.number_of_monte_carlo_samples = samples["number_of_monte_carlo_samples"]
        self.number_of_importance_samples = samples["number_of_importance_samples"]

        config_kwargs = {
            name: kwargs[name] for name in _CONFIG_KWARGS if name in kwargs
        }
        if "dropout_keep_probabilities" in config_kwargs:
            config_kwargs["dropout_keep_probabilities"] = tuple(
                config_kwargs["dropout_keep_probabilities"] or ()
            )
        self.config = vae.VAEConfig(
            feature_size=feature_size,
            latent_size=default(latent_size, "models", "latent_size"),
            hidden_sizes=tuple(default(hidden_sizes, "models", "hidden_sizes")),
            reconstruction_distribution=default(
                reconstruction_distribution, "models", "reconstruction_distribution"
            ),
            number_of_reconstruction_classes=default(
                number_of_reconstruction_classes, "models",
                "number_of_reconstruction_classes",
            ),
            latent_distribution=(
                latent_distribution
                or get_default("models", "latent_distribution")[self.type]
            ),
            minibatch_normalisation=default(
                minibatch_normalisation, "models", "minibatch_normalisation"
            ),
            batch_correction=default(batch_correction, "models", "batch_correction"),
            number_of_batches=number_of_batches or 1,
            number_of_warm_up_epochs=default(
                number_of_warm_up_epochs, "models", "number_of_warm_up_epochs"
            ),
            **config_kwargs,
        )
        self.feature_size = feature_size
        self.latent_size = self.config.latent_size
        self.hidden_sizes = self.config.hidden_sizes

    # -- model hooks -------------------------------------------------------

    def _init_state(self, generator: torch.Generator, optimizer,
                    device: torch.device) -> step.TrainState:
        """Parameters drawn from the CPU ``generator``, placed on
        ``device``, with ``optimizer``'s state."""
        return _place(*vae.init(self.config, generator), optimizer, device)

    def _loss_fn(self, n_iw: int, n_mc: int):
        config = self.config

        def loss(params, model_state, batch, generator, warm_up_weight):
            return vae.loss_fn(
                config, params, model_state, batch, generator,
                n_iw=n_iw, n_mc=n_mc, warm_up_weight=warm_up_weight,
            )

        return loss

    def _eval_fn(self, n_iw: int, n_mc: int):
        """``evaluate(params, model_state, batch, generator) → metrics`` of
        one batch on the unfused float32 path."""
        config = self.config

        def evaluate(params, model_state, batch, generator):
            metrics, _ = vae.elbo_terms(
                config, params, model_state, batch, generator,
                training=False, n_iw=n_iw, n_mc=n_mc,
            )
            return metrics

        return evaluate

    # -- internals ---------------------------------------------------------

    def _scaled_minibatch_size(self, minibatch_size: int, scenario: str) -> int:
        """Keep the flattened sample×batch constant (reference :807-811)."""
        scale = (
            self.number_of_importance_samples[scenario]
            * self.number_of_monte_carlo_samples[scenario]
        )
        return max(1, int(np.floor(minibatch_size / scale)))

    def _device_evaluator(self, data: dict[str, torch.Tensor], n: int,
                          batch_size: int, n_iw: int, n_mc: int):
        """Full-pass evaluation (unfused, float32) over sequential batches
        plus one remainder batch, weighted by rows like the JAX package."""
        device = next(iter(data.values())).device
        idx = torch.from_numpy(step.sequential_batches(n, batch_size)).to(device)
        n_full = int(idx.numel())
        keys = step.EVAL_METRIC_KEYS
        eval_fn = self._eval_fn(n_iw, n_mc)

        def batch_metrics(ts, batch, generator):
            return eval_fn(ts.params, ts.model_state,
                           step.cast_batch_to_f32(batch), generator)

        def evaluate(ts: step.TrainState, generator: torch.Generator):
            with torch.no_grad():
                sums = {k: 0.0 for k in keys}
                for batch_idx in idx:
                    batch = step.gather_batch(data, batch_idx)
                    metrics = batch_metrics(ts, batch, generator)
                    sums = {k: sums[k] + metrics[k] for k in keys}
                out = {k: sums[k] * (batch_size / n) for k in keys}
                if n > n_full:
                    tail = {k: v[n_full:n] for k, v in data.items()}
                    metrics = batch_metrics(ts, tail, generator)
                    out = {
                        k: out[k] + metrics[k] * ((n - n_full) / n) for k in keys
                    }
            return {
                k: float(v) if v.dim() == 0 else v.cpu().numpy()
                for k, v in out.items()
            }

        return evaluate

    # -- train -------------------------------------------------------------

    def train(
        self,
        training_set,
        validation_set=None,
        number_of_epochs: int | None = None,
        minibatch_size: int | None = None,
        learning_rate: float | None = None,
        run_id: str | None = None,
        new_run: bool = False,
        reset_training: bool = False,
        full_train_evaluation: bool = True,
        data_placement: str = "auto",
        metrics_fetch: str = "sync",
        intermediate_analyser=None,
        analyses_directory: str | None = None,
        caches_directory: str | None = None,
        seed: int = 0,
        verbose: bool = True,
        epoch_callback=None,
        mesh=None,
        devices=None,
        number_of_devices: int | None = None,
        model_parallelism: int | None = None,
        device: torch.device | str | None = None,
    ) -> training.TrainingResult:
        """Train on ``training_set`` (a :class:`DataSet`, or a dense or CSR
        count matrix with cells as rows) on ``device`` (CUDA by default)."""
        unported = {
            "validation_set (early stopping)": validation_set is not None,
            "run_id / new_run / reset_training (checkpoints)": (
                run_id is not None or new_run or reset_training
            ),
            "streaming data placement": data_placement == "streaming",
            "deferred metrics fetch": metrics_fetch == "deferred",
            "intermediate analyses": (
                intermediate_analyser is not None or analyses_directory is not None
            ),
            "caches_directory": caches_directory is not None,
            "meshes and several devices": any(
                v is not None
                for v in (mesh, devices, number_of_devices, model_parallelism)
            ),
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"{what} is not ported yet")
        if data_placement not in ("auto", "device", "streaming"):
            raise ValueError("data_placement must be auto, device, or streaming")
        if metrics_fetch not in ("sync", "deferred"):
            raise ValueError("metrics_fetch must be 'sync' or 'deferred'")
        device = resolve_device(device)
        if not isinstance(training_set, DataSet):
            training_set = DataSet(training_set)
        if training_set.number_of_features != self.config.feature_size:
            raise ValueError(
                f"data has {training_set.number_of_features} features, the "
                f"model {self.config.feature_size}"
            )
        if number_of_epochs is None:
            number_of_epochs = get_default("models", "number_of_epochs")
        if minibatch_size is None:
            minibatch_size = get_default("models", "minibatch_size")
        if learning_rate is None:
            learning_rate = self.config.learning_rate

        values = training_set.values
        n_train = training_set.number_of_examples
        dtype = narrowest_count_dtype(values, self.DEVICE_COUNT_DTYPES)
        itemsize = 4 if dtype is None else np.dtype(dtype).itemsize
        if (data_placement == "auto"
                and n_train * training_set.number_of_features * itemsize
                > self.DEVICE_DATA_BUDGET_BYTES):
            raise NotImplementedError(
                "the data set exceeds the device budget and streaming is not "
                "ported yet"
            )
        n_iw = self.number_of_importance_samples["training"]
        n_mc = self.number_of_monte_carlo_samples["training"]
        batch_size = self._scaled_minibatch_size(minibatch_size, "training")
        if n_train < batch_size:
            raise ValueError(
                f"minibatch of {batch_size} rows exceeds the {n_train} "
                "training examples"
            )

        optimizer = step.make_optimizer(learning_rate)
        train_state = self._init_state(
            torch.Generator().manual_seed(seed), optimizer, device
        )
        generator = torch.Generator(device=device).manual_seed(seed)

        arrays = build_model_arrays(
            training_set,
            use_count_sum_as_parameter=self.config.use_count_sum_as_parameter,
        )
        data = device_resident_data(
            arrays, device=device, count_dtype=self.DEVICE_COUNT_DTYPES
        )
        data = _append_lgamma_rowsum(data, self.config)
        train_epoch = step.make_train_epoch(
            self._loss_fn(n_iw, n_mc), optimizer,
            batch_dtypes=_bf16_batch_dtypes(arrays, self.config, device),
        )
        run_epoch = training.device_epoch_runner(
            train_epoch, data, n_train, batch_size, seed
        )
        evaluate_training = (
            self._device_evaluator(data, n_train, batch_size, n_iw, n_mc)
            if full_train_evaluation else None
        )
        return training.run_training_loop(
            train_state=train_state,
            run_epoch=run_epoch,
            evaluate_training=evaluate_training,
            number_of_epochs=number_of_epochs,
            generator=generator,
            steps_per_epoch=n_train // batch_size,
            number_of_warm_up_epochs=self.config.number_of_warm_up_epochs,
            verbose=verbose,
            epoch_callback=epoch_callback,
        )
