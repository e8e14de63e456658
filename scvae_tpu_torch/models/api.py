"""High-level model API: ``VariationalAutoencoder`` with the reference's
``train``, ``evaluate`` and ``sample`` (the port of
``scvae_tpu/models/api.py``).  The model-specific parts are the hooks
``_init_state``, ``_loss_fn``, ``_fused_evaluation``, ``_eval_fn``,
``_evaluation_outputs`` and ``_prior_draws``, which
``GaussianMixtureVariationalAutoencoder`` (``models/gmvae_api.py``)
overrides to run through the same methods.

Training takes one of two data paths, chosen as the JAX package chooses
(``_choose_device_placement``).  A training set whose dense form fits the
device budget is staged on the device once as row-major int16 (a data
set's preprocessed values as float32), and each step gathers a shuffled
minibatch with the row-gather kernel.  A larger one, any set with
``data_placement="streaming"`` and any set with noisy preprocessing streams
from host memory through ``data.pipeline.BatchPipeline``: the host builds
each batch (the native CSR gather, or the padded-COO CSR wire that the step
densifies on the card) while the card runs the step before it.  Both paths
train through the fused likelihood kernels where the likelihood has them
(the unfused path elsewhere, or with ``fused_likelihood=False``).  With a
log directory a run keeps its checkpoints (in the JAX package's format,
with the ``best/`` and ``early_stopping/`` versions), learning curves and
per-epoch vectors under ``<log_directory>/<name>[/run_<id>]``, resumes from
them, and ``evaluate`` and ``sample`` restore them; with
``caches_directory`` it trains in a scratch copy there and is moved back at
the end.  ``evaluate`` reads its set through the pipeline, and its output
sets carry the evaluation set's labels, batch indices, title,
specifications and directory, as the JAX package's do.  Entry points run
on CUDA unless the caller passes ``device="cpu"``; without a GPU they
raise.  On CUDA each training step and each evaluation step of the
per-epoch passes is a replay of a CUDA graph (``models/step.py``); on the
CPU they run eagerly.  The per-epoch evaluation passes, which read the
metrics only, take log p(x|z) on CUDA from the float32 fused forward
where the likelihood has one; ``evaluate`` builds the reconstruction
distribution, whose means it returns.  ``metrics_fetch="deferred"``
fetches each epoch's metrics one epoch late on the device path, as in the
JAX package (``models/training.py``); streaming runs it as "sync", as JAX
does.
Without a log directory the run goes under the default ``models/``
directory, as in the JAX package.  The status methods
(``has_been_trained``, ``better_model_exists``, ``model_stopped_early``,
``number_of_epochs_trained``, ``learning_curves``) read a run's files.
``train(intermediate_analyser=…)`` hands an analyser the training set's
latent means at log-spaced epochs, as the JAX package does.

``train`` and ``evaluate`` take JAX's ``mesh`` / ``devices`` /
``number_of_devices`` / ``model_parallelism`` (and the constructor a
default ``mesh``): a data-parallel mesh over a world of processes, one a
device (``parallel.mesh``; ``torchrun --nproc-per-node N`` for N devices).
Every rank seeds alike, so it starts from the same weights and draws the
same permutations; it stages the whole set and trains on its block of each
batch, which must divide over the ranks (the minibatch is rounded down to
a multiple of their number, as in JAX).  The curves, decisions and
returned sets are the same on every rank, and rank 0 alone writes the
run's files.  With ``model_parallelism`` M above 1 the ranks lie on a
(N / M, M) grid: ``train`` cuts the reconstruction and class heads and
their Adam moments to each rank's gene block after it builds or restores
the train state, runs the likelihood kernels on the block, and hands the
callbacks, the checkpoints and its result the whole state; ``evaluate``
restores the whole state on every rank and cuts the rows only.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.data.dataset import DataSet
from scvae_tpu_torch.data.pipeline import (
    BatchPipeline,
    build_model_arrays,
    device_resident_data,
    narrowest_count_dtype,
)
from scvae_tpu_torch.data.processing import build_preprocessor
from scvae_tpu_torch.data.utilities import indices_for_evaluation_subset
from scvae_tpu_torch.defaults import get_default
from scvae_tpu_torch.models import checkpoints, naming, step, training, vae
from scvae_tpu_torch.models.utilities import (
    parse_numbers_of_samples,
    validate_model_parameters,
)
from scvae_tpu_torch.ops.special import lgamma
from scvae_tpu_torch.parallel import mesh as parallel
from scvae_tpu_torch.utils import tracing
from scvae_tpu_torch.utils.device import resolve_device

_CONFIG_KWARGS = (
    "parameterise_latent_posterior", "analytical_kl_term",
    "inference_architecture", "generative_architecture", "count_sum",
    "dropout_keep_probabilities", "kl_weight", "learning_rate",
    "fused_likelihood", "precision",
)
_SAMPLE_KWARGS = ("number_of_monte_carlo_samples", "number_of_importance_samples")
# Arguments that the constructors check and keep out of the configuration.
_CHECKED_KWARGS = ("mesh",)


def check_constructor_kwargs(kwargs: dict, config_kwargs) -> None:
    """Raise ``TypeError`` for an argument neither model takes.
    ``fused_likelihood`` goes to the configuration (True: the fused
    kernels, False: the unfused path, None: the kernels where they exist);
    ``mesh`` is the default mesh of ``train`` and ``evaluate``."""
    unknown = (set(kwargs) - set(config_kwargs) - set(_SAMPLE_KWARGS)
               - set(_CHECKED_KWARGS))
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")


def _append_lgamma_rowsum(data: dict[str, torch.Tensor], config,
                          chunk: int = 8192) -> dict[str, torch.Tensor]:
    """Stage the per-row Σ_f lgamma(1+t) constants once per dataset.

    The −lgamma(1+t) term is constant in the parameters and additive per
    row, so it is computed here as an (N,) vector, gathered per batch and
    subtracted outside the forward kernel (``vae.fused_log_p_x``), which
    then skips the lgamma chain.  Only for the fused path, and not for the
    constrained Poisson, whose kernel keeps its own lgamma, nor for the
    categorised likelihoods (``k_max`` > 0), whose lgamma sits inside the
    shifted branch and is not row-separable (as in the JAX package)."""
    if (not vae.fused_path_enabled(config) or config.k_max
            or config.reconstruction_distribution == "constrained poisson"):
        return data
    t = data["t"]
    with tracing.span("stage.row_sums"):
        rowsum = torch.cat([
            torch.sum(lgamma(1.0 + t[start:start + chunk].float()), dim=-1)
            for start in range(0, t.shape[0], chunk)
        ])
        if tracing.enabled() and rowsum.is_cuda:
            # only while recording: the span would end at the queueing
            torch.cuda.synchronize(rowsum.device)
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


def mesh_and_device(mesh, devices, number_of_devices, model_parallelism,
                    device) -> tuple[parallel.Mesh | None, torch.device]:
    """The run's mesh (``parallel.resolve_mesh``, JAX's rules) and its
    device: the mesh's on a mesh, else ``device`` (CUDA by default)."""
    device = resolve_device(device)
    mesh = parallel.resolve_mesh(mesh, devices, number_of_devices,
                                 model_parallelism, device=device)
    return mesh, (device if mesh is None else mesh.device)


def _genes(mesh):
    """The mesh's gene split (``parallel.GeneSplit``), or None."""
    return None if mesh is None else mesh.genes


def mesh_minibatch_size(batch_size: int, mesh) -> int:
    """A minibatch that the data axis divides, to cut over it (JAX
    ``api.py:751-755``)."""
    shards = 1 if mesh is None else mesh.shape["data"]
    return max(shards, (batch_size // shards) * shards)


def _place(params, model_state, optimizer, device) -> step.TrainState:
    to_device = lambda x: x.to(device)  # noqa: E731
    return step.create_train_state(
        step.tree_map(to_device, params),
        step.tree_map(to_device, model_state),
        optimizer,
    )


def _output_versions(output_versions) -> list[str]:
    if output_versions == "all":
        return ["transformed", "reconstructed", "latent"]
    if isinstance(output_versions, str):
        return [output_versions]
    return list(output_versions)


class VariationalAutoencoder:
    """VAE with the reference's ``train``, ``evaluate`` and ``sample``."""

    type = "VAE"
    early_stopping_rounds = training.EARLY_STOPPING_ROUNDS
    # Data sets whose dense device form fits under this budget are staged on
    # the device once; larger ones stream from host memory.
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
        check_constructor_kwargs(kwargs, _CONFIG_KWARGS)

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
        reconstruction_distribution = default(
            reconstruction_distribution, "models", "reconstruction_distribution")
        number_of_reconstruction_classes = default(
            number_of_reconstruction_classes, "models",
            "number_of_reconstruction_classes")
        latent_distribution = (
            latent_distribution
            or get_default("models", "latent_distribution")[self.type])
        validate_model_parameters(
            reconstruction_distribution=reconstruction_distribution,
            number_of_reconstruction_classes=number_of_reconstruction_classes,
            model_type=self.type,
            latent_distribution=latent_distribution,
            parameterise_latent_posterior=config_kwargs.get(
                "parameterise_latent_posterior",
                get_default("models", "parameterise_latent_posterior")),
        )
        self.config = vae.VAEConfig(
            feature_size=feature_size,
            latent_size=default(latent_size, "models", "latent_size"),
            hidden_sizes=tuple(default(hidden_sizes, "models", "hidden_sizes")),
            reconstruction_distribution=reconstruction_distribution,
            number_of_reconstruction_classes=number_of_reconstruction_classes,
            latent_distribution=latent_distribution,
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
        self.base_log_directory = default(log_directory, "models", "directory")
        self.mesh = kwargs.get("mesh")
        self.stopped_early = None

    # -- identity ----------------------------------------------------------

    @property
    def latent_distribution_name(self) -> str:
        return self.config.latent_distribution

    @property
    def number_of_latent_clusters(self) -> int:
        return 1

    @property
    def dropout_parts(self) -> list[str]:
        return [str(p) for p in self.config.dropout_keep_probabilities
                if p and p != 1]

    def _name_parts(self) -> dict[str, Any]:
        """The arguments of ``naming.model_name`` that depend on the model
        type."""
        return dict(
            parameterise_latent_posterior=(
                self.config.parameterise_latent_posterior),
            inference_architecture=self.config.inference_architecture,
            generative_architecture=self.config.generative_architecture,
            analytical_kl_term=self.config.analytical_kl,
        )

    @property
    def name(self) -> str:
        """The hyperparameter-addressed name, the JAX package's string."""
        config = self.config
        return naming.model_name(
            self.type,
            latent_distribution=config.latent_distribution,
            number_of_latent_clusters=self.number_of_latent_clusters,
            reconstruction_distribution=config.reconstruction_distribution,
            k_max=config.k_max,
            use_count_sum_as_feature=config.count_sum,
            latent_size=config.latent_size,
            hidden_sizes=config.hidden_sizes,
            number_of_monte_carlo_samples=(
                self.number_of_monte_carlo_samples["training"]),
            number_of_importance_samples=(
                self.number_of_importance_samples["training"]),
            minibatch_normalisation=config.minibatch_normalisation,
            batch_correction=config.batch_correction,
            dropout_parts=self.dropout_parts,
            kl_weight=config.kl_weight,
            number_of_warm_up_epochs=config.number_of_warm_up_epochs,
            **self._name_parts(),
        )

    def log_directory(self, base: str | None = None, run_id: str | None = None,
                      early_stopping: bool = False,
                      best_model: bool = False) -> str:
        base = base or self.base_log_directory
        return naming.log_directory(base, self.name, run_id=run_id,
                                    early_stopping=early_stopping,
                                    best_model=best_model)

    # -- status (JAX ``api.py:364-400``; they only read the run's files) ---

    def _version_exists(self, run_id: str | None, **version) -> bool:
        checkpoints.wait_for_pending_writes()
        return checkpoints.checkpoint_exists(
            self.log_directory(run_id=run_id, **version))

    def has_been_trained(self, run_id: str | None = None) -> bool:
        return self._version_exists(run_id)

    def better_model_exists(self, run_id: str | None = None) -> bool:
        return self._version_exists(run_id, best_model=True)

    def model_stopped_early(self, run_id: str | None = None) -> bool:
        return self._version_exists(run_id, early_stopping=True)

    def number_of_epochs_trained(self, run_id: str | None = None,
                                 early_stopping: bool = False,
                                 best_model: bool = False) -> int:
        return training.resume_start_epoch(self.log_directory(
            run_id=run_id, early_stopping=early_stopping,
            best_model=best_model))

    def learning_curves(
        self, run_id: str | None = None
    ) -> dict[str, dict[str, list[float]]]:
        """Per-epoch curves of each set ("training", "validation"), a GMVAE's
        ``accuracy`` among them, as the run's ``learning_curves.json``
        holds them."""
        checkpoints.wait_for_pending_writes()
        return checkpoints.load_learning_curves(
            self.log_directory(run_id=run_id))

    # -- model hooks -------------------------------------------------------

    def _init_state(self, generator: torch.Generator, optimizer,
                    device: torch.device) -> step.TrainState:
        """Parameters drawn from the CPU ``generator``, placed on
        ``device``, with ``optimizer``'s state."""
        return _place(*vae.init(self.config, generator), optimizer, device)

    def _loss_fn(self, n_iw: int, n_mc: int, genes=None):
        """``loss(params, model_state, batch, generator, warm_up_weight,
        shard=None)``; a ``shard`` (``parallel.RowShard``) makes it the
        rank's part of the global batch's loss, ``genes``
        (``parallel.GeneSplit``) reads the parameters as the rank's gene
        block of the heads."""
        config = self.config

        def loss(params, model_state, batch, generator, warm_up_weight,
                 shard=None):
            return vae.loss_fn(
                config, params, model_state, batch, generator,
                n_iw=n_iw, n_mc=n_mc, warm_up_weight=warm_up_weight,
                shard=shard, genes=genes,
            )

        return loss

    def _fused_evaluation(self, device) -> bool:
        """Whether :meth:`_eval_fn`'s metrics take log p(x|z) from the
        float32 fused forward on ``device``: on CUDA, where the
        configuration trains on the fused kernels
        (``vae.fused_path_enabled``); the CPU keeps the unfused path."""
        return (torch.device(device).type == "cuda"
                and vae.fused_path_enabled(self.config))

    def _count_evaluation_pass(self, device) -> None:
        """One evaluation pass of the per-epoch evaluators on ``device``,
        counted as ``eval.fused_passes`` or ``eval.unfused_passes``."""
        tracing.count("eval.fused_passes" if self._fused_evaluation(device)
                      else "eval.unfused_passes")

    def _eval_fn(self, n_iw: int, n_mc: int, genes=None):
        """``evaluate(params, model_state, batch, generator, shard=None) →
        metrics`` of one batch in float32 (``genes`` as in
        :meth:`_loss_fn`): log p(x|z) from the fused forward where
        :meth:`_fused_evaluation`, else from the unfused distribution."""
        config = self.config

        def evaluate(params, model_state, batch, generator, shard=None):
            metrics, _ = vae.elbo_terms(
                config, params, model_state, batch, generator,
                training=False, n_iw=n_iw, n_mc=n_mc, shard=shard,
                genes=genes,
                fused_evaluation=self._fused_evaluation(batch["t"].device),
            )
            return metrics

        return evaluate

    def _evaluation_outputs(self, params, model_state, batch, generator,
                            n_iw: int, n_mc: int,
                            shard=None) -> dict[str, torch.Tensor]:
        return vae.evaluation_outputs(self.config, params, model_state, batch,
                                      generator, n_iw=n_iw, n_mc=n_mc,
                                      shard=shard)

    def _prior_draws(self, params, sample_size: int,
                     generator: torch.Generator, device: torch.device):
        """(z (N, D) drawn from the prior, the draws' clusters or None)."""
        like = torch.zeros((), device=device)
        p_z = vae._build_prior(self.config, like)
        return p_z.sample(generator, (sample_size, self.config.latent_size)), None

    def _latent_values_fn(self):
        """(params, model_state, x) → the latent means of the intermediate
        analyses."""
        config = self.config

        def latents(params, model_state, x):
            return vae.latent_means(config, params, model_state, x)

        return latents

    def _make_intermediate_callback(self, intermediate_analyser,
                                    training_set: DataSet,
                                    number_of_epochs: int,
                                    run_id: str | None,
                                    analyses_directory: str | None,
                                    device: torch.device):
        """An epoch callback that hands ``intermediate_analyser`` the latent
        means of the training set's first min(N, 2,000) rows at log-spaced
        epochs (JAX ``api.py:603-656``; the reference's
        ``variational_autoencoder.py:1479-1547``): the preprocessed values
        where the set has them, densified.  The rows are staged on
        ``device`` once, here, whatever the training data's placement; the
        callback runs eagerly between epochs, outside the captured step,
        and draws no random numbers.  Under a mesh every rank computes the
        latents of all the rows (replicated), and rank 0 alone hands them
        to the analyser, which writes files."""
        from scvae_tpu_torch.utils.profiling import log_spaced_indices

        epochs = set(log_spaced_indices(number_of_epochs).tolist())
        latents_fn = self._latent_values_fn()
        values = (training_set.preprocessed_values
                  if training_set.preprocessed_values is not None
                  else training_set.values)
        rows = values[:min(training_set.number_of_examples, 2000)]
        if scipy.sparse.issparse(rows):
            rows = rows.toarray()
        x = torch.from_numpy(np.asarray(rows, np.float32)).to(device)

        def callback(epoch, train_state, epoch_metrics):
            if epoch not in epochs:
                return
            latent_values = latents_fn(train_state.params,
                                       train_state.model_state, x)
            if not checkpoints.is_write_process():
                return
            intermediate_analyser(
                epoch=epoch,
                latent_values=latent_values.cpu().numpy(),
                data_set=training_set,
                model_name=self.name,
                model_type=self.type,
                run_id=run_id,
                analyses_directory=analyses_directory,
            )

        return callback

    # -- internals ---------------------------------------------------------

    def _data_set(self, data) -> DataSet:
        """``data`` as a :class:`DataSet` with the model's features (a raw
        matrix becomes ``DataSet("in-memory", values=data)``)."""
        if not isinstance(data, DataSet):
            data = DataSet("in-memory", values=data)
        if data.number_of_features != self.config.feature_size:
            raise ValueError(
                f"data has {data.number_of_features} features, the model "
                f"{self.config.feature_size}"
            )
        return data

    def _stage(self, arrays, device) -> dict[str, torch.Tensor]:
        return device_resident_data(arrays, device=device,
                                    count_dtype=self.DEVICE_COUNT_DTYPES)

    def _model_arrays(self, data_set: DataSet,
                      noisy_preprocess=None) -> dict[str, Any]:
        """The fields the model's batches need (JAX ``_model_arrays``): the
        binarised targets of a Bernoulli likelihood, the count sums it
        takes as a parameter or a feature, the batch indices of batch
        correction; with ``noisy_preprocess`` a fresh noisy copy of the
        values as inputs and targets."""
        config = self.config
        return build_model_arrays(
            data_set,
            use_binarised=config.reconstruction_distribution == "bernoulli",
            use_count_sum_as_parameter=config.use_count_sum_as_parameter,
            use_count_sum_as_feature=config.use_count_sum_as_feature,
            include_batch_indices=config.batch_correction,
            noisy_preprocess=noisy_preprocess,
        )

    def _choose_device_placement(self, training_set: DataSet,
                                 data_placement: str) -> bool:
        """True: stage the training set on the device; False: stream it
        (JAX ``_choose_device_placement``).  "auto" stages it when its
        dense form fits ``DEVICE_DATA_BUDGET_BYTES``, sized from the
        preprocessed values when the set has them, else the values, at
        the narrowest of ``DEVICE_COUNT_DTYPES`` that holds them (4 bytes
        an entry for values that are not integral)."""
        if data_placement == "device":
            return True
        if data_placement == "streaming":
            return False
        if data_placement != "auto":
            raise ValueError(
                "data_placement must be auto, device, or streaming")
        n = training_set.number_of_examples or 0
        f = training_set.number_of_features or 0
        itemsize = 4
        values = getattr(training_set, "preprocessed_values", None)
        if values is None:
            values = training_set.values
        if values is not None:
            dtype = narrowest_count_dtype(values, self.DEVICE_COUNT_DTYPES)
            if dtype is not None:
                itemsize = np.dtype(dtype).itemsize
        return n * f * itemsize <= self.DEVICE_DATA_BUDGET_BYTES

    def _scaled_minibatch_size(self, minibatch_size: int, scenario: str) -> int:
        """Keep the flattened sample×batch constant (reference :807-811)."""
        scale = (
            self.number_of_importance_samples[scenario]
            * self.number_of_monte_carlo_samples[scenario]
        )
        return max(1, int(np.floor(minibatch_size / scale)))

    def _device_evaluator(self, data: dict[str, torch.Tensor], n: int,
                          batch_size: int, n_iw: int, n_mc: int, mesh=None):
        """Full-pass evaluation in float32 through :meth:`_eval_fn` (the
        fused forward on CUDA where the configuration has it): the
        sequential full batches through ``step.make_eval_epoch`` (graph
        replays on CUDA; under a ``mesh`` each rank's block of each), then
        one remainder batch, whole on every rank (replicated), weighted by
        rows like the JAX package.  Each pass is counted
        (:meth:`_count_evaluation_pass`)."""
        device = next(iter(data.values())).device
        idx = torch.from_numpy(step.sequential_batches(n, batch_size)).to(device)
        n_full = int(idx.numel())
        keys = step.EVAL_METRIC_KEYS
        eval_fn = self._eval_fn(n_iw, n_mc, _genes(mesh))
        eval_epoch = step.make_eval_epoch(eval_fn, keys, mesh=mesh)

        def evaluate(ts: step.TrainState, generator: torch.Generator):
            self._count_evaluation_pass(device)
            out = {k: 0.0 for k in keys}
            if n_full:
                means = eval_epoch(ts.params, ts.model_state, data, idx,
                                   generator)
                out = {k: means[k] * (n_full / n) for k in keys}
            if n > n_full:
                tail = {k: v[n_full:n] for k, v in data.items()}
                with torch.no_grad():
                    metrics = eval_fn(ts.params, ts.model_state,
                                      step.cast_batch_to_f32(tail), generator)
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
        count matrix with cells as rows) on ``device`` (CUDA by default),
        evaluating ``validation_set`` each epoch for early stopping.  With a
        log directory the run resumes from its checkpoint unless
        ``reset_training``; ``new_run`` gives it a new run id.
        ``metrics_fetch``: "sync", or "deferred" to process each epoch's
        results while the next epoch trains (the same curves and files).
        ``data_placement``: "device", "streaming" or "auto" (see the module
        docstring); ``caches_directory``: train in a scratch copy of the
        log directory under it; ``intermediate_analyser(epoch=…,
        latent_values=…, data_set=…, model_name=…, model_type=…, run_id=…,
        analyses_directory=…)`` is called at log-spaced epochs with the
        latent means of the training set's first 2,000 rows, before
        ``epoch_callback``.  ``mesh`` (else the constructor's), ``devices``,
        ``number_of_devices``, ``model_parallelism``: data parallel over a
        world of processes (see the module docstring)."""
        if data_placement not in ("auto", "device", "streaming"):
            raise ValueError("data_placement must be auto, device, or streaming")
        if metrics_fetch not in ("sync", "deferred"):
            raise ValueError("metrics_fetch must be 'sync' or 'deferred'")
        mesh, device = mesh_and_device(
            mesh if mesh is not None else self.mesh, devices,
            number_of_devices, model_parallelism, device)
        training_set = self._data_set(training_set)
        if validation_set is not None:
            validation_set = self._data_set(validation_set)
        if number_of_epochs is None:
            number_of_epochs = get_default("models", "number_of_epochs")
        if minibatch_size is None:
            minibatch_size = get_default("models", "minibatch_size")
        if learning_rate is None:
            learning_rate = self.config.learning_rate

        n_train = training_set.number_of_examples
        n_iw = self.number_of_importance_samples["training"]
        n_mc = self.number_of_monte_carlo_samples["training"]
        batch_size = mesh_minibatch_size(
            self._scaled_minibatch_size(minibatch_size, "training"), mesh)
        noisy = None
        if training_set.noisy_preprocessing_methods:
            noisy = build_preprocessor(
                training_set.noisy_preprocessing_methods, noisy=True)
        # noisy preprocessing draws new values every epoch: it streams
        use_device_data = noisy is None and self._choose_device_placement(
            training_set, data_placement)
        if use_device_data and n_train < batch_size:
            raise ValueError(
                f"minibatch of {batch_size} rows exceeds the {n_train} "
                "training examples"
            )

        if new_run and not run_id:
            run_id = naming.generate_run_id()
        log_dir = self.log_directory(run_id=run_id)
        # With a caches directory the run trains in a scratch copy of its
        # log directory there and is moved back afterwards (the reference's
        # temporary log directory, JAX ``api.py:710-724, 924-931``).
        # Under a mesh rank 0 alone writes the run directory, and every rank
        # waits for it at the barriers below before it reads the directory.
        write = checkpoints.is_write_process()
        permanent_log_dir = None
        if caches_directory:
            permanent_log_dir = log_dir
            log_dir = naming.log_directory(caches_directory, self.name,
                                           run_id=run_id)
            if (write and os.path.exists(permanent_log_dir)
                    and not os.path.exists(log_dir)):
                shutil.copytree(permanent_log_dir, log_dir)
        self._active_log_directory = log_dir
        if intermediate_analyser is not None:
            intermediate_callback = self._make_intermediate_callback(
                intermediate_analyser, training_set, number_of_epochs,
                run_id, analyses_directory, device)
            user_callback = epoch_callback

            def epoch_callback(epoch, train_state, epoch_metrics):
                intermediate_callback(epoch, train_state, epoch_metrics)
                if user_callback is not None:
                    user_callback(epoch, train_state, epoch_metrics)

        if reset_training and write and os.path.exists(log_dir):
            shutil.rmtree(log_dir)
        if mesh is not None:
            mesh.barrier()

        optimizer = step.make_optimizer(learning_rate)
        genes = _genes(mesh)
        train_state = self._init_state(
            torch.Generator().manual_seed(seed), optimizer, device
        )
        generator = torch.Generator(device=device).manual_seed(seed)
        start_epoch = training.resume_start_epoch(log_dir)
        if start_epoch:
            train_state, metadata = checkpoints.restore_checkpoint(
                log_dir, train_state)
            # a checkpoint that the JAX package wrote has no generator state
            if "generator_state" in metadata:
                training.set_generator_state(generator,
                                             metadata["generator_state"])
            checkpoints.truncate_learning_curves(log_dir, start_epoch)
            checkpoints.truncate_centroids(log_dir, start_epoch)
            checkpoints.truncate_array_series(log_dir, start_epoch)
            if mesh is not None:
                mesh.barrier()
            if verbose:
                print(f"Resuming training from epoch {start_epoch}.")
        placements = None
        if mesh is not None:
            # each rank's gene block of the heads and their Adam moments,
            # by the placements of the whole state, which the loop's
            # rebuild of the whole state reads
            placements = parallel.param_shardings(train_state.params, mesh)
            train_state = parallel.shard_train_state(train_state, mesh)

        if use_device_data:
            with tracing.span("train.stage"):
                arrays = self._model_arrays(training_set)
                data = _append_lgamma_rowsum(self._stage(arrays, device),
                                             self.config)
                with tracing.span("stage.batch_dtypes"):
                    batch_dtypes = _bf16_batch_dtypes(arrays, self.config,
                                                      device)
                validation_data = None
                if validation_set is not None:
                    validation_data = self._stage(
                        self._model_arrays(validation_set), device)
            train_epoch = step.make_train_epoch(
                self._loss_fn(n_iw, n_mc, genes), optimizer,
                batch_dtypes=batch_dtypes,
                mesh=mesh,
            )
            run_epoch = training.device_epoch_runner(
                train_epoch, data, n_train, batch_size, seed,
                lazy=metrics_fetch == "deferred",
            )
            evaluate_training = (
                self._device_evaluator(data, n_train, batch_size, n_iw, n_mc,
                                       mesh)
                if full_train_evaluation else None
            )
            evaluate_validation = None
            if validation_data is not None:
                evaluate_validation = self._device_evaluator(
                    validation_data, validation_set.number_of_examples,
                    batch_size, n_iw, n_mc, mesh)
            steps_per_epoch = n_train // batch_size
        else:
            run_epoch, evaluate_training, evaluate_validation = (
                self._streaming_runners(
                    training_set, validation_set, noisy, optimizer,
                    batch_size, seed, full_train_evaluation, n_iw, n_mc,
                    device, mesh))
            steps_per_epoch = -(-n_train // batch_size)
            # each step's batch is fed from the host: no fetch to defer
            metrics_fetch = "sync"
        result = training.run_training_loop(
            train_state=train_state,
            run_epoch=run_epoch,
            evaluate_training=evaluate_training,
            evaluate_validation=evaluate_validation,
            number_of_epochs=number_of_epochs,
            generator=generator,
            steps_per_epoch=steps_per_epoch,
            number_of_warm_up_epochs=self.config.number_of_warm_up_epochs,
            log_directory=log_dir,
            early_stopping_rounds=self.early_stopping_rounds,
            start_epoch=start_epoch,
            verbose=verbose,
            epoch_callback=epoch_callback,
            fetch_mode=metrics_fetch,
            placements=placements,
        )
        self.stopped_early = result.stopped_early
        if permanent_log_dir is not None and write:
            checkpoints.wait_for_pending_writes()
            if os.path.exists(permanent_log_dir):
                shutil.rmtree(permanent_log_dir)
            shutil.copytree(log_dir, permanent_log_dir)
            shutil.rmtree(log_dir)
        if mesh is not None:
            mesh.barrier()
        return result

    def _streaming_runners(self, training_set, validation_set, noisy,
                           optimizer, batch_size, seed,
                           full_train_evaluation, n_iw, n_mc, device,
                           mesh=None):
        """(epoch runner, training evaluator, validation evaluator) for data
        streamed from the host (JAX ``api.py:854-901``).  Each epoch builds
        a pipeline shuffled from ``seed + epoch``; under noisy
        preprocessing each such pipeline draws new values and ships them
        as float32; the full training-set evaluation reads the pipeline of
        epoch 0 (drawing again under noise), the validation set its own
        values in order.  The NB row constants are summed in each step.
        Under a ``mesh`` each rank builds its block of every batch that the
        ranks divide (A8.3, the mesh wire) and the rest whole."""
        count_dtype = None if noisy is not None else self.DEVICE_COUNT_DTYPES
        sharding = None if mesh is None else parallel.batch_sharding(mesh)

        def make_training_pipeline(epoch: int) -> BatchPipeline:
            arrays = self._model_arrays(training_set, noisy_preprocess=noisy)
            return BatchPipeline(arrays, batch_size, shuffle=True,
                                 seed=seed + epoch, sharding=sharding,
                                 count_dtype=count_dtype, device=device)

        genes = _genes(mesh)
        train_step = step.make_train_step(self._loss_fn(n_iw, n_mc, genes),
                                          optimizer)
        eval_step = step.make_eval_step(self._eval_fn(n_iw, n_mc, genes))
        run_epoch = training.streaming_epoch_runner(train_step,
                                                    make_training_pipeline)
        evaluate_training = None
        if full_train_evaluation:
            def evaluate_training(train_state, generator):
                self._count_evaluation_pass(device)
                return training.evaluate_on_pipeline(
                    eval_step, train_state, make_training_pipeline(0),
                    generator)
        evaluate_validation = None
        if validation_set is not None:
            validation_arrays = self._model_arrays(validation_set)

            def evaluate_validation(train_state, generator):
                self._count_evaluation_pass(device)
                return training.evaluate_on_pipeline(
                    eval_step, train_state,
                    BatchPipeline(validation_arrays, batch_size,
                                  shuffle=False, sharding=sharding,
                                  count_dtype=self.DEVICE_COUNT_DTYPES,
                                  device=device),
                    generator)
        return run_epoch, evaluate_training, evaluate_validation

    # -- evaluate ----------------------------------------------------------

    def _restore(self, run_id: str | None, use_early_stopping_model: bool,
                 use_best_model: bool,
                 device: torch.device) -> tuple[step.TrainState, str]:
        """The stored train state of a version of a run, on ``device``."""
        directory = self.log_directory(
            run_id=run_id, early_stopping=use_early_stopping_model,
            best_model=use_best_model)
        if not checkpoints.checkpoint_exists(directory):
            raise FileNotFoundError(
                f"No checkpoint found in {directory}; train the model first."
            )
        template = self._init_state(
            torch.Generator().manual_seed(0),
            step.make_optimizer(self.config.learning_rate), device)
        train_state, _ = checkpoints.restore_checkpoint(directory, template)
        return train_state, directory

    def _evaluation_pass(self, evaluation_set: DataSet, minibatch_size,
                         run_id, use_early_stopping_model, use_best_model,
                         evaluation_subset_indices, seed, device, mesh,
                         metric_keys, row_keys):
        """``_evaluation_outputs`` over the set in sequential batches read
        through a :class:`BatchPipeline` (the narrow count dtypes and the
        CSR wire where they pay, two batches built ahead), as JAX reads
        it: the per-row outputs ``row_keys`` as (N, …) arrays, the
        reconstruction's standard deviations for the evaluation subset only
        (sparse rows, as the reference keeps them for large sets), and the
        row-weighted ``metric_keys``.  Under a ``mesh`` each rank evaluates
        its block of every batch that the data axis divides, then the
        blocks' rows (of the standard deviations, the subset's alone) are
        gathered and their metrics averaged over the data group, so every
        rank holds the whole batch's outputs; the rest run whole on every
        rank."""
        if minibatch_size is None:
            minibatch_size = get_default("models", "minibatch_size")
        n_iw = self.number_of_importance_samples["evaluation"]
        n_mc = self.number_of_monte_carlo_samples["evaluation"]
        batch_size = mesh_minibatch_size(
            self._scaled_minibatch_size(minibatch_size, "evaluation"), mesh)
        train_state, _ = self._restore(run_id, use_early_stopping_model,
                                       use_best_model, device)
        if evaluation_subset_indices is None:
            evaluation_subset_indices = indices_for_evaluation_subset(
                evaluation_set)
        pipeline = BatchPipeline(
            self._model_arrays(evaluation_set), batch_size, shuffle=False,
            sharding=None if mesh is None else parallel.batch_sharding(mesh),
            prefetch=2, count_dtype=self.DEVICE_COUNT_DTYPES, device=device)
        n, f = evaluation_set.number_of_examples, self.config.feature_size
        rows: dict[str, np.ndarray | None] = dict.fromkeys(row_keys)
        p_x_stddev = scipy.sparse.lil_matrix((n, f), dtype=np.float32)
        stddev_of_mean = scipy.sparse.lil_matrix((n, f), dtype=np.float32)
        subset = np.zeros(n, bool)
        subset[np.asarray(evaluation_subset_indices, np.int64)] = True
        totals = dict.fromkeys(metric_keys, 0.0)
        generator = torch.Generator(device=device).manual_seed(seed)
        start = 0
        with torch.no_grad():
            for batch in pipeline.epoch():
                shard = getattr(batch, "shard", None)
                stop = start + parallel.batch_rows(batch)
                out = self._evaluation_outputs(
                    train_state.params, train_state.model_state,
                    step.cast_batch_to_f32(step.materialize_batch(batch)),
                    generator, n_iw, n_mc, shard=shard)
                picked = np.nonzero(subset[start:stop])[0]
                # the evaluation subset's rows of the two standard deviations
                stddevs = torch.cat([out["p_x_stddev"],
                                     out["stddev_of_p_x_given_z_mean"]], -1)
                if shard is None:
                    stddevs = stddevs[torch.from_numpy(picked).to(device)]
                else:
                    averaged = shard.average(
                        [out[key] for key in metric_keys])
                    out = {**dict(zip(metric_keys, averaged)),
                           **{key: mesh.gather_rows(out[key])
                              for key in row_keys}}
                    if picked.size:
                        stddevs = mesh.gather_picked(
                            stddevs, torch.from_numpy(picked), shard)
                for key in row_keys:
                    value = out[key].cpu().numpy()
                    if rows[key] is None:
                        rows[key] = np.empty((n,) + value.shape[1:],
                                             value.dtype)
                    rows[key][start:stop] = value
                if picked.size:
                    both = stddevs.cpu().numpy()
                    p_x_stddev[start + picked] = both[:, :f]
                    stddev_of_mean[start + picked] = both[:, f:]
                for key in metric_keys:
                    totals[key] += float(out[key]) * (stop - start)
                start = stop
        metrics = {key: value / max(n, 1) for key, value in totals.items()}
        return rows, (p_x_stddev, stddev_of_mean), metrics

    def _reconstructed_set(self, evaluation_set: DataSet, values, stddevs):
        total, explained = stddevs
        return DataSet(
            evaluation_set.name,
            title=evaluation_set.title,
            specifications=evaluation_set.specifications,
            values=values,
            total_standard_deviations=total,
            explained_standard_deviations=explained,
            labels=evaluation_set.labels,
            example_names=evaluation_set.example_names,
            feature_names=evaluation_set.feature_names,
            batch_indices=evaluation_set.batch_indices,
            kind=evaluation_set.kind,
            version="reconstructed",
            directory=evaluation_set.directory,
        )

    def _latent_set(self, evaluation_set: DataSet, values, version: str,
                    feature_names):
        return DataSet(
            evaluation_set.name,
            title=evaluation_set.title,
            specifications={},
            values=values,
            labels=evaluation_set.labels,
            example_names=evaluation_set.example_names,
            feature_names=np.asarray(feature_names),
            kind=evaluation_set.kind,
            version=version,
            directory=evaluation_set.directory,
        )

    def evaluate(
        self,
        evaluation_set,
        minibatch_size: int | None = None,
        run_id: str | None = None,
        use_early_stopping_model: bool = False,
        use_best_model: bool = False,
        output_versions: str | list[str] = "all",
        evaluation_subset_indices=None,
        seed: int = 0,
        verbose: bool = True,
        mesh=None,
        devices=None,
        number_of_devices: int | None = None,
        model_parallelism: int | None = None,
        device: torch.device | str | None = None,
    ):
        """Evaluate a stored version of the model on ``evaluation_set``;
        returns the (transformed, reconstructed, latent) data sets that
        ``output_versions`` asks for (one set alone when it names one) and
        keeps the metrics in ``_last_evaluation_metrics``.  Under a mesh
        (``mesh``, else the constructor's, or ``devices`` /
        ``number_of_devices`` / ``model_parallelism``) every rank returns
        the same sets; the rows are cut over the data axis, and with a
        model axis every rank holds the whole heads (the reconstruction
        reads all F genes), as the stored checkpoint holds them."""
        output_versions = _output_versions(output_versions)
        mesh, device = mesh_and_device(
            mesh if mesh is not None else self.mesh, devices,
            number_of_devices, model_parallelism, device)
        evaluation_set = self._data_set(evaluation_set)
        rows, stddevs, metrics = self._evaluation_pass(
            evaluation_set, minibatch_size, run_id, use_early_stopping_model,
            use_best_model, evaluation_subset_indices, seed, device, mesh,
            ("lower_bound", "reconstruction_error", "kl_divergence"),
            ("p_x_mean", "q_z_mean"))
        if verbose:
            print("Evaluation: ELBO {lower_bound:.6g}  ENRE "
                  "{reconstruction_error:.6g}  KL {kl_divergence:.6g}"
                  .format(**metrics))
        self._last_evaluation_metrics = metrics
        output_sets = []
        if "transformed" in output_versions:
            output_sets.append(evaluation_set)
        if "reconstructed" in output_versions:
            output_sets.append(self._reconstructed_set(
                evaluation_set, rows["p_x_mean"], stddevs))
        if "latent" in output_versions:
            output_sets.append(self._latent_set(
                evaluation_set, rows["q_z_mean"], "z",
                [f"latent variable {i + 1}"
                 for i in range(self.config.latent_size)]))
        return output_sets[0] if len(output_sets) == 1 else tuple(output_sets)

    # -- sample ------------------------------------------------------------

    def sample(
        self,
        sample_size: int | None = None,
        minibatch_size: int | None = None,
        run_id: str | None = None,
        use_early_stopping_model: bool = False,
        use_best_model: bool = False,
        seed: int = 0,
        device: torch.device | str | None = None,
    ) -> DataSet:
        """Ancestral sampling from a stored version of the model: z from
        the prior (a GMVAE's: y ~ p(y), then z ~ p(z|y)), then E[x|z]."""
        if (self.config.use_count_sum_as_parameter
                or self.config.use_count_sum_as_feature
                or self.config.batch_correction):
            raise NotImplementedError(
                "Sampling is not implemented with batch correction or count-"
                "sum models (the reference's restriction)."
            )
        if sample_size is None:
            sample_size = get_default("models", "sample_size") or 100
        if minibatch_size is None:
            minibatch_size = get_default("models", "minibatch_size")
        device = resolve_device(device)
        train_state, _ = self._restore(run_id, use_early_stopping_model,
                                       use_best_model, device)
        generator = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            z, clusters = self._prior_draws(train_state.params, sample_size,
                                            generator, device)
            values = np.concatenate([
                vae.decode_means(self.config, train_state.params,
                                 train_state.model_state,
                                 z[i:i + minibatch_size]).cpu().numpy()
                for i in range(0, sample_size, minibatch_size)
            ])
        # a GMVAE's draws are labelled with their clusters, as in JAX
        labels = (None if clusters is None
                  else clusters.cpu().numpy().astype(str))
        return DataSet(
            "samples", title="Model samples", specifications={},
            values=values, labels=labels,
            example_names=np.array([f"sample {i + 1}"
                                    for i in range(sample_size)]),
            feature_names=np.array([f"feature {j + 1}"
                                    for j in range(self.config.feature_size)]),
            kind="sample", version="original")
