"""Gaussian-mixture VAE (M2-style, with the discrete y marginalised
analytically): configuration, parameter init, forward pass and the
y-marginalised ELBO as functions on parameter dicts.

Counterpart of ``scvae_tpu/models/gmvae.py``.  The JAX package ``vmap``s one
parameter set over the K latent clusters; here the cluster axis is a leading
tensor axis:

* q(y|x): an encoder MLP and a K-way logits head;
* q(z|x,y_k): one shared encoder on concat(x, onehot_k), run on (K, B, ·)
  with batch statistics per cluster (``networks.apply_mlp(clusters=True)``).
  Without input dropout the first layer is split, x W[:F] once plus the
  float32 row W[F+k] per cluster;
* p(z|y_k): dense heads on the one-hot y, in float32;
* p(x|z_k): the shared decoder on z (S, K, B, D) → (K, S, B, H), and the
  reconstruction heads;
* y prior: uniform, learned or custom; loss Σ_k q(y=k|x)·[E log p(x|z_k) −
  KL_z,k] − KL_y with a free-nats floor on KL_y (plain means over the
  sample axes, no importance-weighted bound, as the reference).

The decoder's input is z with the one-hot batch indices (batch correction)
and the normalised count sum when asked for.  With the "full-covariance
gaussian mixture" latent, q(z|x,y_k) and p(z|y_k) are full-covariance
Gaussians (``MultivariateNormalTriL``) and the z terms are per-event
log-probabilities.  Training takes the fused likelihood once per step over
all clusters where ``vae.fused_path_enabled``: the flat K2/K3 (or their
categorised instances) on (K·S·B, H) decoder rows against the shared (B, F)
targets, whose rows cycle; the unfused distribution path otherwise.
Evaluation keeps the unfused path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from scvae_tpu_torch.distributions import (
    DISTRIBUTIONS,
    GAUSSIAN_MIXTURE_DISTRIBUTIONS,
    Categorical,
    Categorised,
    parse_distribution,
)
from scvae_tpu_torch.models import networks
from scvae_tpu_torch.models.vae import (
    Batch,
    Params,
    State,
    check_config,
    decoder_extras,
    decoder_input_size,
    fused_log_p_x,
    fused_path_enabled,
    init_reconstruction,
    reconstruction_log_prob,
    resolve_compute_dtype,
    whole_heads,
)


@dataclasses.dataclass(frozen=True)
class GMVAEConfig:
    """Hyperparameters (the JAX ``GMVAEConfig``); ``fused_likelihood`` as
    the port's ``VAEConfig`` reads it."""

    feature_size: int
    latent_size: int = 2
    hidden_sizes: tuple[int, ...] = (100,)
    reconstruction_distribution: str = "poisson"
    number_of_reconstruction_classes: int = 0
    latent_distribution: str = "gaussian mixture"
    number_of_latent_clusters: int = 10
    prior_probabilities_method: str = "uniform"  # uniform | learn | custom
    prior_probabilities: tuple[float, ...] | None = None
    proportion_of_free_nats_for_y_kl_divergence: float = 0.0
    minibatch_normalisation: bool = True
    batch_correction: bool = False
    number_of_batches: int = 1
    count_sum: bool = False
    dropout_keep_probabilities: tuple[float, ...] = ()
    number_of_warm_up_epochs: int = 0
    kl_weight: float = 1.0
    learning_rate: float = 1e-4
    fused_likelihood: bool | None = None
    # Matmul input dtype for TRAINING (see ``VAEConfig.precision``).
    precision: str | None = None

    def __post_init__(self):
        check_config(self)
        object.__setattr__(
            self, "latent_distribution",
            parse_distribution(self.latent_distribution, model_type="GMVAE"),
        )
        if self.prior_probabilities_method == "custom":
            if self.prior_probabilities is None:
                raise ValueError(
                    "Custom prior probabilities require `prior_probabilities`."
                )
            object.__setattr__(
                self, "prior_probabilities",
                tuple(float(p) for p in self.prior_probabilities),
            )

    # -- derived -----------------------------------------------------------

    @property
    def k_max(self) -> int:
        return self.number_of_reconstruction_classes

    @property
    def n_clusters(self) -> int:
        return self.number_of_latent_clusters

    @property
    def use_count_sum_as_parameter(self) -> bool:
        return (
            "constrained" in self.reconstruction_distribution
            or "multinomial" in self.reconstruction_distribution
        )

    @property
    def use_count_sum_as_feature(self) -> bool:
        return self.count_sum

    def decoder_input_size(self) -> int:
        return decoder_input_size(self)

    @property
    def z_posterior_name(self) -> str:
        return GAUSSIAN_MIXTURE_DISTRIBUTIONS[self.latent_distribution][
            "z posterior"]

    @property
    def z_prior_name(self) -> str:
        return GAUSSIAN_MIXTURE_DISTRIBUTIONS[self.latent_distribution][
            "z prior"]

    def _keep_probability(self, i: int) -> float:
        ps = self.dropout_keep_probabilities
        return float(ps[i]) if len(ps) > i and ps[i] else 1.0

    @property
    def dropout_keep_probability_h(self) -> float:
        return self._keep_probability(0)

    @property
    def dropout_keep_probability_x(self) -> float:
        return self._keep_probability(1)

    @property
    def dropout_keep_probability_z(self) -> float:
        return self._keep_probability(2)

    @property
    def dropout_keep_probability_y(self) -> float:
        return self._keep_probability(3)

    @property
    def reconstruction_spec(self):
        return DISTRIBUTIONS[self.reconstruction_distribution]

    def compute_dtype(self, training: bool, device: torch.device | str):
        """Matmul input dtype for this pass (None → full precision)."""
        return resolve_compute_dtype(self.precision, training, device)


# --------------------------------------------------------------------------
# Initialisation
# --------------------------------------------------------------------------


def init(config: GMVAEConfig, generator: torch.Generator) -> tuple[Params, State]:
    """Parameter and batch-norm-state dicts on the CPU, drawn from the CPU
    ``generator``, with the JAX package's tree: ``q_y``, ``q_z``, ``p_z``,
    ``p_y_logits`` (learned y prior only), ``decoder``, ``reconstruction``
    and ``categorised_logits`` (K > 0 only)."""
    params: Params = {}
    state: State = {}
    k = config.n_clusters
    q_y_encoder, state["q_y"] = networks.init_mlp(
        generator, config.feature_size, config.hidden_sizes,
        batch_norm=config.minibatch_normalisation,
    )
    params["q_y"] = {
        "encoder": q_y_encoder,
        "logits": networks.init_dense(generator, config.hidden_sizes[-1], k),
    }
    q_z_encoder, state["q_z"] = networks.init_mlp(
        generator, config.feature_size + k, config.hidden_sizes,
        batch_norm=config.minibatch_normalisation,
    )
    posterior_spec = DISTRIBUTIONS[config.z_posterior_name]
    params["q_z"] = {
        "encoder": q_z_encoder,
        "heads": {
            name: networks.init_dense(generator, config.hidden_sizes[-1],
                                      spec.size_fn(config.latent_size))
            for name, spec in posterior_spec.parameters.items()
        },
    }
    prior_spec = DISTRIBUTIONS[config.z_prior_name]
    params["p_z"] = {
        "heads": {
            name: networks.init_dense(generator, k,
                                      spec.size_fn(config.latent_size))
            for name, spec in prior_spec.parameters.items()
        }
    }
    if config.prior_probabilities_method == "learn":
        params["p_y_logits"] = torch.zeros((k,), dtype=torch.float32)
    params["decoder"], state["decoder"] = networks.init_mlp(
        generator, config.decoder_input_size(),
        tuple(reversed(config.hidden_sizes)),
        batch_norm=config.minibatch_normalisation,
    )
    dec_out = config.hidden_sizes[0]
    params["reconstruction"] = init_reconstruction(config, generator, dec_out)
    if config.k_max:
        params["categorised_logits"] = networks.init_categorised_head(
            generator, dec_out, config.feature_size, config.k_max
        )
    return params, state


# --------------------------------------------------------------------------
# Forward pass
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _custom_prior_logits(probabilities: tuple[float, ...],
                         device: torch.device) -> torch.Tensor:
    """log p(y) of a custom prior, copied to ``device`` once (a training
    step's CUDA graph reads it, and a capture refuses host copies).  Built
    from the immutable configuration, so every caller may share it."""
    return torch.log(torch.tensor(probabilities, dtype=torch.float32,
                                  device=device))


def _p_y_logits(config: GMVAEConfig, params: Params,
                device: torch.device | str = "cpu") -> torch.Tensor:
    if config.prior_probabilities_method == "custom":
        return _custom_prior_logits(config.prior_probabilities,
                                    torch.device(device))
    if config.prior_probabilities_method == "learn":
        return params["p_y_logits"]
    return torch.zeros((config.n_clusters,), dtype=torch.float32,
                       device=device)  # uniform


def _build_theta(spec, heads: Params, h: torch.Tensor,
                 compute_dtype=None) -> dict[str, torch.Tensor]:
    return {
        name: pspec.constrain(
            networks.apply_dense(heads[name], h, compute_dtype=compute_dtype)
        )
        for name, pspec in spec.parameters.items()
    }


@dataclasses.dataclass
class GMVAEOutputs:
    q_y: Categorical  # (B, K)
    p_y: Categorical  # (K,)
    q_z: Any  # posterior per cluster, batch (K, B, D)
    p_z: Any  # prior per cluster, batch (K, 1, D)
    z: torch.Tensor  # samples (S, K, B, D)
    p_x: Any  # reconstruction over (K, S, B, F); None on the fused path
    decoder_hidden: torch.Tensor  # (K, S, B, H)
    new_state: State


def _q_y_logits(params: Params, h_y: torch.Tensor) -> torch.Tensor:
    """q(y|x) logits: a float32 head (no compute dtype, as in JAX)."""
    spec = DISTRIBUTIONS["categorical"].parameters["logits"]
    return spec.constrain(networks.apply_dense(params["q_y"]["logits"], h_y))


def forward(
    config: GMVAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    training: bool,
    n_iw: int = 1,
    n_mc: int = 1,
    build_reconstruction: bool = True,
    noise: torch.Tensor | None = None,
    shard=None,
) -> GMVAEOutputs:
    """q(y|x), q(z|x,y_k) for every cluster, z, the decoder per cluster (and
    the reconstruction distribution).  ``noise`` (S, K, B, D) replaces the
    generator's standard-normal draws for z.  With a ``shard``
    (``parallel.RowShard``) the batch is this rank's rows of a global batch:
    batch norm takes the global batch's statistics (each cluster's), and
    every draw (and ``noise``) is the global batch's, cut to the rank's
    rows."""
    x = batch["x"]
    b = x.shape[0]
    k = config.n_clusters
    s = n_iw * n_mc
    compute_dtype = config.compute_dtype(training, x.device)
    new_state: State = {}

    h_y, new_state["q_y"] = networks.apply_mlp(
        params["q_y"]["encoder"], state.get("q_y", {}), x,
        training=training, generator=generator,
        input_dropout_keep_prob=config.dropout_keep_probability_x,
        hidden_dropout_keep_prob=config.dropout_keep_probability_h,
        compute_dtype=compute_dtype, shard=shard,
    )
    q_y = Categorical(logits=_q_y_logits(params, h_y))
    p_y = Categorical(logits=_p_y_logits(config, params, x.device))

    # q(z|x,y_k) on (K, B, ·), batch statistics per cluster
    eye = torch.eye(k, dtype=x.dtype, device=x.device)
    posterior_spec = DISTRIBUTIONS[config.z_posterior_name]
    encoder = params["q_z"]["encoder"]
    if not (training and config.dropout_keep_probability_x < 1.0):
        # concat(x, y_k) W = x W[:F] + W[F+k]: the (B, F)·(F, H) product
        # once, the one-hot row added in float32 (unrounded)
        layer0 = encoder["layers"][0]
        f = x.shape[-1]
        base_pre0 = networks.apply_dense(
            {"kernel": layer0["kernel"][:f], "bias": layer0["bias"]}, x,
            compute_dtype=compute_dtype,
        )  # (B, H)
        pre0 = base_pre0[None] + layer0["kernel"][f:][:, None, :]  # (K, B, H)
        h_z, new_state["q_z"] = networks.apply_mlp_from_first_preactivation(
            encoder, state.get("q_z", {}), pre0, training=training,
            generator=generator,
            hidden_dropout_keep_prob=config.dropout_keep_probability_h,
            compute_dtype=compute_dtype, clusters=True, shard=shard,
        )
    else:
        xy = torch.cat([x.expand(k, b, x.shape[-1]),
                        eye[:, None, :].expand(k, b, k)], dim=-1)
        h_z, new_state["q_z"] = networks.apply_mlp(
            encoder, state.get("q_z", {}), xy, training=training,
            generator=generator,
            input_dropout_keep_prob=config.dropout_keep_probability_x,
            hidden_dropout_keep_prob=config.dropout_keep_probability_h,
            compute_dtype=compute_dtype, clusters=True, shard=shard,
        )
    q_z = posterior_spec.build(_build_theta(
        posterior_spec, params["q_z"]["heads"], h_z, compute_dtype))

    # p(z|y_k): float32 heads on the one-hot rows, parameters (K, 1, D)
    prior_spec = DISTRIBUTIONS[config.z_prior_name]
    p_z = prior_spec.build(_build_theta(prior_spec, params["p_z"]["heads"],
                                        eye[:, None, :]))

    if shard is not None:
        noise = shard.normal((s,) + tuple(q_z.batch_shape()), generator,
                             q_z.parameters()[0], noise)
    z = q_z.sample(generator, (s,), noise=noise)  # (S, K, B, D)

    # the decoder per cluster: (K, S, B, D [+ extras]) → (K, S, B, H)
    dec_in = z.transpose(0, 1)
    extras = decoder_extras(config, batch, s, z.dtype)
    if extras:
        dec_in = torch.cat(
            [dec_in] + [e.expand((k,) + e.shape) for e in extras], dim=-1)
    dec_h, new_state["decoder"] = networks.apply_mlp(
        params["decoder"], state.get("decoder", {}), dec_in,
        training=training, generator=generator,
        input_dropout_keep_prob=config.dropout_keep_probability_z,
        hidden_dropout_keep_prob=config.dropout_keep_probability_h,
        compute_dtype=compute_dtype, clusters=True, shard=shard,
    )

    p_x = None
    if build_reconstruction:
        recon_spec = config.reconstruction_spec
        count_sum = (batch.get("count_sum")
                     if config.use_count_sum_as_parameter else None)
        p_x = recon_spec.build(
            _build_theta(recon_spec, params["reconstruction"], dec_h,
                         compute_dtype),
            count_sum=count_sum,
        )  # (K, S, B, F)
        if config.k_max:
            logits = networks.apply_categorised_logits(
                params["categorised_logits"], dec_h,
                compute_dtype=compute_dtype,
            )
            p_x = Categorised(dist=p_x, cat=Categorical(logits=logits))

    return GMVAEOutputs(q_y=q_y, p_y=p_y, q_z=q_z, p_z=p_z, z=z, p_x=p_x,
                        decoder_hidden=dec_h, new_state=new_state)


# --------------------------------------------------------------------------
# Objective
# --------------------------------------------------------------------------


def elbo_terms(
    config: GMVAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    training: bool,
    n_iw: int = 1,
    n_mc: int = 1,
    warm_up_weight: float | torch.Tensor = 1.0,  # a 0-d tensor in an epoch
    noise: torch.Tensor | None = None,
    shard=None,
    genes=None,
) -> tuple[dict[str, torch.Tensor], GMVAEOutputs]:
    """The y-marginalised ELBO (reference ``gaussian_mixture_variational_
    autoencoder.py:3223-3434``): ``lower_bound``, ``lower_bound_weighted``
    (the training objective: warm-up·kl_weight on the KL terms and the
    free-nats floor on KL_y), ``reconstruction_error``, ``kl_divergence``,
    ``kl_divergence_z``, ``kl_divergence_y`` and ``kl_divergence_neurons``
    (D,; (1,) for the full-covariance latent, whose z terms are
    per-event).  The fused likelihood is training-only.  With a ``shard``
    (see :func:`forward`) each is the mean over the rank's rows, whose
    average over the ranks is the global batch's value; the free-nats floor
    applies to the global KL_y, averaged over the ranks first.  With
    ``genes`` (a ``parallel.GeneSplit``) ``params`` holds the rank's gene
    block of the heads it cuts: the fused path runs the kernels on the
    block over the K·S groups, the unfused path on the heads gathered
    whole (``vae.whole_heads``)."""
    use_fused = training and fused_path_enabled(config)
    if not use_fused:
        params = whole_heads(config, params, genes)
    outputs = forward(
        config, params, state, batch, generator, training=training,
        n_iw=n_iw, n_mc=n_mc, build_reconstruction=not use_fused,
        noise=noise, shard=shard,
    )
    t = batch["t"]
    k = config.n_clusters
    y_probs = outputs.q_y.probs  # (B, K)
    y_probs_k = y_probs.T  # (K, B)

    # KL_y with the free-nats floor
    if config.prior_probabilities_method == "uniform":
        p_y_entropy = float(np.log(float(k)))
        q_y_entropy = -torch.sum(y_probs * outputs.q_y.log_probs(), dim=-1)
        kl_y_per_example = p_y_entropy - q_y_entropy
    else:
        log_p = outputs.p_y.log_probs()  # (K,)
        kl_y_per_example = torch.sum(
            y_probs * (outputs.q_y.log_probs() - log_p), dim=-1)
        p_y_entropy = -torch.sum(outputs.p_y.probs * log_p)
    kl_divergence_y = torch.mean(kl_y_per_example)
    free_nats = config.proportion_of_free_nats_for_y_kl_divergence
    # the floor added to zeros on the device: a capture refuses host copies
    kl_divergence_y_modified = kl_divergence_y
    if free_nats:
        # a maximum of the mean: the global mean's, on every rank
        kl_global = (kl_divergence_y if shard is None
                     else shard.mean(kl_divergence_y))
        kl_divergence_y_modified = torch.maximum(
            kl_global, torch.zeros_like(kl_global) + free_nats * p_y_entropy)

    # z terms on samples (S, K, B, D): posterior (K, B, D), prior (K, 1, D);
    # the Gaussians give per-dimension log-probabilities, (S, K, B, D), and
    # the full-covariance ones per-event values, (S, K, B): a sampled KL
    log_q_z_raw = outputs.q_z.log_prob(outputs.z)
    log_p_z_raw = outputs.p_z.log_prob(outputs.z)
    per_dimension = log_q_z_raw.dim() == 4
    if per_dimension:
        kl_z_pointwise = torch.sum(log_q_z_raw, dim=-1) - torch.sum(
            log_p_z_raw, dim=-1)  # (S, K, B)
    else:
        kl_z_pointwise = log_q_z_raw - log_p_z_raw
    kl_divergence_z = torch.mean(torch.sum(
        torch.mean(kl_z_pointwise, dim=0) * y_probs_k, dim=0))

    if use_fused:
        # (K, S, B): one launch over the K·S·B decoder rows
        log_p_x = fused_log_p_x(config, params, batch, outputs.decoder_hidden,
                                t, config.compute_dtype(training, t.device),
                                genes)
    else:
        log_p_x = reconstruction_log_prob(config, outputs.p_x, t)
    # (K, S, B) → per-cluster sample means weighted by q(y|x)
    reconstruction_error = torch.mean(torch.sum(
        torch.mean(log_p_x, dim=1) * y_probs_k, dim=0))

    kl_divergence = kl_divergence_z + kl_divergence_y
    lower_bound = reconstruction_error - kl_divergence
    lower_bound_weighted = reconstruction_error - (
        warm_up_weight * config.kl_weight
        * (kl_divergence_z + kl_divergence_y_modified)
    )
    if per_dimension:
        kl_divergence_neurons = torch.mean(torch.sum(
            torch.mean(log_q_z_raw - log_p_z_raw, dim=0)
            * y_probs_k[..., None], dim=0), dim=0)
    else:
        kl_divergence_neurons = kl_divergence_z[None]
    metrics = {
        "lower_bound": lower_bound,
        "lower_bound_weighted": lower_bound_weighted,
        "reconstruction_error": reconstruction_error,
        "kl_divergence": kl_divergence,
        "kl_divergence_z": kl_divergence_z,
        "kl_divergence_y": kl_divergence_y,
        "kl_divergence_neurons": kl_divergence_neurons,
    }
    return metrics, outputs


def loss_fn(
    config: GMVAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    n_iw: int = 1,
    n_mc: int = 1,
    warm_up_weight: float | torch.Tensor = 1.0,  # a 0-d tensor in an epoch
    noise: torch.Tensor | None = None,
    shard=None,
    genes=None,
) -> tuple[torch.Tensor, tuple[dict[str, torch.Tensor], State]]:
    """Training objective: −lower_bound_weighted; with a ``shard`` (the
    rank's row offset and the global batch's size) the rank's part, whose
    average over the data group is the global loss; with ``genes`` on the
    rank's gene block of the heads (see :func:`elbo_terms`)."""
    metrics, outputs = elbo_terms(
        config, params, state, batch, generator, training=True,
        n_iw=n_iw, n_mc=n_mc, warm_up_weight=warm_up_weight, noise=noise,
        shard=shard, genes=genes,
    )
    return -metrics["lower_bound_weighted"], (metrics, outputs.new_state)


def z_prior(config: GMVAEConfig, params: Params):
    """p(z|y=k) of every cluster: a distribution over (K, D)."""
    heads = params["p_z"]["heads"]
    device = heads[next(iter(heads))]["kernel"].device
    eye = torch.eye(config.n_clusters, dtype=torch.float32, device=device)
    prior_spec = DISTRIBUTIONS[config.z_prior_name]
    return prior_spec.build(_build_theta(prior_spec, heads, eye))


def evaluation_outputs(
    config: GMVAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    n_iw: int = 1,
    n_mc: int = 1,
    noise: torch.Tensor | None = None,
    shard=None,
) -> dict[str, torch.Tensor]:
    """The metrics of one batch in evaluation mode and its outputs
    marginalised over y with q(y|x): the reconstruction ``p_x_mean`` (B, F)
    with ``p_x_stddev`` and ``stddev_of_p_x_given_z_mean``, the latent
    means ``q_z_mean`` (B, D), the responsibilities ``y_probs`` (B, K) and
    their mean ``q_y_probabilities`` (K,), the ``cluster_ids`` (B,) and the
    samples ``z`` (S, K, B, D) (reference evaluate loop ``:2336-2786``)."""
    metrics, outputs = elbo_terms(
        config, params, state, batch, generator, training=False,
        n_iw=n_iw, n_mc=n_mc, noise=noise, shard=shard,
    )
    b = batch["t"].shape[0]
    y_probs = outputs.q_y.probs  # (B, K)
    shape = (config.n_clusters, n_iw, n_mc, b, config.feature_size)
    p_mean = outputs.p_x.mean().reshape(shape)
    p_var = outputs.p_x.variance().reshape(shape)
    weights = y_probs.T[..., None]  # (K, B, 1)
    per_cluster = lambda x: torch.mean(torch.mean(x, dim=2), dim=1)  # noqa: E731
    p_x_mean = torch.sum(per_cluster(p_mean) * weights, dim=0)
    variance_of_means = torch.sum(
        per_cluster(torch.square(p_mean - p_x_mean)) * weights, dim=0)
    mean_of_variances = torch.sum(per_cluster(p_var) * weights, dim=0)
    return {
        **metrics,
        "p_x_mean": p_x_mean,
        "p_x_stddev": torch.sqrt(variance_of_means + mean_of_variances),
        "stddev_of_p_x_given_z_mean": torch.sqrt(variance_of_means),
        "q_z_mean": torch.sum(outputs.q_z.mean() * weights, dim=0),
        "q_y_probabilities": torch.mean(y_probs, dim=0),
        "y_probs": y_probs,
        "cluster_ids": torch.argmax(y_probs, dim=-1),
        "z": outputs.z,
    }


def sample_prior(config: GMVAEConfig, params: Params, sample_size: int,
                 generator: torch.Generator | None, *,
                 y_uniforms: torch.Tensor | None = None,
                 noise: torch.Tensor | None = None):
    """Ancestral draws y ~ p(y), z ~ p(z|y): (ys (N,), z (N, D)).
    ``y_uniforms`` (N,) in [0, 1) and ``noise`` (N, K, D) replace the
    generator's draws (tests hand both packages the same draws)."""
    p_z = z_prior(config, params)
    loc = p_z.mean()
    probabilities = torch.softmax(_p_y_logits(config, params, loc.device), -1)
    if y_uniforms is None:
        y_uniforms = torch.rand(sample_size, generator=generator,
                                device=loc.device)
    # the inverse of the cumulative probabilities at the uniform draws
    cumulative = torch.cumsum(probabilities, dim=0)
    ys = torch.searchsorted(cumulative, y_uniforms.to(loc.device),
                            right=True).clamp(max=config.n_clusters - 1)
    z_all = p_z.sample(generator, (sample_size,), noise=noise)  # (N, K, D)
    return ys, z_all[torch.arange(sample_size, device=loc.device), ys]


def prior_centroids(config: GMVAEConfig,
                    params: Params) -> dict[str, np.ndarray]:
    """Mixture probabilities and each cluster's prior z mean and
    covariance matrix (the full one of a full-covariance latent, else the
    diagonal) from the current parameters — the centroid summaries the
    reference logs per epoch."""
    with torch.no_grad():
        p_z = z_prior(config, params)
        probabilities = torch.softmax(
            _p_y_logits(config, params, p_z.mean().device), dim=-1)
        if hasattr(p_z, "covariance"):
            covariances = p_z.covariance().cpu().numpy()
        else:
            var = p_z.variance().cpu().numpy()
            covariances = var[..., :, None] * np.eye(var.shape[-1])
        return {
            "probabilities": probabilities.cpu().numpy(),
            "means": p_z.mean().cpu().numpy(),  # (K, D)
            "covariance_matrices": covariances,
        }


def cluster_ids(params: Params, state: State,
                x: torch.Tensor) -> torch.Tensor:
    """argmax q(y|x) (B,) from the q(y|x) network alone, batch norm in
    inference mode, in float32 (what the JAX package's per-epoch accuracy
    computes, ``scvae_tpu/models/gmvae_api.py:250-260``).  Draws no random
    numbers."""
    with torch.no_grad():
        h_y, _ = networks.apply_mlp(params["q_y"]["encoder"],
                                    state.get("q_y", {}), x, training=False)
        logits = networks.apply_dense(params["q_y"]["logits"], h_y)
        return torch.argmax(logits, dim=-1)


def latent_means(config: GMVAEConfig, params: Params, state: State,
                 x: torch.Tensor) -> torch.Tensor:
    """y-marginalised E[z|x] (B, D) in evaluation mode, without the
    decoder."""
    with torch.no_grad():
        k = config.n_clusters
        b = x.shape[0]
        h_y, _ = networks.apply_mlp(params["q_y"]["encoder"],
                                    state.get("q_y", {}), x, training=False)
        y_probs = torch.softmax(_q_y_logits(params, h_y), dim=-1)  # (B, K)
        eye = torch.eye(k, dtype=x.dtype, device=x.device)
        xy = torch.cat([x.expand(k, b, x.shape[-1]),
                        eye[:, None, :].expand(k, b, k)], dim=-1)
        h, _ = networks.apply_mlp(params["q_z"]["encoder"],
                                  state.get("q_z", {}), xy, training=False)
        posterior_spec = DISTRIBUTIONS[config.z_posterior_name]
        q_z = posterior_spec.build(_build_theta(
            posterior_spec, params["q_z"]["heads"], h))  # (K, B, D)
        return torch.sum(q_z.mean() * y_probs.T[..., None], dim=0)
