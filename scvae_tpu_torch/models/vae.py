"""Variational auto-encoder: configuration, parameter init, forward pass and
ELBO objective as functions on parameter dicts.

Counterpart of ``scvae_tpu/models/vae.py``.  Latent samples keep an explicit
leading sample axis (S = R·L, B, ·).  The encoder and the decoder are MLPs or
linear factor models ("LFM": the encoder's output is x itself, the decoder's
its input); the decoder's input is z, with the one-hot batch indices (batch
correction) and the normalised count sum when asked for.  Training takes the
fused likelihood where a kernel exists and ``fused_likelihood`` does not say
False (:func:`scvae_tpu_torch.ops.fused_log_likelihood` and
:func:`~scvae_tpu_torch.ops.fused_categorised_log_likelihood`: kernels K2/K3,
their categorised instances or K6/K7 on CUDA, their plain versions on the
CPU), and the unfused distribution path otherwise: every other likelihood of
the registry, and categorised ones over 32 heads.  Evaluation keeps the
unfused path, as the JAX package does: ``evaluation_outputs`` gives a
batch's metrics, the posterior-predictive reconstruction with its standard
deviations and the latent means, and ``decode_means`` the reconstruction
means of given z (ancestral sampling).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from scvae_tpu_torch import ops
from scvae_tpu_torch.distributions import (
    DISTRIBUTIONS,
    LATENT_DISTRIBUTIONS,
    Categorical,
    Categorised,
    kl_divergence,
    parse_distribution,
)
from scvae_tpu_torch.models import networks
from scvae_tpu_torch.models.objectives import log_reduce_exp
from scvae_tpu_torch.ops.special import lgamma

Params = dict[str, Any]
State = dict[str, Any]
Batch = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Hyperparameters (the JAX ``VAEConfig``).  ``fused_likelihood``:
    True trains on the fused kernels and raises ``ValueError`` where the
    likelihood has none, False trains unfused, None takes the kernels where
    they exist and the unfused path elsewhere (JAX's None also turns the
    kernels off off the TPU; the port has them on every device)."""

    feature_size: int
    latent_size: int = 2
    hidden_sizes: tuple[int, ...] = (100,)
    reconstruction_distribution: str = "negative binomial"
    number_of_reconstruction_classes: int = 0
    latent_distribution: str = "gaussian"
    parameterise_latent_posterior: bool = False
    analytical_kl_term: bool | None = None  # None → derived like the reference
    inference_architecture: str = "MLP"
    generative_architecture: str = "MLP"
    minibatch_normalisation: bool = True
    batch_correction: bool = False
    number_of_batches: int = 1
    count_sum: bool = False
    dropout_keep_probabilities: tuple[float, ...] = ()
    number_of_warm_up_epochs: int = 0
    kl_weight: float = 1.0
    learning_rate: float = 1e-4
    fused_likelihood: bool | None = None
    # Matmul input dtype for TRAINING: None → "bfloat16" on CUDA and
    # "float32" on the CPU; evaluation always runs float32.
    precision: str | None = None

    def __post_init__(self):
        check_config(self)
        object.__setattr__(
            self, "latent_distribution",
            parse_distribution(self.latent_distribution, model_type="VAE"),
        )
        for name in ("inference_architecture", "generative_architecture"):
            if getattr(self, name) not in ("MLP", "LFM"):
                raise ValueError(
                    f"The {name.split('_')[0]} architecture can only be MLP "
                    "or LFM.")
        if self.parameterise_latent_posterior:
            # the reference's cross-parameter validation: only a GMVAE's
            # mixture posterior may be parameterised by its prior
            raise ValueError(
                "Cannot parameterise latent posterior parameters for VAE or "
                f"{self.latent_distribution} distribution."
            )

    @property
    def k_max(self) -> int:
        return self.number_of_reconstruction_classes

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
        """z, plus the batch one-hots and the count sum when asked for."""
        return decoder_input_size(self)

    @property
    def analytical_kl(self) -> bool:
        if self.analytical_kl_term is not None:
            return self.analytical_kl_term
        return self.latent_distribution == "gaussian"

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
    def latent_spec(self) -> dict[str, Any]:
        return LATENT_DISTRIBUTIONS[self.latent_distribution]

    @property
    def reconstruction_spec(self):
        return DISTRIBUTIONS[self.reconstruction_distribution]

    def compute_dtype(self, training: bool, device: torch.device | str):
        """Matmul input dtype for this pass (None → full precision)."""
        return resolve_compute_dtype(self.precision, training, device)


def check_config(config) -> None:
    """What a VAE's and a GMVAE's configurations check alike: the names,
    the tuples, the precision and the ``fused_likelihood`` switch."""
    object.__setattr__(
        config, "reconstruction_distribution",
        parse_distribution(config.reconstruction_distribution),
    )
    object.__setattr__(config, "hidden_sizes", tuple(config.hidden_sizes))
    object.__setattr__(
        config, "dropout_keep_probabilities",
        tuple(config.dropout_keep_probabilities),
    )
    if config.reconstruction_distribution == "categorical":
        # its logits span the features, which the targets' per-feature
        # values do not index (the JAX package's VAE fails on the shapes)
        raise ValueError("The categorical distribution is not a "
                         "reconstruction distribution.")
    fused_path_enabled(config)  # validates the switch
    resolve_compute_dtype(config.precision, True, "cpu")  # validates the name


def decoder_input_size(config) -> int:
    size = config.latent_size
    if config.batch_correction:
        size += config.number_of_batches
    if config.count_sum:
        size += 1
    return size


def fused_path_enabled(config) -> bool:
    """Whether training takes the fused likelihood (JAX
    ``_fused_path_enabled``): never with ``fused_likelihood=False``; where
    the likelihood has no kernel (neither a base family nor the constrained
    Poisson, or categorised over :data:`~scvae_tpu_torch.ops.MAX_FUSED_HEADS`
    heads), True raises ``ValueError`` and None trains unfused; otherwise
    True and None both take the kernels."""
    if config.fused_likelihood is False:
        return False
    if not ops.supports_fused_likelihood(config.reconstruction_distribution,
                                         config.k_max):
        if config.fused_likelihood:
            raise ValueError(
                "fused_likelihood=True but "
                f"{config.reconstruction_distribution!r} (k_max="
                f"{config.k_max}) has no fused kernel")
        return False
    return True


def resolve_compute_dtype(precision: str | None, training: bool,
                          device: torch.device | str):
    """bf16 matmul inputs for training on CUDA (f32 accumulation); full f32
    for evaluation and on the CPU unless explicitly requested."""
    if precision is None:
        precision = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    if precision in ("float32", "highest", "f32"):
        return None
    if precision not in ("bfloat16", "bf16"):
        raise ValueError(f"Unknown precision {precision!r}")
    return torch.bfloat16 if training else None


# --------------------------------------------------------------------------
# Initialisation
# --------------------------------------------------------------------------


def init_reconstruction(config, generator: torch.Generator,
                        dec_out: int) -> Params:
    """The reconstruction heads on a decoder output of width ``dec_out``,
    each ``size_fn(F)`` wide: F, and F(F+1)/2 for the multivariate
    Gaussian's triangular scales (the JAX package's init makes every head F
    wide, which that likelihood's ``fill_triangular`` refuses)."""
    return {
        name: networks.init_dense(generator, dec_out,
                                  spec.size_fn(config.feature_size))
        for name, spec in config.reconstruction_spec.parameters.items()
    }


def init(config: VAEConfig, generator: torch.Generator) -> tuple[Params, State]:
    """Parameter and batch-norm-state dicts on the CPU, drawn from the CPU
    ``generator`` (the same seed gives the same weights on every device).
    An LFM encoder or decoder has no parameters and no ``encoder`` or
    ``decoder`` subtree."""
    params: Params = {}
    state: State = {}
    if config.inference_architecture == "MLP":
        params["encoder"], state["encoder"] = networks.init_mlp(
            generator, config.feature_size, config.hidden_sizes,
            batch_norm=config.minibatch_normalisation,
        )
        enc_out = config.hidden_sizes[-1]
    else:
        enc_out = config.feature_size

    posterior_spec = config.latent_spec["posterior"]
    post_dist = DISTRIBUTIONS[posterior_spec["name"]]
    params["posterior"] = {
        name: networks.init_dense(
            generator, enc_out, spec.size_fn(config.latent_size)
        )
        for name, spec in post_dist.parameters.items()
        if name not in posterior_spec["parameters"]
    }
    params["prior"] = {}

    if config.generative_architecture == "MLP":
        params["decoder"], state["decoder"] = networks.init_mlp(
            generator, config.decoder_input_size(),
            tuple(reversed(config.hidden_sizes)),
            batch_norm=config.minibatch_normalisation,
        )
        dec_out = config.hidden_sizes[0]
    else:
        dec_out = config.decoder_input_size()

    params["reconstruction"] = init_reconstruction(config, generator, dec_out)
    if config.k_max:
        params["categorised_logits"] = networks.init_categorised_head(
            generator, dec_out, config.feature_size, config.k_max,
        )
    return params, state


# --------------------------------------------------------------------------
# Forward pass
# --------------------------------------------------------------------------


@dataclasses.dataclass
class VAEOutputs:
    q_z: Any  # posterior, batch (B, D)
    p_z: Any  # prior
    z: torch.Tensor  # latent samples (S, B, D)
    p_x: Any  # reconstruction distribution over (S, B, F); None on the fused path
    decoder_hidden: torch.Tensor  # (S, B, H)
    new_state: State


def _constant(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, filled there: no host copy,
    which a CUDA graph's capture refuses."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _build_posterior(config: VAEConfig, params: Params, h: torch.Tensor,
                     compute_dtype=None):
    posterior_spec = config.latent_spec["posterior"]
    dist_spec = DISTRIBUTIONS[posterior_spec["name"]]
    theta: dict[str, torch.Tensor] = {}
    for name, spec in dist_spec.parameters.items():
        if name in posterior_spec["parameters"]:
            theta[name] = _constant(posterior_spec["parameters"][name], h)
            continue
        theta[name] = spec.constrain(networks.apply_dense(
            params["posterior"][name], h, compute_dtype=compute_dtype
        ))
    return dist_spec.build(theta)


def _build_prior(config: VAEConfig, like: torch.Tensor):
    prior_spec = config.latent_spec["prior"]
    dist_spec = DISTRIBUTIONS[prior_spec["name"]]
    return dist_spec.build({
        name: _constant(prior_spec["parameters"][name], like)
        for name in dist_spec.parameters
    })


def one_hot(indices: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` of integer-valued ``indices`` of any dtype (the
    staged batch indices come out of the row gather as float32, which
    ``F.one_hot`` does not take): a row of zeros where an index is outside
    [0, n)."""
    classes = torch.arange(n, device=indices.device, dtype=indices.dtype)
    return (indices[..., None] == classes).to(dtype)


def decoder_extras(config, batch: Batch, s: int,
                   dtype) -> list[torch.Tensor]:
    """The decoder's inputs beside z, broadcast over ``s`` samples (JAX
    ``_decoder_inputs``): the one-hot batch indices (S, B, n_batches) with
    batch correction, the normalised count sum (S, B, 1) with the count
    sum feature."""
    extras = []
    if config.batch_correction:
        onehot = one_hot(batch["batch_indices"][..., 0],
                         config.number_of_batches, dtype)
        extras.append(onehot.expand((s,) + onehot.shape))
    if config.count_sum:
        feature = batch["count_sum_feature"].to(dtype)  # (B, 1), normalised
        extras.append(feature.expand((s,) + feature.shape))
    return extras


def reconstruction_log_prob(config, p_x, t: torch.Tensor) -> torch.Tensor:
    """log p(x|z) per example: the log-probabilities of the targets summed
    over the features, or, for a distribution whose event is the feature
    axis (the multivariate Gaussian, the Gaussian mixture), its
    log-probability as it is (the JAX package sums those over the batch
    axis as well, which its reshape then refuses)."""
    log_prob = p_x.log_prob(t.float())
    if config.reconstruction_spec.event:
        return log_prob
    return torch.sum(log_prob, dim=-1)


def _build_reconstruction(config: VAEConfig, params: Params,
                          decoder_h: torch.Tensor, batch: Batch,
                          compute_dtype=None):
    """Reconstruction distribution over (S, B, F) from decoder output."""
    spec = config.reconstruction_spec
    theta = {
        name: pspec.constrain(networks.apply_dense(
            params["reconstruction"][name], decoder_h,
            compute_dtype=compute_dtype,
        ))
        for name, pspec in spec.parameters.items()
    }
    count_sum = (batch["count_sum"] if config.use_count_sum_as_parameter
                 else None)  # (B, 1) raw per-cell total
    p_x = spec.build(theta, count_sum=count_sum)
    if config.k_max:
        logits = networks.apply_categorised_logits(
            params["categorised_logits"], decoder_h,
            compute_dtype=compute_dtype,
        )
        p_x = Categorised(dist=p_x, cat=Categorical(logits=logits))
    return p_x


def whole_heads(config, params: Params, genes) -> Params:
    """``params`` with whole reconstruction and categorised class heads:
    under a gene split (``genes``, a ``parallel.GeneSplit``) every head that
    it cuts gathered over the model group (differentiable: the gradient of
    the rank's block), for the paths that read all F genes; without one,
    ``params`` itself.  A VAE's or a GMVAE's."""
    if genes is None:
        return params
    spec = config.reconstruction_spec.parameters
    whole = dict(params)
    whole["reconstruction"] = {
        name: genes.whole(head, spec[name].size_fn(config.feature_size))
        for name, head in params["reconstruction"].items()}
    if config.k_max:
        whole["categorised_logits"] = genes.whole(
            params["categorised_logits"], config.feature_size)
    return whole


def forward(
    config: VAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    training: bool,
    n_iw: int = 1,
    n_mc: int = 1,
    deterministic_z: bool = False,
    build_reconstruction: bool = True,
    noise: torch.Tensor | None = None,
    shard=None,
) -> VAEOutputs:
    """Encoder → posterior → z → decoder (→ reconstruction distribution).
    ``noise`` (S, B, D) replaces the generator's standard-normal draws for
    z (parity tests feed both frameworks the same draws).  With a ``shard``
    (``parallel.RowShard``) the batch is this rank's rows of a global batch:
    batch norm takes the global batch's statistics, and every draw (and
    ``noise``) is the global batch's, cut to the rank's rows."""
    x = batch["x"]
    compute_dtype = config.compute_dtype(training, x.device)
    new_state: State = {}

    if config.inference_architecture == "MLP":
        h, new_state["encoder"] = networks.apply_mlp(
            params["encoder"], state.get("encoder", {}), x,
            training=training, generator=generator,
            input_dropout_keep_prob=config.dropout_keep_probability_x,
            hidden_dropout_keep_prob=config.dropout_keep_probability_h,
            compute_dtype=compute_dtype, shard=shard,
        )
    else:  # LFM: the linear factor model reads x itself
        h = x
    q_z = _build_posterior(config, params, h, compute_dtype)
    p_z = _build_prior(config, h)

    if deterministic_z:
        z = q_z.mean()[None]
    else:
        if shard is not None:
            noise = shard.normal((n_iw * n_mc,) + tuple(q_z.batch_shape()),
                                 generator, q_z.parameters()[0], noise)
        z = q_z.sample(generator, (n_iw * n_mc,), noise=noise)

    extras = decoder_extras(config, batch, z.shape[0], z.dtype)
    dec_in = torch.cat([z] + extras, dim=-1) if extras else z
    if config.generative_architecture == "MLP":
        dec_h, new_state["decoder"] = networks.apply_mlp(
            params["decoder"], state.get("decoder", {}), dec_in,
            training=training, generator=generator,
            input_dropout_keep_prob=config.dropout_keep_probability_z,
            hidden_dropout_keep_prob=config.dropout_keep_probability_h,
            compute_dtype=compute_dtype, shard=shard,
        )
    else:
        dec_h = dec_in
    p_x = (
        _build_reconstruction(config, params, dec_h, batch, compute_dtype)
        if build_reconstruction else None
    )
    return VAEOutputs(q_z=q_z, p_z=p_z, z=z, p_x=p_x, decoder_hidden=dec_h,
                      new_state=new_state)


# --------------------------------------------------------------------------
# Objective
# --------------------------------------------------------------------------


def fused_log_p_x(config, params: Params, batch: Batch, h: torch.Tensor,
                  t: torch.Tensor, compute_dtype, genes=None) -> torch.Tensor:
    """log p(x|z) of the fused path in one launch (training's, and the
    metrics-only evaluation's in float32): the decoder output h (..., H)
    against the targets t (M_t, F), whose rows cycle.
    With ``genes`` (``parallel.GeneSplit``) the heads are this rank's gene
    block where the split cuts F, and the kernels run on the block, their
    row sums summed over the model group (``ops.sharded``).

    The −lgamma(1+t) term is constant in the parameters and additive per
    row, so the kernel skips it and it is subtracted here, once, over all
    F genes: the row sums the data pipeline staged once per dataset
    (``models.api._append_lgamma_rowsum``), else summed here once per
    target row (not once per decoder row: a GMVAE has K·S of those per
    target row).  The constrained Poisson's kernel and the categorised
    likelihood (lgamma inside its shifted branch) keep their own."""
    name = config.reconstruction_distribution
    likelihood = ops.fused_log_likelihood
    categorised = ops.fused_categorised_log_likelihood
    if genes is not None:
        likelihood = functools.partial(ops.sharded_fused_log_likelihood,
                                       genes=genes)
        categorised = functools.partial(
            ops.sharded_fused_categorised_log_likelihood, genes=genes)
    if config.k_max:
        return categorised(
            name, h, params["reconstruction"],
            params["categorised_logits"]["kernel"],
            params["categorised_logits"]["bias"], t,
            compute_dtype=compute_dtype,
        )
    if config.use_count_sum_as_parameter:
        return likelihood(
            name, h, params["reconstruction"], t,
            count_sum=batch["count_sum"], compute_dtype=compute_dtype,
        )
    row_const = batch.get("t_lgamma_rowsum")
    if row_const is None:
        row_const = torch.sum(lgamma(1.0 + t.float()), dim=-1)
    return likelihood(
        name, h, params["reconstruction"], t, compute_dtype=compute_dtype,
        include_lgamma_const=False,
    ) - row_const


def elbo_terms(
    config: VAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    training: bool,
    n_iw: int = 1,
    n_mc: int = 1,
    warm_up_weight: float | torch.Tensor = 1.0,  # a 0-d tensor in an epoch
    deterministic_z: bool = False,
    noise: torch.Tensor | None = None,
    shard=None,
    genes=None,
    fused_evaluation: bool = False,
) -> tuple[dict[str, torch.Tensor], VAEOutputs]:
    """The ELBO decomposition (reference ``variational_autoencoder.py:
    2560-2734``).  Training takes the fused path where
    :func:`fused_path_enabled`; evaluation keeps the unfused distribution
    path and the full ``p_x`` outputs, unless ``fused_evaluation``: then,
    where :func:`fused_path_enabled`, log p(x|z) comes from the fused
    forward at the evaluation's compute dtype (float32) and no ``p_x`` is
    built (``outputs.p_x`` is None), for callers that read the metrics
    only.  With ``genes`` (a ``parallel.GeneSplit``) ``params`` holds the
    rank's gene block of the heads it cuts: the fused path runs the
    kernels on the block (:func:`fused_log_p_x`), the unfused path on the
    heads gathered whole (:func:`whole_heads`).

    Returns ``lower_bound`` (IW bound), ``lower_bound_weighted`` (training
    objective with warm-up·kl_weight), ``reconstruction_error``,
    ``kl_divergence`` and ``kl_divergence_neurons`` (D,).  With a ``shard``
    (see :func:`forward`) each is the mean over the rank's rows: the
    ranks' average is the global batch's value, since every term is a mean
    over rows of per-row values."""
    use_fused = ((training or fused_evaluation) and not deterministic_z
                 and fused_path_enabled(config))
    if not use_fused:
        params = whole_heads(config, params, genes)
    outputs = forward(
        config, params, state, batch, generator,
        training=training, n_iw=n_iw, n_mc=n_mc,
        deterministic_z=deterministic_z,
        build_reconstruction=not use_fused, noise=noise, shard=shard,
    )
    t = batch["t"]
    b = t.shape[0]
    if deterministic_z:
        n_iw = n_mc = 1

    if use_fused:
        rows = fused_log_p_x(config, params, batch, outputs.decoder_hidden, t,
                             config.compute_dtype(training, t.device), genes)
        log_p_x_given_z = rows.reshape(n_iw, n_mc, b)
    else:
        log_p_x_given_z = reconstruction_log_prob(
            config, outputs.p_x, t).reshape(n_iw, n_mc, b)
    reconstruction_error = torch.mean(log_p_x_given_z)

    if config.analytical_kl and not deterministic_z:
        kl_pointwise = kl_divergence(outputs.q_z, outputs.p_z)  # (B, D)
        kl_divergence_neurons = torch.mean(kl_pointwise, dim=0)
        kl_samples = torch.sum(kl_pointwise, dim=-1)  # (B,) → broadcasts
    else:
        z = outputs.z.reshape(n_iw, n_mc, b, -1)
        kl_pointwise = outputs.q_z.log_prob(z) - outputs.p_z.log_prob(z)
        kl_divergence_neurons = torch.mean(
            kl_pointwise.reshape(-1, kl_pointwise.shape[-1]), dim=0
        )
        kl_samples = torch.sum(kl_pointwise, dim=-1)  # (R, L, B)
    kl_scalar = torch.sum(kl_divergence_neurons)

    lower_bound = torch.mean(log_reduce_exp(log_p_x_given_z - kl_samples, dim=0))
    lower_bound_weighted = torch.mean(
        log_reduce_exp(
            log_p_x_given_z - warm_up_weight * config.kl_weight * kl_samples,
            dim=0,
        )
    )
    metrics = {
        "lower_bound": lower_bound,
        "lower_bound_weighted": lower_bound_weighted,
        "reconstruction_error": reconstruction_error,
        "kl_divergence": kl_scalar,
        "kl_divergence_neurons": kl_divergence_neurons,
    }
    return metrics, outputs


def evaluation_outputs(
    config: VAEConfig,
    params: Params,
    state: State,
    batch: Batch,
    generator: torch.Generator | None,
    *,
    n_iw: int = 1,
    n_mc: int = 1,
    deterministic_z: bool = False,
    noise: torch.Tensor | None = None,
    shard=None,
) -> dict[str, torch.Tensor]:
    """The ELBO metrics of one batch in evaluation mode, and the posterior-
    predictive reconstruction: ``p_x_mean`` Ê[x] (B, F), the mean over the
    samples of E[x|z]; ``stddev_of_p_x_given_z_mean`` the standard deviation
    of E[x|z] over the samples; ``p_x_stddev`` from V[x] ≈ that variance +
    Ê[V[x|z]]; the latent means ``q_z_mean`` (B, D) and the samples ``z``
    (S, B, D) (reference ``variational_autoencoder.py:2658-2713``)."""
    metrics, outputs = elbo_terms(
        config, params, state, batch, generator, training=False,
        n_iw=n_iw, n_mc=n_mc, deterministic_z=deterministic_z, noise=noise,
        shard=shard,
    )
    if deterministic_z:
        n_iw = n_mc = 1
    shape = (n_iw, n_mc, batch["t"].shape[0], config.feature_size)
    p_mean = outputs.p_x.mean().reshape(shape)
    p_var = outputs.p_x.variance().reshape(shape)
    p_x_mean = torch.mean(torch.mean(p_mean, dim=1), dim=0)
    variance_of_means = torch.mean(
        torch.mean(torch.square(p_mean - p_x_mean), dim=1), dim=0)
    mean_of_variances = torch.mean(torch.mean(p_var, dim=1), dim=0)
    return {
        **metrics,
        "p_x_mean": p_x_mean,
        "p_x_stddev": torch.sqrt(variance_of_means + mean_of_variances),
        "stddev_of_p_x_given_z_mean": torch.sqrt(variance_of_means),
        "q_z_mean": outputs.q_z.mean(),
        "z": outputs.z,
    }


def latent_means(config: VAEConfig, params: Params, state: State,
                 x: torch.Tensor) -> torch.Tensor:
    """q(z|x) means (B, D) without running the decoder, batch norm in
    inference mode, in float32 (JAX ``vae.py:659-672``): the latent path of
    the intermediate analyses."""
    with torch.no_grad():
        if config.inference_architecture == "MLP":
            h, _ = networks.apply_mlp(params["encoder"],
                                      state.get("encoder", {}), x,
                                      training=False)
        else:
            h = x
        return _build_posterior(config, params, h).mean()


def decode_means(config, params: Params, state: State,
                 z: torch.Tensor) -> torch.Tensor:
    """E[x|z] (N, F) of latent values ``z`` (N, D) through the decoder in
    evaluation mode (a VAE's or a GMVAE's; not for models that take the
    count sum or the batch indices, which sampling has no value of)."""
    if getattr(config, "generative_architecture", "MLP") == "LFM":
        dec_h = z[None]
    else:
        dec_h, _ = networks.apply_mlp(params["decoder"],
                                      state.get("decoder", {}), z[None],
                                      training=False)
    return _build_reconstruction(config, params, dec_h, {}).mean()[0]


def loss_fn(
    config: VAEConfig,
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
    """Training objective: −lower_bound_weighted (reference ``:2755``);
    with a ``shard`` (the rank's row offset and the global batch's size)
    the rank's part, whose average over the data group is the global loss;
    with ``genes`` on the rank's gene block of the heads (see
    :func:`elbo_terms`)."""
    metrics, outputs = elbo_terms(
        config, params, state, batch, generator,
        training=True, n_iw=n_iw, n_mc=n_mc,
        warm_up_weight=warm_up_weight, noise=noise, shard=shard,
        genes=genes,
    )
    return -metrics["lower_bound_weighted"], (metrics, outputs.new_state)
