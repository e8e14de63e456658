"""VAE and GMVAE cores, training steps and loop, and the model APIs."""

from scvae_tpu_torch.models.api import VariationalAutoencoder, resolve_device
from scvae_tpu_torch.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder,
)
from scvae_tpu_torch.models.step import (
    ClipAdam,
    TrainState,
    create_train_state,
    epoch_permutation,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "ClipAdam",
    "GaussianMixtureVariationalAutoencoder",
    "TrainState",
    "VariationalAutoencoder",
    "create_train_state",
    "epoch_permutation",
    "make_optimizer",
    "make_train_step",
    "resolve_device",
]
