"""VAE core, training steps and loop, and the model API."""

from scvae_tpu_torch.models.api import VariationalAutoencoder, resolve_device
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
    "TrainState",
    "VariationalAutoencoder",
    "create_train_state",
    "epoch_permutation",
    "make_optimizer",
    "make_train_step",
    "resolve_device",
]
