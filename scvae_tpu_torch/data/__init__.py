"""In-memory data sets and device-resident staging."""

from scvae_tpu_torch.data.dataset import DataSet

__all__ = ["DataSet"]
