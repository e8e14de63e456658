"""Data engine: loaders, preprocessing, splitting, caching, the
``DataSet`` container, device-resident staging and the streaming pipeline
(the port of ``scvae_tpu/data/``)."""

from scvae_tpu_torch.data.dataset import DataSet
from scvae_tpu_torch.data.loaders import LOADERS, create_development_data_set
from scvae_tpu_torch.data.sparse import SparseRowMatrix, sparsity
from scvae_tpu_torch.data.utilities import (
    build_directory_path,
    indices_for_evaluation_subset,
    save_values,
)

__all__ = [
    "DataSet",
    "LOADERS",
    "SparseRowMatrix",
    "build_directory_path",
    "create_development_data_set",
    "indices_for_evaluation_subset",
    "save_values",
    "sparsity",
]
