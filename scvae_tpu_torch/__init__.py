"""scvae-tpu on PyTorch and CUDA.

A port of the ``scvae_tpu`` engine to PyTorch with hand-written CUDA kernels
for an NVIDIA H100 (``sm_90a``).  It imports neither JAX nor ``scvae_tpu``.
So far it trains a VAE or a Gaussian-mixture VAE (GMVAE) on a count matrix
held on the device, or streamed from host memory when it is over the
device budget, with a Poisson, negative-binomial, zero-inflated
Poisson, zero-inflated negative-binomial or constrained-Poisson likelihood,
or the categorised form of the first four (``number_of_reconstruction_classes``
> 0, up to 32 heads in all):

    from scvae_tpu_torch import (GaussianMixtureVariationalAutoencoder,
                                 VariationalAutoencoder)
    model = VariationalAutoencoder(feature_size=2048, latent_size=100,
                                   hidden_sizes=[256, 256],
                                   reconstruction_distribution="negative binomial")
    model.train(counts, number_of_epochs=2, minibatch_size=2048)
    GaussianMixtureVariationalAutoencoder(
        feature_size=2048, latent_size=100, hidden_sizes=[256, 256],
        reconstruction_distribution="negative binomial",
        number_of_latent_clusters=10,
    ).train(counts, number_of_epochs=2, minibatch_size=2048)

Data sets load, filter, preprocess, cache and split as in the JAX package
(``scvae_tpu_torch.data``), and labels carry through training (a GMVAE's
per-epoch cluster accuracy) and evaluation (predicted labels):

    from scvae_tpu_torch import DataSet
    training, validation, test = DataSet("development").split()

Trained models are evaluated, their labels predicted by k-means on the
latent values or by the GMVAE's clusters, and their clustering metrics,
summary statistics and decompositions computed on the device
(``scvae_tpu_torch.analyses``); the command line runs ``train`` and
``evaluate`` (``python -m scvae_tpu_torch``), and ``cross-analyse``; the
figures are drawn on the host with matplotlib.  ``train`` and
``evaluate`` run over a world of processes, one a device: cells over the
data axis, genes of the reconstruction heads over the model axis
(``scvae_tpu_torch.parallel``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from scvae_tpu_torch.data import DataSet  # noqa: E402
from scvae_tpu_torch.models import (  # noqa: E402
    GaussianMixtureVariationalAutoencoder,
    VariationalAutoencoder,
)

__all__ = ["DataSet", "GaussianMixtureVariationalAutoencoder",
           "VariationalAutoencoder", "__version__"]
