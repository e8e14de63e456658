"""Hand-written CUDA kernels and their plain PyTorch versions.

Every wrapper here launches its kernel on a CUDA tensor (building the
extension on first use) and runs its plain version on a CPU tensor.
"""

from scvae_tpu_torch.ops import fused_likelihood, gather
from scvae_tpu_torch.ops.fused_likelihood import (
    FusedNBLogLikelihood,
    fused_log_likelihood,
    nb_backward,
    nb_backward_dh,
    nb_backward_dw,
    nb_forward,
    reference_nb_backward,
    reference_nb_dh,
    reference_nb_dw,
    reference_nb_grads,
    reference_nb_log_likelihood,
)
from scvae_tpu_torch.ops.gather import gather_rows, reference_gather
from scvae_tpu_torch.ops.special import digamma, lgamma

_COUNTERS = (gather.LAUNCHES, fused_likelihood.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    counts: dict[str, int] = {}
    for counter in _COUNTERS:
        counts.update(counter)
    return counts


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0


__all__ = [
    "FusedNBLogLikelihood",
    "digamma",
    "fused_log_likelihood",
    "gather_rows",
    "launch_counts",
    "lgamma",
    "nb_backward",
    "nb_backward_dh",
    "nb_backward_dw",
    "nb_forward",
    "reference_gather",
    "reference_nb_backward",
    "reference_nb_dh",
    "reference_nb_dw",
    "reference_nb_grads",
    "reference_nb_log_likelihood",
    "reset_launch_counts",
]
