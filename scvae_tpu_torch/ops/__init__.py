"""Hand-written CUDA kernels and their plain PyTorch versions.

Every wrapper here launches its kernel on a CUDA tensor (building the
extension on first use) and runs its plain version on a CPU tensor.
"""

from scvae_tpu_torch.ops import fused_likelihood, gather, sharded
from scvae_tpu_torch.ops.fused_likelihood import (
    FAMILIES,
    MAX_FUSED_GROUPS,
    MAX_FUSED_HEADS,
    FusedCategorised,
    FusedConstrainedPoisson,
    FusedGroupedLogLikelihood,
    FusedLogLikelihood,
    categorised_backward,
    categorised_forward,
    cp_backward,
    cp_forward,
    fused_backward,
    fused_categorised_log_likelihood,
    fused_forward,
    fused_grouped_log_likelihood,
    fused_log_likelihood,
    grouped_backward,
    grouped_forward,
    reference_backward,
    reference_categorised_dh,
    reference_categorised_dw,
    reference_categorised_forward,
    reference_categorised_log_likelihood,
    reference_cp_dh,
    reference_cp_dw,
    reference_cp_forward,
    reference_dh,
    reference_dw,
    reference_forward,
    reference_grouped_dh,
    reference_grouped_dw,
    reference_grouped_forward,
    reference_log_likelihood,
    supports_fused_likelihood,
    supports_grouped_likelihood,
)
from scvae_tpu_torch.ops.gather import gather_rows, reference_gather
from scvae_tpu_torch.ops.sharded import (
    sharded_fused_categorised_log_likelihood,
    sharded_fused_log_likelihood,
)
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


def add_launch_counts(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` to the counters: a CUDA graph's replay
    launches the kernels its capture recorded, and the wrappers, which
    count where they launch, do not run again."""
    for counter in _COUNTERS:
        for name in counter.keys() & counts.keys():
            counter[name] += times * counts[name]


__all__ = [
    "FAMILIES",
    "FusedCategorised",
    "FusedConstrainedPoisson",
    "FusedGroupedLogLikelihood",
    "FusedLogLikelihood",
    "MAX_FUSED_GROUPS",
    "MAX_FUSED_HEADS",
    "add_launch_counts",
    "categorised_backward",
    "categorised_forward",
    "cp_backward",
    "cp_forward",
    "digamma",
    "fused_backward",
    "fused_categorised_log_likelihood",
    "fused_forward",
    "fused_grouped_log_likelihood",
    "fused_log_likelihood",
    "gather_rows",
    "grouped_backward",
    "grouped_forward",
    "launch_counts",
    "lgamma",
    "reference_backward",
    "reference_categorised_dh",
    "reference_categorised_dw",
    "reference_categorised_forward",
    "reference_categorised_log_likelihood",
    "reference_cp_dh",
    "reference_cp_dw",
    "reference_cp_forward",
    "reference_dh",
    "reference_dw",
    "reference_forward",
    "reference_gather",
    "reference_grouped_dh",
    "reference_grouped_dw",
    "reference_grouped_forward",
    "reference_log_likelihood",
    "reset_launch_counts",
    "sharded_fused_categorised_log_likelihood",
    "sharded_fused_log_likelihood",
    "supports_fused_likelihood",
    "supports_grouped_likelihood",
]
