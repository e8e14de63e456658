"""The card's published peaks and the least time a piece of work needs.

``chip_smoke.py`` ``bound()``'s convention, copied: the least time is the
larger of the bytes over the HBM rate and the operations over the bf16
tensor-core rate (NVIDIA H100 SXM, dense, at its 700 W limit), each input
byte counted as read once and each output byte as written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def likelihood_least_seconds(rows: int, targets: int, hidden: int,
                             genes: int, heads: int) -> float:
    """One training step's count likelihood, forward and backward, counted
    from the step's own inputs and outputs, whatever kernels do it: ``h``
    of ``rows`` decoder rows (float32), the heads' weights and biases
    (float32) and the ``targets`` (bf16) read once; the row sums (float32),
    dh (float32) and the heads' gradients (float32) written once; three
    products of 2·heads·rows·hidden·genes operations each (the heads'
    outputs, dh and dW)."""
    flops = 3 * 2 * heads * rows * hidden * genes
    head_bytes = heads * (hidden * genes + genes) * 4
    read = rows * hidden * 4 + head_bytes + targets * genes * 2
    written = rows * 4 + rows * hidden * 4 + head_bytes
    return least_seconds(read + written, flops)
