"""The counts a traffic mix trains on, made from the run's seed.

The law is ``chip_smoke.py``'s: each entry is non-zero with probability
``density``, and a non-zero entry is Poisson(``mean``) + 1, which gives the
~93% zeros of 10x Genomics' single-cell sets.  One uniform draw decides an
entry: u < density makes it non-zero, and u / density, uniform again, picks
its Poisson value by the inverse of the distribution function (tabulated
to where its tail is below float32's resolution).  The draws are made on
the device from a generator seeded with the seed, a block of rows at a
time, each copied straight into a host (cells, genes) int16 matrix, the
form in which ``train`` takes a count matrix and stages it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# entries drawn at a time: ~0.5 GB of uniforms, 1 GB of indices on the card
BLOCK_ENTRIES = 2**27
TABLE = 64  # Poisson values tabulated: P(X > 63) is nil for the means used


def poisson_cdf(mean: float, size: int = TABLE) -> np.ndarray:
    pmf = [math.exp(-mean + k * math.log(mean) - math.lgamma(k + 1))
           for k in range(size)]
    return np.cumsum(pmf)


def make_counts(cells: int, genes: int, density: float, mean: float,
                seed: int, device) -> np.ndarray:
    generator = torch.Generator(device=device).manual_seed(seed)
    cdf = torch.tensor(poisson_cdf(mean), dtype=torch.float32, device=device)
    out = torch.empty((cells, genes), dtype=torch.int16)
    block_rows = max(1, BLOCK_ENTRIES // genes)
    for start in range(0, cells, block_rows):
        rows = min(block_rows, cells - start)
        u = torch.rand((rows, genes), generator=generator, device=device)
        values = torch.searchsorted(cdf, u / density, right=True) + 1
        block = torch.where(u < density, values, 0).clamp_max(TABLE)
        out[start:start + rows].copy_(block.to(torch.int16))
    return out.numpy()
