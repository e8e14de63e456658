"""The epochs that get an intermediate analysis (the port's copy of
``scvae_tpu/utils/profiling.py:37-46``)."""

from __future__ import annotations

import numpy as np


def log_spaced_indices(n: int, count: int = 11) -> np.ndarray:
    """≤``count`` log-spaced indices in [0, n) — the reference's step-
    duration printing pattern."""
    if n <= 0:
        return np.array([], np.int64)
    raw = np.unique(
        np.round(np.logspace(0, np.log10(max(n, 1)), count)).astype(np.int64)
        - 1
    )
    return raw[(raw >= 0) & (raw < n)]
