"""The device an entry point runs on, and the float64 tensors and the
random generators that the analyses compute with."""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def float64_tensor(values, device: torch.device) -> torch.Tensor:
    """``values`` (numpy or scipy sparse) as a float64 tensor on ``device``."""
    if scipy.sparse.issparse(values):
        values = values.toarray()
    return torch.from_numpy(np.asarray(values, dtype=np.float64)).to(device)


def random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state``: None gives a fresh generator
    seeded from the operating system, an int a generator seeded with it,
    and a generator is used as it is."""
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)
