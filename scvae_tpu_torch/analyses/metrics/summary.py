"""Summary statistics table (mean, standard deviation, dispersion, minimum,
maximum, sparsity): the port of ``scvae_tpu/analyses/metrics/summary.py``
(the reference's ``scvae/analyses/metrics/summary.py:27-93``).

The sums run on the device in float64: over every entry of a dense set,
over the stored entries of a sparse one with the JAX package's formulas for
the implicit zeros.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.utils.device import float64_tensor, resolve_device


def summary_statistics(x, name: str = "", tolerance: float = 1e-3,
                       skip_sparsity: bool = False, device=None) -> dict:
    """The statistics of every entry of ``x`` (numpy or scipy sparse) on
    ``device`` (CUDA unless ``"cpu"``); sparsity is the share of entries
    with |value| ≤ ``tolerance`` (of zero entries, for a sparse ``x``)."""
    device = resolve_device(device)
    n = x.shape[0] * x.shape[1]
    if scipy.sparse.issparse(x):
        data = torch.from_numpy(np.asarray(x.data, np.float64)).to(device)
        nnz = data.numel()
        if nnz:
            sums = torch.stack([data.sum(), (data * data).sum(), data.min(),
                                data.max(), (data != 0).sum().double()])
            total, sum_sq, x_min, x_max, nonzero = sums.tolist()
        else:
            total = sum_sq = x_min = x_max = nonzero = 0.0
        mean = total / n
        var = (sum_sq - n * mean**2) / (n - 1)
        std = float(np.sqrt(max(var, 0.0)))
        if nnz < n:
            x_min = min(x_min, 0.0)
        x_sparsity = np.nan if skip_sparsity else 1.0 - nonzero / n
    else:
        values = float64_tensor(x, device)
        sums = torch.stack([
            values.mean(), values.std(), values.min(), values.max(),
            (values.abs() <= tolerance).sum().double(),
        ])
        mean, std, x_min, x_max, close_to_zero = sums.tolist()
        x_sparsity = np.nan if skip_sparsity else close_to_zero / n
    dispersion = std**2 / mean if mean else np.nan
    return {
        "name": name,
        "mean": float(mean),
        "standard deviation": float(std),
        "minimum": float(x_min),
        "maximum": float(x_max),
        "dispersion": float(dispersion),
        "sparsity": float(x_sparsity),
    }


def format_summary_statistics(statistics_sets, name: str = "Data set") -> str:
    if not isinstance(statistics_sets, list):
        statistics_sets = [statistics_sets]
    name_width = max(
        [len(name)] + [len(s["name"]) for s in statistics_sets]
    )
    heading = "  ".join([
        "{:{}}".format(name, name_width),
        " mean ", "std. dev. ", "dispersion",
        " minimum ", " maximum ", "sparsity",
    ])
    rows = [heading]
    for s in statistics_sets:
        rows.append("  ".join([
            "{:{}}".format(s["name"], name_width),
            "{:<9.5g}".format(s["mean"]),
            "{:<9.5g}".format(s["standard deviation"]),
            "{:<9.5g}".format(s["dispersion"]),
            "{:<11.5g}".format(s["minimum"]),
            "{:<11.5g}".format(s["maximum"]),
            "{:<7.5g}".format(s["sparsity"]),
        ]))
    return "\n".join(rows)
