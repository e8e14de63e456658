"""Device-resident staging of count matrices (the ported part of
``scvae_tpu/data/pipeline.py``).

A dataset that fits in device memory is densified once and held there as a
plain row-major (N, F) tensor at the narrowest exact integer width (int16 for
typical transcript counts; float32 for values that are not integral, such as
preprocessed ones); every training step gathers its rows with the row-gather
kernel.  The TPU's packed layout is not needed on the GPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.sparse
import torch


def narrowest_count_dtype(values, candidates=(np.int16, np.int32)):
    """Narrowest candidate integer dtype that can represent ``values``
    exactly, or ``None`` if the values are not integral counts.  Works on
    CSR matrices without densifying (only the stored entries matter —
    implicit zeros fit any dtype)."""
    data = values.data if scipy.sparse.issparse(values) else np.asarray(values)
    if data.size == 0:
        return candidates[0]
    if np.issubdtype(data.dtype, np.integer):
        lo, hi = data.min(), data.max()
    elif np.issubdtype(data.dtype, np.floating):
        # sample-check integrality cheaply before the full pass
        sample = data.flat[: 4096]
        if not np.all(sample == np.round(sample)):
            return None
        if not np.all(data == np.round(data)):
            return None
        lo, hi = data.min(), data.max()
    else:
        return None
    for dtype in candidates:
        info = np.iinfo(dtype)
        if lo >= info.min and hi <= info.max:
            return dtype
    return None


def device_resident_data(
    arrays: dict[str, Any],
    *,
    device: torch.device | str,
    count_dtype=(np.int16, np.int32),
) -> dict[str, torch.Tensor]:
    """Densify each field and place it on ``device`` once.

    The count fields ``x`` and ``t`` are stored at the narrowest of the
    ``count_dtype`` candidates that holds them exactly (float32 when they
    are not integral), other integer fields as int32, the rest as
    float32.  Fields that are the same host array (x and t
    usually are) become the same device tensor, so a step gathers them
    once."""
    placed_by_id: dict[int, torch.Tensor] = {}
    out: dict[str, torch.Tensor] = {}
    for name, arr in arrays.items():
        key = id(arr)
        if key not in placed_by_id:
            dense = arr.toarray() if scipy.sparse.issparse(arr) else np.asarray(arr)
            dtype = None
            if name in ("x", "t"):
                dtype = narrowest_count_dtype(arr, tuple(count_dtype))
            elif np.issubdtype(dense.dtype, np.integer):
                dtype = np.int32  # the batch indices
            dense = dense.astype(dtype or np.float32, copy=False)
            placed_by_id[key] = torch.from_numpy(
                np.ascontiguousarray(dense)
            ).to(device)
        out[name] = placed_by_id[key]
    return out


def build_model_arrays(data_set, *, use_binarised: bool = False,
                       use_count_sum_as_parameter: bool = False,
                       use_count_sum_as_feature: bool = False,
                       include_batch_indices: bool = False
                       ) -> dict[str, Any]:
    """The fields a model batch needs from a
    :class:`~scvae_tpu_torch.data.DataSet` (the JAX package's
    ``build_model_arrays``, ``scvae_tpu/data/pipeline.py:624-664``, without
    its noisy preprocessing): inputs ``x`` are the preprocessed values when
    the set has them, else the values (a float matrix is then staged as
    float32); targets ``t`` are the binarised values when a Bernoulli
    likelihood asks for them and the set has them, else ``x``.  With them
    the per-cell ``count_sum`` (N, 1) float32 of the original values when
    the likelihood takes it, the ``count_sum_feature`` (N, 1) float32
    (normalised) when the decoder takes it, and the ``batch_indices``
    (N, 1) int32 for batch correction when the set has them."""
    x = (data_set.values if data_set.preprocessed_values is None
         else data_set.preprocessed_values)
    t = (data_set.binarised_values
         if use_binarised and data_set.binarised_values is not None else x)
    arrays: dict[str, Any] = {"x": x, "t": t}
    if use_count_sum_as_parameter:
        arrays["count_sum"] = data_set.count_sum.astype(np.float32)
    if use_count_sum_as_feature:
        arrays["count_sum_feature"] = data_set.normalised_count_sum.astype(
            np.float32)
    if include_batch_indices and data_set.batch_indices is not None:
        arrays["batch_indices"] = data_set.batch_indices.astype(np.int32)
    return arrays
