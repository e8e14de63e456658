"""Row gather for device-resident batching (kernel K1).

Each training step gathers a shuffled batch of cell rows from the count
matrix held on the device and casts them to the dtype the step wants.  On a
CUDA tensor :func:`gather_rows` launches the hand-written kernel of
``ops/csrc/gather.cu``, which casts in the same pass over the source rows;
on a CPU tensor it runs the plain version, :func:`reference_gather`.
Counterpart of ``scvae_tpu/ops/gather.py`` without the TPU's packed layout:
the source is a plain row-major (N, F) matrix and any F works.
"""

from __future__ import annotations

import torch

from scvae_tpu_torch.ops import extension

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = {"gather_rows": 0}

_SOURCE_CODES = {torch.float32: 0, torch.int16: 2, torch.int32: 3}
_OUTPUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_gather(src: torch.Tensor, idx: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``index_select`` then a cast."""
    return src.index_select(0, idx.long()).to(dtype)


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Rows ``idx`` (B,) of ``src`` (N, F) as a (B, F) tensor of ``dtype``."""
    if not src.is_cuda:
        return reference_gather(src, idx, dtype)
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need (N, F) rows and (B,) indices, got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if src.dtype not in _SOURCE_CODES:
        raise TypeError(f"unsupported source dtype {src.dtype}")
    if idx.dtype != torch.int32 or idx.device != src.device:
        raise TypeError("indices must be int32 on the source's device")
    if dtype not in _OUTPUT_CODES:
        raise TypeError(f"unsupported output dtype {dtype}")
    src = src.contiguous()
    idx = idx.contiguous()
    n, f = src.shape
    b = idx.shape[0]
    out = torch.empty((b, f), dtype=dtype, device=src.device)
    if b == 0 or f == 0:
        return out
    # 8-element vector chunks need F % 8 == 0 and chunk-aligned pointers
    vec = f % 8 == 0 and all(
        t.data_ptr() % (8 * t.element_size()) == 0 for t in (src, out)
    )
    extension.call(
        "scvae_gather_rows", src.device,
        src.data_ptr(), _SOURCE_CODES[src.dtype], idx.data_ptr(), b, n, f,
        out.data_ptr(), _OUTPUT_CODES[dtype], int(vec),
    )
    LAUNCHES["gather_rows"] += 1
    return out
