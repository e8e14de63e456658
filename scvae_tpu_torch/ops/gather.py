"""Row gather for device-resident batching (kernel K1).

Each training step gathers a shuffled batch of cell rows from the count
matrix held on the device and casts them to the dtype the step wants.  On a
CUDA tensor :func:`gather_rows` launches the hand-written kernel of
``ops/csrc/gather.cu``, which casts in the same pass over the source rows,
on the path that :func:`gather_plan` picks; on a CPU tensor it runs the
plain version, :func:`reference_gather`.  Counterpart of
``scvae_tpu/ops/gather.py`` without the TPU's packed layout: the source is
a plain row-major (N, F) matrix and any F works.
"""

from __future__ import annotations

import torch

from scvae_tpu_torch.ops import extension

# Kernel launches, counted where the kernel is launched and nowhere else; a
# CUDA graph's replay adds what its capture recorded (ops.add_launch_counts).
LAUNCHES = {"gather_rows": 0}

_SOURCE_CODES = {torch.float32: 0, torch.int16: 2, torch.int32: 3}
_OUTPUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODES = {"element": 0, "vector": 1}

# The kernel's shape on the H100 (gather.cu): SMs, threads of a block,
# elements of a unit (a 16-byte word of int16 / bf16), units in flight per
# thread on the vector path, and the blocks of a launch at most on each
# path (a few waves of resident blocks; each thread loops over the rest).
GATHER_SMS = 132
GATHER_THREADS = 256
GATHER_UNIT = 8
GATHER_UNROLL = 4
GATHER_MAX_BLOCKS = {"vector": GATHER_SMS * 8, "element": GATHER_SMS * 16}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gather_plan(b: int, f: int, aligned: bool) -> dict:
    """The launch of K1 for ``b`` rows of ``f`` elements, the source and
    output pointers 16-byte ``aligned`` or not: the vector path for rows of
    whole 16-byte units (F a multiple of :data:`GATHER_UNIT`, aligned
    pointers), every thread with :data:`GATHER_UNROLL` units in flight, and
    the element path for every other shape; the grid covers the work in
    one step of every thread where the card holds it."""
    if f % GATHER_UNIT or not aligned:
        path, per_block = "element", GATHER_THREADS
        work = b * f
    else:
        path, per_block = "vector", GATHER_THREADS * GATHER_UNROLL
        work = b * f // GATHER_UNIT
    return {"path": path, "grid": max(1, min(_cdiv(work, per_block),
                                             GATHER_MAX_BLOCKS[path]))}


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
    f = src.shape[1]
    b = idx.shape[0]
    out = torch.empty((b, f), dtype=dtype, device=src.device)
    if b == 0 or f == 0:
        return out
    plan = gather_plan(b, f, src.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0)
    launch(src, idx, out, plan)
    LAUNCHES["gather_rows"] += 1
    return out


def launch(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
           plan: dict) -> None:
    """K1 on checked operands: rows ``idx`` of ``src`` into ``out`` as
    ``plan`` (:func:`gather_plan`) lays the launch out."""
    n, f = src.shape
    extension.call(
        "scvae_gather_rows", src.device,
        src.data_ptr(), _SOURCE_CODES[src.dtype], idx.data_ptr(),
        idx.shape[0], n, f, out.data_ptr(), _OUTPUT_CODES[out.dtype],
        _PATH_CODES[plan["path"]], plan["grid"],
    )
