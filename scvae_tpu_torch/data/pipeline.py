"""Host input pipeline and device-resident staging of count matrices (the
port of ``scvae_tpu/data/pipeline.py``).

A data set that fits in device memory is densified once and held there as a
plain row-major (N, F) tensor at the narrowest exact integer width (int16 for
typical transcript counts; float32 for values that are not integral, such as
preprocessed ones); every training step gathers its rows with the row-gather
kernel.  The TPU's packed layout is not needed on the GPU.

A data set over the device budget streams from host memory through
:class:`BatchPipeline`: a seeded shuffle per epoch, each batch's rows
densified on the host by the native CSR gather (``scvae_tpu_torch.native``)
or shipped as a padded COO block (:class:`CSRWire`, densified on the device
by ``models.step.materialize_batch``), and on CUDA copied from pinned host
buffers on a copy stream while the card runs the steps before it.  Under
a data-parallel mesh each rank builds and ships only its contiguous block
of each batch (the JAX package's process-local rows and per-shard wire).
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import numpy as np
import scipy.sparse
import torch

from scvae_tpu_torch.parallel.mesh import ShardedBatch
from scvae_tpu_torch.utils import tracing


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
            with tracing.span("stage.densify", field=name):
                dense = (arr.toarray() if scipy.sparse.issparse(arr)
                         else np.asarray(arr))
                dtype = None
                if name in ("x", "t"):
                    dtype = narrowest_count_dtype(arr, tuple(count_dtype))
                elif np.issubdtype(dense.dtype, np.integer):
                    dtype = np.int32  # the batch indices
                dense = np.ascontiguousarray(
                    dense.astype(dtype or np.float32, copy=False))
            with tracing.span("stage.h2d", field=name, bytes=dense.nbytes):
                placed_by_id[key] = torch.from_numpy(dense).to(device)
        out[name] = placed_by_id[key]
    return out


def densify_rows(values, indices: np.ndarray) -> np.ndarray:
    """Rows ``indices`` of ``values`` as a dense array: float32 from a CSR
    matrix through the native gather (a failed build raises); from any
    other matrix through its own row indexing, floats narrowed to float32
    and integer fields (batch indices) kept in their dtype."""
    if scipy.sparse.issparse(values) and values.format == "csr":
        from scvae_tpu_torch import native

        return native.csr_gather_dense(values, np.asarray(indices))
    rows = values[indices]
    if scipy.sparse.issparse(rows):
        rows = rows.toarray()
    rows = np.asarray(rows)
    if not np.issubdtype(rows.dtype, np.integer):
        rows = rows.astype(np.float32, copy=False)
    return np.ascontiguousarray(rows)


class CSRWire:
    """A batch's count matrix shipped host → device as padded COO instead
    of dense: ``data``, ``cols`` and ``rows`` are (capacity,) tensors at
    narrow integer widths, padding entries carry ``rows == n_rows`` (and
    are dropped by ``models.step.materialize_batch``), ``n_rows`` and
    ``n_cols`` the dense shape.  At single-cell sparsity (~93% zeros) it
    carries several times fewer bytes than the dense int16 batch."""

    def __init__(self, data, cols, rows, n_rows: int, n_cols: int):
        self.data = data
        self.cols = cols
        self.rows = rows
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)


def _narrow_int(max_value: int):
    return np.int16 if max_value <= np.iinfo(np.int16).max else np.int32


def _wire_capacity(nnz_per_row: np.ndarray, rows: int) -> int:
    """Entries of a wire for ``rows`` rows: their mean stored entries plus
    four standard deviations, rounded up to 1,024."""
    mean = float(nnz_per_row.mean()) * rows
    std = float(nnz_per_row.std()) * np.sqrt(rows)
    return int(-(-(mean + 4.0 * std + 1) // 1024) * 1024)


class _PinnedSlot:
    """One pinned host buffer per (field, shape, dtype) and the event of the
    last copy out of them."""

    def __init__(self):
        self.buffers: dict[tuple, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None


class BatchPipeline:
    """Iterates batch dictionaries of one data subset (JAX's
    ``BatchPipeline``, one device).

    ``arrays`` maps field name → row-indexable host array (CSR or ndarray);
    every field is sliced with the same indices, shuffled per epoch by a
    ``RandomState(seed)`` that lives as long as the pipeline.
    ``count_dtype`` (a dtype or candidates, narrowest first) ships integral
    ``x``/``t`` at the narrowest width that holds them; ``wire_format``
    "csr" ships such a CSR field as a :class:`CSRWire` at a fixed capacity
    (the batch's mean stored entries plus four standard deviations, rounded
    up to 1,024), "auto" only where that is under half the dense bytes, and
    a batch that overflows the capacity goes dense.  Fields that are the
    same host array (x and t usually are) are built and sent once.

    ``epoch()`` yields dictionaries of tensors on ``device`` (CUDA unless
    it says otherwise) with ``prefetch`` batches built ahead.  On CUDA each
    batch is written into one of ``prefetch + 1`` sets of pinned host
    buffers and copied with ``non_blocking`` on a copy stream; the stream
    that takes the batch waits for that copy's event, and a set of pinned
    buffers is rewritten only after its last copy's event has completed.

    ``sharding`` (``parallel.batch_sharding(mesh)``): every rank draws the
    same permutation, and for a batch whose rows the data axis divides
    builds only its contiguous block of them, yielded as a
    ``parallel.ShardedBatch`` (a wire field with the block's row ids, at a
    capacity sized for the block); a batch that it does not divide is
    built whole on every rank and yielded as a plain dictionary
    (replicated).  A field goes dense on every rank when any rank's block
    overflows its wire (every rank holds the whole set, so each sees every
    block's entries): the ranks then run the same batch signatures."""

    def __init__(self, arrays: dict[str, Any], batch_size: int, *,
                 shuffle: bool = True, drop_remainder: bool = False,
                 seed: int = 0, sharding: Any = None, prefetch: int = 2,
                 count_dtype=None, wire_format: str = "auto",
                 device: torch.device | str | None = None):
        if not arrays:
            raise ValueError("arrays must be non-empty")
        self.arrays = arrays
        self.n = next(iter(arrays.values())).shape[0]
        for name, arr in arrays.items():
            if arr.shape[0] != self.n:
                raise ValueError(
                    f"Field {name!r} has {arr.shape[0]} rows, expected {self.n}"
                )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.sharding = sharding
        self._shards = 1 if sharding is None else sharding.mesh.shape["data"]
        self.prefetch = max(int(prefetch), 0)
        self.device = torch.device("cuda" if device is None else device)
        self._rng = np.random.RandomState(seed)
        self._wire_dtypes: dict[str, Any] = {}
        if count_dtype is not None:
            candidates = (tuple(count_dtype)
                          if isinstance(count_dtype, (tuple, list))
                          else (count_dtype,))
            checked_by_id: dict[int, Any] = {}
            for name in ("x", "t"):
                arr = arrays.get(name)
                if arr is None:
                    continue
                key = id(arr)
                if key not in checked_by_id:
                    checked_by_id[key] = narrowest_count_dtype(arr, candidates)
                if checked_by_id[key] is not None:
                    self._wire_dtypes[name] = checked_by_id[key]
        if wire_format not in ("auto", "csr", "dense"):
            raise ValueError("wire_format must be auto, csr, or dense")
        self._csr_wire: dict[str, dict] = {}
        # a rank's block of a batch under a sharding: its wire's capacity
        self._block_capacity: dict[str, int] = {}
        if wire_format in ("auto", "csr"):
            for name in ("x", "t"):
                arr = arrays.get(name)
                if (arr is None or not scipy.sparse.issparse(arr)
                        or arr.format != "csr"
                        or name not in self._wire_dtypes):
                    continue
                nnz_per_row = np.diff(arr.indptr)
                density = arr.nnz / max(arr.shape[0] * arr.shape[1], 1)
                # wire bytes per entry: data, column and row (narrow ints)
                entry_bytes = (
                    np.dtype(self._wire_dtypes[name]).itemsize
                    + np.dtype(_narrow_int(arr.shape[1])).itemsize
                    + np.dtype(_narrow_int(batch_size)).itemsize
                )
                dense_bytes = np.dtype(self._wire_dtypes[name]).itemsize
                if (wire_format == "auto"
                        and density * entry_bytes > 0.5 * dense_bytes):
                    continue  # not sparse enough to pay off
                self._csr_wire[name] = {
                    "capacity": _wire_capacity(nnz_per_row, batch_size),
                    "col_dtype": _narrow_int(arr.shape[1]),
                    "row_dtype": _narrow_int(batch_size),
                }
                self._block_capacity[name] = _wire_capacity(
                    nnz_per_row, batch_size // self._shards)
        self._slots: list[_PinnedSlot] = []
        self._copy_stream = None

    def batches_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        if self.shuffle:
            return self._rng.permutation(self.n)
        return np.arange(self.n)

    def _host_batch(self, idx: np.ndarray,
                    shard=None) -> dict[str, Any]:
        """The fields of the rows ``idx`` as numpy arrays (a
        :class:`CSRWire` of numpy arrays for a wire field); with a
        ``shard`` (a ``parallel.RowShard`` of them) the rank's block, whose
        wire field has a block's capacity and goes dense when any block
        overflows it.  Fields that are the same host array with the same
        wire dtype and format are one object."""
        rows = idx if shard is None else idx[shard.offset:
                                             shard.offset + shard.rows]
        built: dict[tuple, Any] = {}
        batch: dict[str, Any] = {}
        for name, arr in self.arrays.items():
            wire_dtype = self._wire_dtypes.get(name)
            csr_spec = self._csr_wire.get(name)
            key = (id(arr),
                   None if wire_dtype is None else np.dtype(wire_dtype).str,
                   csr_spec is not None)
            if key not in built:
                wire = None
                capacity = self._capacity(name, idx, shard)
                if capacity is not None:
                    coo = self._coo_block(arr, rows, wire_dtype, csr_spec,
                                          capacity)
                    if coo is not None:
                        wire = CSRWire(*coo, n_rows=len(rows),
                                       n_cols=arr.shape[1])
                if wire is not None:
                    built[key] = wire
                else:
                    dense = densify_rows(arr, rows)
                    if wire_dtype is not None:
                        dense = dense.astype(wire_dtype)
                    built[key] = dense
            batch[name] = built[key]
        return batch

    def _capacity(self, name: str, idx: np.ndarray, shard) -> int | None:
        """The wire capacity of field ``name`` for the rows ``idx`` (a
        rank's block of them with a ``shard``), or None for the dense form:
        under a ``shard`` a block's capacity, None when any rank's block
        overflows it."""
        spec = self._csr_wire.get(name)
        if spec is None or shard is None:
            return None if spec is None else spec["capacity"]
        arr = self.arrays[name]
        entries = arr.indptr[idx + 1] - arr.indptr[idx]
        capacity = self._block_capacity[name]
        if entries.reshape(self._shards, -1).sum(1).max() > capacity:
            return None
        return capacity

    @staticmethod
    def _coo_block(arr, idx, wire_dtype, spec, capacity):
        """Padded-COO arrays (data, cols, rows) of the rows ``idx``, with
        batch-local row ids (padding = ``len(idx)``), or ``None`` when their
        stored entries overflow ``capacity``."""
        starts = arr.indptr[idx]
        counts = arr.indptr[idx + 1] - starts
        total = int(counts.sum())
        if total > capacity:
            return None
        # element e of the wire belongs to batch row row_of[e] and is that
        # row's (e - row_base[row_of[e]])-th stored entry
        cum = np.cumsum(counts)
        pos = np.arange(total)
        row_of = np.searchsorted(cum, pos, side="right")
        row_base = np.concatenate([[0], cum[:-1]])
        src = starts[row_of] + (pos - row_base[row_of])
        pad = capacity - total
        data = np.concatenate([arr.data[src].astype(wire_dtype),
                               np.zeros(pad, wire_dtype)])
        cols = np.concatenate([arr.indices[src].astype(spec["col_dtype"]),
                               np.zeros(pad, spec["col_dtype"])])
        rows = np.concatenate([row_of.astype(spec["row_dtype"]),
                               np.full(pad, len(idx), spec["row_dtype"])])
        return data, cols, rows

    def _to_device(self, host: dict[str, Any], number: int):
        """(the batch with its arrays as tensors on the device, the event
        of their copy or None on the CPU, those tensors).  ``number``
        picks the set of pinned buffers."""
        arrays: list[np.ndarray] = []
        for value in host.values():
            parts = ((value.data, value.cols, value.rows)
                     if isinstance(value, CSRWire) else (value,))
            arrays.extend(p for p in parts
                          if not any(p is a for a in arrays))
        if self.device.type == "cpu":
            placed = [torch.from_numpy(np.ascontiguousarray(a))
                      for a in arrays]
            event = None
        else:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
                self._slots = [_PinnedSlot()
                               for _ in range(self.prefetch + 1)]
            slot = self._slots[number % len(self._slots)]
            if slot.event is not None:
                slot.event.synchronize()  # its last copy has finished
            placed = []
            with torch.cuda.stream(self._copy_stream):
                for j, a in enumerate(arrays):
                    key = (j, a.shape, a.dtype.str)
                    buffer = slot.buffers.get(key)
                    if buffer is None:
                        buffer = torch.empty(
                            a.shape, dtype=torch.from_numpy(a).dtype,
                            pin_memory=True)
                        slot.buffers[key] = buffer
                    buffer.numpy()[...] = a
                    placed.append(buffer.to(self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            slot.event = event
        by_id = {id(a): t for a, t in zip(arrays, placed)}
        for value in host.values():
            if isinstance(value, CSRWire) and id(value) not in by_id:
                by_id[id(value)] = CSRWire(
                    by_id[id(value.data)], by_id[id(value.cols)],
                    by_id[id(value.rows)], value.n_rows, value.n_cols)
        return ({name: by_id[id(value)] for name, value in host.items()},
                event, placed)

    def _make_batch(self, idx: np.ndarray, number: int):
        """(batch, copy event, placed tensors) of the rows ``idx``: under a
        sharding the rank's block of them when the ranks divide them."""
        if self.sharding is None or len(idx) % self._shards:
            return self._to_device(self._host_batch(idx), number)
        shard = self.sharding.mesh.rows(len(idx))
        batch, event, placed = self._to_device(
            self._host_batch(idx, shard), number)
        return ShardedBatch(batch, shard), event, placed

    def epoch(self) -> Iterator[dict[str, Any]]:
        """One pass over the data, ``prefetch`` batches built ahead."""
        indices = self._epoch_indices()
        n_batches = self.batches_per_epoch()
        slices = iter([
            (i, indices[i * self.batch_size:(i + 1) * self.batch_size])
            for i in range(n_batches)
        ])
        queue: collections.deque = collections.deque()
        for number, idx in slices:
            queue.append(self._make_batch(idx, number))
            if len(queue) == self.prefetch + 1:
                break
        while queue:
            batch, event, placed = queue.popleft()
            following = next(slices, None)
            if following is not None:
                queue.append(self._make_batch(following[1], following[0]))
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for tensor in placed:
                    tensor.record_stream(stream)
            yield batch


def build_model_arrays(data_set, *, use_preprocessed: bool = True,
                       use_binarised: bool = False,
                       use_count_sum_as_parameter: bool = False,
                       use_count_sum_as_feature: bool = False,
                       include_batch_indices: bool = False,
                       noisy_preprocess=None) -> dict[str, Any]:
    """The fields a model batch needs from a
    :class:`~scvae_tpu_torch.data.DataSet` (the JAX package's
    ``build_model_arrays``, ``scvae_tpu/data/pipeline.py:624-664``): with
    ``noisy_preprocess`` (a preprocessor built with ``noisy=True``) inputs
    and targets are both that function of a copy of the values, drawn
    anew on every call; otherwise inputs ``x`` are the preprocessed values
    when the set has them (and ``use_preprocessed``), else the values (a
    float matrix is then staged as float32), and targets ``t`` the
    binarised values when a Bernoulli likelihood asks for them and the set
    has them, else ``x``.  With them the per-cell ``count_sum`` (N, 1)
    float32 of the original values when the likelihood takes it, the
    ``count_sum_feature`` (N, 1) float32 (normalised) when the decoder
    takes it, and the ``batch_indices`` (N, 1) int32 for batch correction
    when the set has them."""
    if noisy_preprocess is not None:
        x = t = noisy_preprocess(data_set.values.copy())
    else:
        x = (data_set.preprocessed_values
             if use_preprocessed and data_set.preprocessed_values is not None
             else data_set.values)
        t = (data_set.binarised_values
             if use_binarised and data_set.binarised_values is not None
             else x)
    arrays: dict[str, Any] = {"x": x, "t": t}
    if use_count_sum_as_parameter:
        arrays["count_sum"] = data_set.count_sum.astype(np.float32)
    if use_count_sum_as_feature:
        arrays["count_sum_feature"] = data_set.normalised_count_sum.astype(
            np.float32)
    if include_batch_indices and data_set.batch_indices is not None:
        arrays["batch_indices"] = data_set.batch_indices.astype(np.int32)
    return arrays
