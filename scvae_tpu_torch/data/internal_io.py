"""Internal cache format: compressed HDF5 for data dictionaries.

The port's copy of ``scvae_tpu/data/internal_io.py`` with the same file
layout, so that each package reads the other's cache; the counterpart of
``scvae/data/internal_io.py`` (PyTables + zlib), rebuilt on h5py with gzip
compression.  Sparse matrices are stored as CSR component
arrays; nested dictionaries (split indices, feature mappings) become HDF5
groups.  Round-trips the data dictionaries produced by the loaders and the
preprocessing pipeline.  ``h5py`` is imported by the functions that read
or write a file, so importing this module needs none.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import scipy.sparse

from scvae_tpu_torch.data.sparse import SparseRowMatrix

_COMPRESSION = {"compression": "gzip", "compression_opts": 5}


def _save_item(group: "h5py.Group", key: str, value: Any) -> None:
    safe_key = key.replace("/", "$")
    if value is None:
        group.attrs[f"__none__{safe_key}"] = True
    elif scipy.sparse.issparse(value):
        sub = group.create_group(safe_key)
        sub.attrs["__type__"] = "csr_matrix"
        csr = scipy.sparse.csr_matrix(value)
        sub.create_dataset("data", data=csr.data, **_COMPRESSION)
        sub.create_dataset("indices", data=csr.indices, **_COMPRESSION)
        sub.create_dataset("indptr", data=csr.indptr, **_COMPRESSION)
        sub.attrs["shape"] = csr.shape
    elif isinstance(value, slice):
        sub = group.create_group(safe_key)
        sub.attrs["__type__"] = "slice"
        sub.attrs["start"] = -1 if value.start is None else value.start
        sub.attrs["stop"] = -1 if value.stop is None else value.stop
    elif isinstance(value, dict):
        sub = group.create_group(safe_key)
        sub.attrs["__type__"] = "dict"
        for k, v in value.items():
            _save_item(sub, str(k), v)
    elif isinstance(value, np.ndarray):
        if value.dtype.kind in ("U", "O"):
            data = np.char.encode(value.astype(str), "utf-8")
            ds = group.create_dataset(safe_key, data=data, **_COMPRESSION)
            ds.attrs["__type__"] = "string_array"
        else:
            group.create_dataset(safe_key, data=value, **_COMPRESSION)
    elif isinstance(value, (list, tuple)):
        _save_item(group, key, np.asarray(value))
    elif isinstance(value, (int, float, str, bool, np.integer, np.floating)):
        group.attrs[f"__scalar__{safe_key}"] = value
    else:
        raise TypeError(f"Cannot save {key!r} of type {type(value)}")


def _load_item(group: "h5py.Group", safe_key: str) -> Any:
    import h5py

    node = group[safe_key]
    if isinstance(node, h5py.Group):
        node_type = node.attrs.get("__type__")
        if node_type == "csr_matrix":
            matrix = scipy.sparse.csr_matrix(
                (node["data"][...], node["indices"][...], node["indptr"][...]),
                shape=tuple(node.attrs["shape"]),
            )
            return SparseRowMatrix(matrix)
        if node_type == "slice":
            start = int(node.attrs["start"])
            stop = int(node.attrs["stop"])
            return slice(
                None if start < 0 else start, None if stop < 0 else stop
            )
        if node_type == "dict":
            return _load_group(node)
        raise TypeError(f"Unknown group type for {safe_key!r}")
    data = node[...]
    if node.attrs.get("__type__") == "string_array":
        data = np.char.decode(data, "utf-8")
    return data


def _load_group(group: "h5py.Group") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for safe_key in group:
        out[safe_key.replace("$", "/")] = _load_item(group, safe_key)
    for attr in group.attrs:
        if attr.startswith("__none__"):
            out[attr[len("__none__"):].replace("$", "/")] = None
        elif attr.startswith("__scalar__"):
            value = group.attrs[attr]
            if isinstance(value, bytes):
                value = value.decode("utf-8")
            out[attr[len("__scalar__"):].replace("$", "/")] = value
    return out


def save_data_dictionary(data_dictionary: dict[str, Any], path: str) -> None:
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp_path = path + ".tmp"
    with h5py.File(tmp_path, "w") as f:
        for key, value in data_dictionary.items():
            _save_item(f, key, value)
    os.replace(tmp_path, path)


def load_data_dictionary(path: str) -> dict[str, Any]:
    import h5py

    with h5py.File(path, "r") as f:
        return _load_group(f)
