"""Data-format loaders.

The port's copy of ``scvae_tpu/data/loaders.py``, the counterpart of the
reference's loader registry (``scvae/data/loaders.py:48-1030``): each
loader takes a ``paths`` dictionary shaped like
``{"values": {"full": path}, "labels": {"full": path}}`` (or ``{"all": …}``)
and returns a data dictionary with ``values`` (examples × features),
``labels``, ``example names``, ``feature names`` and optional ``batch
indices`` / ``split indices`` / ``feature mapping``.

Implementation differences from the reference: Loom files are read with
h5py directly (loompy is not a dependency; a ``.loom`` is an HDF5 file with
``/matrix`` genes×cells plus ``row_attrs``/``col_attrs``), and 10x HDF5 /
matrix-market loading is done with h5py + scipy.  ``pandas`` and ``h5py``
are imported by the loaders that read with them, so importing this module
(and building the development set) needs neither.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Any, Callable

import numpy as np
import scipy.io
import scipy.sparse

from scvae_tpu_torch.data.sparse import SparseRowMatrix

LOADERS: dict[str, Callable] = {}

DEVELOPMENT_SEED = 60  # reference loaders.py:945


def _register_loader(name: str):
    def decorator(function):
        LOADERS[name] = function
        return function

    return decorator


def _open_maybe_gzip(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# --------------------------------------------------------------------------
# Generic delimited matrices
# --------------------------------------------------------------------------


def _load_labels_from_delimiter_separated_values(
    path: str,
    example_names: np.ndarray,
    label_column: Any = 1,
    example_column: Any = 0,
    delimiter: str | None = None,
    header: Any = "infer",
    dtype: Any = None,
    default_label: Any = 0,
):
    """Join a labels table onto example names (reference
    ``loaders.py:~1040``)."""
    import pandas as pd

    if delimiter is None:
        delimiter = "\t" if path.endswith((".tsv", ".tsv.gz", ".txt", ".txt.gz")) else ","
    table = pd.read_csv(path, sep=delimiter, header=header)
    if isinstance(example_column, int):
        example_column = table.columns[example_column]
    if isinstance(label_column, int):
        label_column = table.columns[label_column]
    if example_column not in table.columns or label_column not in table.columns:
        raise ValueError(
            f"Cannot find columns {example_column!r}/{label_column!r} in {path}"
        )
    mapping = dict(zip(table[example_column].astype(str), table[label_column]))
    labels = np.array(
        [mapping.get(str(name), default_label) for name in example_names]
    )
    if dtype:
        labels = labels.astype(dtype)
    return labels


def _load_matrix(path: str, orientation: str):
    """Delimited numeric matrix; ``fbe`` = features×examples (transposed on
    load), ``ebf`` = examples×features."""
    import pandas as pd

    table = pd.read_csv(path, sep=None, engine="python", index_col=0)
    values = table.values
    if orientation == "fbe":
        example_names = table.columns.to_numpy(dtype=str)
        feature_names = table.index.to_numpy(dtype=str)
        values = values.T
    elif orientation == "ebf":
        example_names = table.index.to_numpy(dtype=str)
        feature_names = table.columns.to_numpy(dtype=str)
    else:
        raise ValueError(f"Unknown matrix orientation {orientation!r}")
    values = SparseRowMatrix(
        scipy.sparse.csr_matrix(values.astype(np.float32))
    )
    return values, example_names, feature_names


def _load_values_and_labels_from_matrix(paths: dict, orientation: str):
    values, example_names, feature_names = _load_matrix(
        paths["values"]["full"], orientation
    )
    labels = None
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        labels = _load_labels_from_delimiter_separated_values(
            path=full_labels_path, example_names=example_names, dtype="U"
        )
    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": feature_names,
    }


@_register_loader("matrix_fbe")
def _load_fbe_matrix_as_data_set(paths):
    return _load_values_and_labels_from_matrix(paths, orientation="fbe")


@_register_loader("matrix_ebf")
def _load_ebf_matrix_as_data_set(paths):
    return _load_values_and_labels_from_matrix(paths, orientation="ebf")


# --------------------------------------------------------------------------
# 10x Genomics
# --------------------------------------------------------------------------


def _read_10x_triplet(open_member):
    """Read matrix.mtx + genes/features + barcodes via a member-opening
    callable mapping suffix → file object (works for dirs and tarballs)."""
    import pandas as pd

    matrix = scipy.io.mmread(open_member("matrix.mtx"))
    # 10x matrices are genes × cells
    values = SparseRowMatrix(scipy.sparse.csr_matrix(matrix.T, dtype=np.float32))

    genes_file = open_member("genes.tsv", optional=True) or open_member(
        "features.tsv", optional=True
    )
    if genes_file is None:
        raise FileNotFoundError("No genes.tsv/features.tsv next to matrix.mtx")
    genes = pd.read_csv(genes_file, sep="\t", header=None)
    feature_ids = genes[0].to_numpy(dtype=str)
    feature_names = (
        genes[1].to_numpy(dtype=str) if genes.shape[1] > 1 else feature_ids
    )

    barcodes = pd.read_csv(open_member("barcodes.tsv"), sep="\t", header=None)
    example_names = barcodes[0].to_numpy(dtype=str)

    return values, example_names, feature_names, feature_ids


def _load_values_from_10x_data_set(path: str):
    if os.path.isdir(path):

        def open_member(suffix, optional=False):
            for candidate in (suffix, suffix + ".gz"):
                member_path = os.path.join(path, candidate)
                if os.path.exists(member_path):
                    return _open_maybe_gzip(member_path, "rb")
            # search one level of subdirectories (10x tarballs unpack into one)
            for root, _dirs, files in os.walk(path):
                for f in files:
                    if f in (suffix, suffix + ".gz"):
                        return _open_maybe_gzip(os.path.join(root, f), "rb")
            if optional:
                return None
            raise FileNotFoundError(f"{suffix} not found under {path}")

        return _read_10x_triplet(open_member)

    if path.endswith((".tar.gz", ".tgz", ".tar")):
        tar = tarfile.open(path)
        members = {os.path.basename(m.name): m for m in tar.getmembers()}

        def open_member(suffix, optional=False):
            for candidate in (suffix, suffix + ".gz"):
                if candidate in members:
                    fobj = tar.extractfile(members[candidate])
                    if candidate.endswith(".gz"):
                        return gzip.open(fobj)
                    return fobj
            if optional:
                return None
            raise FileNotFoundError(f"{suffix} not found in {path}")

        return _read_10x_triplet(open_member)

    if path.endswith((".h5", ".hdf5")):
        d = _load_sparse_matrix_in_hdf5_format(path)
        return (
            d["values"],
            d["example names"],
            d["feature names"],
            d.get("feature ids", d["feature names"]),
        )

    raise ValueError(f"Cannot interpret 10x data at {path}")


@_register_loader("10x")
def _load_10x_data_set(paths):
    values, example_names, feature_names, feature_ids = (
        _load_values_from_10x_data_set(paths["values"]["full"])
    )
    labels = None
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        labels = _load_labels_from_delimiter_separated_values(
            path=full_labels_path,
            label_column="celltype",
            example_column="barcodes",
            example_names=example_names,
            dtype="U",
        )
    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": feature_names,
        "feature IDs": feature_ids,
    }


@_register_loader("10x_combine")
def _load_and_combine_10x_data_sets(paths):
    """Combine several 10x matrices over shared features, adding batch
    indices per source (reference ``loaders.py:152-222``)."""
    value_sets, example_sets, feature_sets = {}, {}, {}
    sources = paths.get("all") or paths["values"]
    for class_name, path in sorted(sources.items()):
        values, example_names, feature_names, _ = _load_values_from_10x_data_set(
            path
        )
        value_sets[class_name] = values
        example_sets[class_name] = example_names
        feature_sets[class_name] = feature_names

    names = sorted(value_sets)
    reference_features = feature_sets[names[0]]
    for name in names[1:]:
        if not np.array_equal(feature_sets[name], reference_features):
            raise ValueError("10x data sets do not share feature names.")

    values = SparseRowMatrix(
        scipy.sparse.vstack([value_sets[name] for name in names])
    )
    example_names = np.concatenate(
        [
            np.array([f"{name} {e}" for e in example_sets[name]])
            for name in names
        ]
    )
    labels = np.concatenate(
        [np.full(value_sets[name].shape[0], name, dtype=object) for name in names]
    ).astype(str)
    batch_indices = np.concatenate(
        [np.full(value_sets[name].shape[0], i) for i, name in enumerate(names)]
    )
    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": reference_features,
        "batch indices": batch_indices,
    }


# --------------------------------------------------------------------------
# HDF5 (CellRanger-style) and Loom
# --------------------------------------------------------------------------


def _load_sparse_matrix_in_hdf5_format(path: str):
    """CellRanger HDF5: one genome group holding a CSC genes×cells matrix."""
    import h5py

    with h5py.File(path, "r") as f:
        # CellRanger v3 uses /matrix; v2 a genome-named group.
        if "matrix" in f:
            group = f["matrix"]
        else:
            group = f[next(iter(f.keys()))]
        data = group["data"][...]
        indices = group["indices"][...]
        indptr = group["indptr"][...]
        shape = tuple(group["shape"][...])
        matrix = scipy.sparse.csc_matrix((data, indices, indptr), shape=shape)
        values = SparseRowMatrix(
            scipy.sparse.csr_matrix(matrix.T, dtype=np.float32)
        )
        if "features" in group:  # v3 layout
            feature_ids = group["features"]["id"][...].astype(str)
            feature_names = group["features"]["name"][...].astype(str)
        else:
            feature_ids = group["genes"][...].astype(str)
            feature_names = group["gene_names"][...].astype(str)
        example_names = group["barcodes"][...].astype(str)
    return {
        "values": values,
        "example names": example_names,
        "feature names": feature_names,
        "feature ids": feature_ids,
    }


@_register_loader("h5")
def _load_h5_data_set(paths):
    d = _load_sparse_matrix_in_hdf5_format(paths["values"]["full"])
    labels = None
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        labels = _load_labels_from_delimiter_separated_values(
            path=full_labels_path,
            example_names=d["example names"],
            dtype="U",
        )
    return {
        "values": d["values"],
        "labels": labels,
        "example names": d["example names"],
        "feature names": d["feature names"],
    }


@_register_loader("loom")
def _load_loom_data_set(paths):
    """Loom = HDF5 with /matrix genes×cells, /row_attrs, /col_attrs
    (reference ``loaders.py:339-391``, reimplemented over h5py)."""
    import h5py

    with h5py.File(paths["all"]["full"], "r") as f:
        matrix = f["matrix"][...]
        values = SparseRowMatrix(
            scipy.sparse.csr_matrix(matrix.T.astype(np.float32))
        )
        n_examples, n_features = values.shape
        ca = f.get("col_attrs", {})
        ra = f.get("row_attrs", {})
        attrs = f.attrs

        labels = None
        if "ClusterName" in ca:
            labels = ca["ClusterName"][...].astype("U")
        elif "ClusterID" in ca:
            cluster_ids = ca["ClusterID"][...].flatten()
            if "CellTypes" in attrs:
                class_names = np.asarray(attrs["CellTypes"]).astype("U")
                labels = np.array(
                    [class_names[int(cid)] for cid in cluster_ids]
                )
            else:
                labels = cluster_ids

        if "CellID" in ca:
            example_names = ca["CellID"][...].astype("U")
        elif "Cell" in ca:
            example_names = ca["Cell"][...].astype("U")
        else:
            example_names = np.array(
                [f"Cell {j + 1}" for j in range(n_examples)]
            )

        if "Gene" in ra:
            feature_names = ra["Gene"][...].astype("U")
        else:
            feature_names = np.array(
                [f"Gene {j + 1}" for j in range(n_features)]
            )

        batch_indices = ca["BatchID"][...].flatten() if "BatchID" in ca else None

    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": feature_names,
        "batch indices": batch_indices,
    }


# --------------------------------------------------------------------------
# Named study formats
# --------------------------------------------------------------------------


@_register_loader("macosko")
def _load_macosko_data_set(paths):
    """Macosko retina: genes×cells TSV + cluster-identity labels
    (reference ``loaders.py:58-92``)."""
    import pandas as pd

    values, example_names, feature_names = _load_matrix(
        paths["values"]["full"], orientation="fbe"
    )
    labels = None
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        table = pd.read_csv(full_labels_path, sep="\t", header=None)
        mapping = dict(zip(table[0].astype(str), table[1]))
        labels = np.array(
            [int(mapping.get(str(name), 0)) for name in example_names]
        )
    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": feature_names,
    }


def _load_transposed_tsv_with_mapping(path: str):
    values, example_names, feature_names = _load_matrix(path, orientation="fbe")
    return {
        "values": values,
        "labels": None,
        "example names": example_names,
        "feature names": feature_names,
    }


@_register_loader("tcga")
def _load_tcga_data_set(paths):
    """TCGA RSEM/Kallisto gene expression: log2-normalised genes×samples
    TSV rounded back to counts via ``round(2^x − 1)``, with an external
    gene-ID→name mapping file (reference ``loaders.py:223-282``)."""
    data = _load_transposed_tsv_with_mapping(paths["values"]["full"])
    dense = np.asarray(data["values"].todense())
    dense = np.round(np.power(2.0, dense) - 1.0)
    data["values"] = SparseRowMatrix(
        scipy.sparse.csr_matrix(dense.astype(np.float32))
    )
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        data["labels"] = _load_labels_from_delimiter_separated_values(
            path=full_labels_path,
            label_column="_primary_site",
            example_column="sampleID",
            example_names=data["example names"],
            dtype="U",
            default_label="No class",
        )
    mapping_path = paths.get("feature mapping", {}).get("full")
    if mapping_path:
        mapping: dict[str, list[str]] = {}
        with _open_maybe_gzip(mapping_path, "rt") as mapping_file:
            for row in mapping_file:
                if row.startswith("#"):
                    continue
                elements = row.split()
                feature_id, feature_name = elements[0], elements[1]
                mapping.setdefault(feature_name, []).append(feature_id)
        data["feature mapping"] = mapping
    return data


@_register_loader("gtex")
def _load_gtex_data_set(paths):
    """GTEx gene read counts: genes×samples TSV with gene-ID + description
    columns that seed the feature mapping (reference ``loaders.py:285-337``)."""
    import pandas as pd

    with _open_maybe_gzip(paths["values"]["full"], "rt") as fobj:
        # GTEx GCT files carry two header lines before the table.
        first = fobj.readline()
        if first.startswith("#") or first.strip() == "#1.2":
            fobj.readline()
            table = pd.read_csv(fobj, sep="\t", index_col=0)
        else:
            fobj.seek(0)
            table = pd.read_csv(fobj, sep="\t", index_col=0)
    mapping: dict[str, list[str]] | None = None
    if "Description" in table.columns:
        descriptions = table.pop("Description")
        mapping = {}
        for fid, desc in zip(table.index, descriptions):
            mapping.setdefault(str(desc), []).append(str(fid))
    values = SparseRowMatrix(
        scipy.sparse.csr_matrix(table.values.T.astype(np.float32))
    )
    data = {
        "values": values,
        "labels": None,
        "example names": table.columns.to_numpy(dtype=str),
        "feature names": table.index.to_numpy(dtype=str),
    }
    if mapping:
        data["feature mapping"] = mapping
    full_labels_path = paths.get("labels", {}).get("full")
    if full_labels_path:
        data["labels"] = _load_labels_from_delimiter_separated_values(
            path=full_labels_path,
            label_column="SMTSD",
            example_column="SAMPID",
            example_names=data["example names"],
            dtype="U",
        )
    return data


# --------------------------------------------------------------------------
# MNIST (image benchmark formats)
# --------------------------------------------------------------------------


@_register_loader("mnist_original")
def _load_original_mnist_data_set(paths):
    values = {}
    for kind in paths["values"]:
        with gzip.open(paths["values"][kind], mode="rb") as stream:
            _, m, r, c = struct.unpack(">IIII", stream.read(16))
            buffer = stream.read(m * r * c)
            values[kind] = np.frombuffer(buffer, dtype=np.uint8).reshape(
                -1, r * c
            )
    n = r * c
    labels = {}
    for kind in paths["labels"]:
        with gzip.open(paths["labels"][kind], mode="rb") as stream:
            _, m = struct.unpack(">II", stream.read(8))
            labels[kind] = np.frombuffer(stream.read(m), dtype=np.int8)

    m_training = values["training"].shape[0]
    m_total = m_training + values["test"].shape[0]
    split_indices = {
        "training": slice(0, m_training),
        "test": slice(m_training, m_total),
    }
    all_values = np.concatenate(
        (values["training"], values["test"])
    ).astype(np.float32)
    all_labels = np.concatenate((labels["training"], labels["test"]))
    return {
        "values": SparseRowMatrix(scipy.sparse.csr_matrix(all_values)),
        "labels": all_labels,
        "example names": np.array(
            [f"image {i + 1}" for i in range(m_total)]
        ),
        "feature names": np.array([f"pixel {j + 1}" for j in range(n)]),
        "split indices": split_indices,
    }


def _load_pickled_mnist(path: str, binarised: bool):
    with gzip.open(path, "rb") as data_file:
        if binarised:
            train, valid, test = pickle.load(data_file, encoding="latin1")
            sets = {
                "training": (train, None),
                "validation": (valid, None),
                "test": (test, None),
            }
        else:
            (xt, yt), (xv, yv), (xe, ye) = pickle.load(
                data_file, encoding="latin1"
            )
            sets = {
                "training": (xt, yt),
                "validation": (xv, yv),
                "test": (xe, ye),
            }

    offsets, pieces, label_pieces = {}, [], []
    cursor = 0
    for kind in ("training", "validation", "test"):
        x, y = sets[kind]
        offsets[kind] = slice(cursor, cursor + x.shape[0])
        cursor += x.shape[0]
        pieces.append(x)
        if y is not None:
            label_pieces.append(y)
    values = np.concatenate(pieces).astype(np.float32)
    labels = np.concatenate(label_pieces) if label_pieces else None
    n = values.shape[1]
    return {
        "values": SparseRowMatrix(scipy.sparse.csr_matrix(values)),
        "labels": labels,
        "example names": np.array(
            [f"image {i + 1}" for i in range(cursor)]
        ),
        "feature names": np.array([f"pixel {j + 1}" for j in range(n)]),
        "split indices": offsets,
    }


@_register_loader("mnist_keras")
def _load_keras_mnist_data_set(paths):
    """Keras-style ``mnist.npz`` (x_train/y_train/x_test/y_test arrays) —
    reference ``loaders.py:542-584`` uses ``keras.datasets``; here the npz
    is read directly."""
    with np.load(paths["all"]["full"], allow_pickle=False) as archive:
        x_train = archive["x_train"]
        y_train = archive["y_train"]
        x_test = archive["x_test"]
        y_test = archive["y_test"]
    m_training = x_train.shape[0]
    m_total = m_training + x_test.shape[0]
    n = int(np.prod(x_train.shape[1:]))
    values = np.concatenate(
        (x_train.reshape(-1, n), x_test.reshape(-1, n))
    ).astype(np.float32)
    labels = np.concatenate((y_train, y_test))
    return {
        "values": SparseRowMatrix(scipy.sparse.csr_matrix(values)),
        "labels": labels,
        "example names": np.array(
            [f"image {i + 1}" for i in range(m_total)]
        ),
        "feature names": np.array([f"pixel {j + 1}" for j in range(n)]),
        "split indices": {
            "training": slice(0, m_training),
            "test": slice(m_training, m_total),
        },
    }


@_register_loader("mnist_normalised")
def _load_normalised_mnist_data_set(paths):
    return _load_pickled_mnist(paths["all"]["full"], binarised=False)


@_register_loader("mnist_binarised")
def _load_binarised_mnist_data_set(paths):
    return _load_pickled_mnist(paths["all"]["full"], binarised=True)


# --------------------------------------------------------------------------
# Synthetic development set (test/parity fixture)
# --------------------------------------------------------------------------


@_register_loader("development")
def _load_development_data_set(paths=None):
    return create_development_data_set()


def create_development_data_set(
    n_examples: int = 10000,
    n_features: int = 25,
    scale: float = 10,
    update_probability: float = 0.0001,
):
    """Seeded synthetic ZINB data with latent types and a feature mapping —
    draw-order-faithful to the reference generator
    (``scvae/data/loaders.py:942-1022``, seed 60) so cached values and
    splits are bit-identical for parity testing."""
    random_state = np.random.RandomState(DEVELOPMENT_SEED)

    values = np.empty((n_examples, n_features), np.float32)
    labels = np.empty(n_examples, np.int32)
    r = np.empty((n_examples, n_features))
    p = np.empty((n_examples, n_features))
    dropout = np.empty((n_examples, n_features))

    def draw():
        return random_state.rand(n_features)

    r_type = scale * draw()
    p_type = draw()
    dropout_type = draw()

    label = 1
    for i in range(n_examples):
        u = random_state.rand()
        if u > 1 - update_probability:
            r_type = scale * draw()
            p_type = draw()
            dropout_type = draw()
            label += 1
        r[i] = r_type
        p[i] = p_type
        dropout[i] = dropout_type
        labels[i] = label

    shuffled = random_state.permutation(n_examples)
    r, p, dropout, labels = r[shuffled], p[shuffled], dropout[shuffled], labels[shuffled]

    no_class_indices = random_state.permutation(n_examples)[
        : int(0.1 * n_examples)
    ]
    labels[no_class_indices] = 0
    labels = labels.astype(str)

    for i in range(n_examples):
        for j in range(n_features):
            value = random_state.negative_binomial(r[i, j], p[i, j])
            value_dropout = random_state.binomial(1, dropout[i, j])
            values[i, j] = value_dropout * value

    example_names = np.array(
        [f"example {i + 1}" for i in range(n_examples)]
    )
    feature_ids = np.array([f"feature {j + 1}" for j in range(n_features)])
    feature_names = ["feature " + n for n in "ABCDE"]
    feature_id_groups = np.split(feature_ids, len(feature_names))
    feature_mapping = {
        name: group.tolist()
        for name, group in zip(feature_names, feature_id_groups)
    }

    return {
        "values": values,
        "labels": labels,
        "example names": example_names,
        "feature names": feature_ids,
        "feature mapping": feature_mapping,
    }
