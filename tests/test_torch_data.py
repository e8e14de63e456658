"""The port's data engine against the JAX package's on the CPU, on the same
inputs: every local loader on tiny files in its format, the HDF5 cache in
both directions, feature mapping and selection, example filters,
preprocessors and splits, ``DataSet`` (superset labels, excluded classes,
predictions, binarisation, the whole load → cache → preprocess → split
path), the evaluation subset, ``save_values``, the mapping of clusters to
labels, the float values a model stages, and a subprocess in which
``pandas``, ``h5py`` and ``sklearn`` cannot be imported.

Values, labels, names and indices are compared exactly, with their dtypes;
float preprocessing at rtol 1e-6 (the port normalises and binarises with
numpy and scipy where the JAX package calls scikit-learn).
"""

import gzip
import io
import json
import os
import pathlib
import pickle
import struct
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import scipy.io
import scipy.sparse
import sklearn.preprocessing
import torch

from scvae_tpu.analyses.prediction import (
    map_cluster_ids_to_label_ids as jax_map_cluster_ids_to_label_ids,
)
from scvae_tpu.data import dataset as jdataset
from scvae_tpu.data import internal_io as jinternal_io
from scvae_tpu.data import loaders as jloaders
from scvae_tpu.data import loading as jloading
from scvae_tpu.data import parsing as jparsing
from scvae_tpu.data import processing as jprocessing
from scvae_tpu.data import sparse as jsparse
from scvae_tpu.data import utilities as jutilities
from scvae_tpu.models.gmvae_api import (
    GaussianMixtureVariationalAutoencoder as JaxGMVAE,
)
from scvae_tpu_torch import GaussianMixtureVariationalAutoencoder
from scvae_tpu_torch.analyses.prediction import map_cluster_ids_to_label_ids
from scvae_tpu_torch.data import (
    dataset,
    internal_io,
    loaders,
    loading,
    parsing,
    pipeline,
    processing,
    sparse,
    utilities,
)
from scvae_tpu_torch.utils import strings

REPO = pathlib.Path(__file__).resolve().parents[1]
N_CELLS, N_GENES = 12, 7


def _same(got, want, path="value"):
    """Exact equality of loader and cache outputs, dtypes included."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), path
        for key in want:
            _same(got[key], want[key], f"{path}[{key!r}]")
    elif scipy.sparse.issparse(want):
        assert scipy.sparse.issparse(got), path
        assert type(got).__name__ == type(want).__name__, path
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got.toarray(), want.toarray(),
                                      err_msg=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _counts(seed=0, shape=(N_CELLS, N_GENES)):
    return np.random.RandomState(seed).poisson(1.5, shape)


def _barcodes(n=N_CELLS):
    return [f"AAAC{i:03d}-1" for i in range(n)]


def _genes(n=N_GENES):
    return [f"Gene{i}" for i in range(n)]


def _gene_ids(n=N_GENES):
    return [f"ENSG{i:05d}" for i in range(n)]


def _labels(n=N_CELLS):
    return ["TypeA" if i % 3 else "TypeB" for i in range(n)]


# -- files in each local format ---------------------------------------------


def _write_table(path, header, names, rows, delimiter="\t"):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(delimiter.join(header) + "\n")
        for name, row in zip(names, rows):
            f.write(delimiter.join([name] + [str(v) for v in row]) + "\n")
    return str(path)


def _labels_file(tmp_path, example_column="cell", label_column="type",
                 labels=None, delimiter="\t", filename="labels.tsv"):
    labels = _labels() if labels is None else labels
    return _write_table(tmp_path / filename, [example_column, label_column],
                        _barcodes(), [[label] for label in labels],
                        delimiter)


def _matrix_ebf(tmp_path):
    dense = _counts(1)
    values = _write_table(tmp_path / "m.tsv", ["cell"] + _genes(),
                          _barcodes(), dense)
    return {"values": {"full": values},
            "labels": {"full": _labels_file(tmp_path)}}


def _matrix_fbe(tmp_path):
    dense = _counts(2)
    values = _write_table(tmp_path / "m.tsv.gz", ["gene"] + _barcodes(),
                          _genes(), dense.T)
    return {"values": {"full": values}}


def _tenx_directory(directory, dense, barcodes=None):
    os.makedirs(directory, exist_ok=True)
    scipy.io.mmwrite(os.path.join(directory, "matrix.mtx"),
                     scipy.sparse.coo_matrix(dense.T), field="integer")
    with open(os.path.join(directory, "genes.tsv"), "w") as f:
        f.writelines(f"{i}\t{n}\n" for i, n in zip(_gene_ids(), _genes()))
    with open(os.path.join(directory, "barcodes.tsv"), "w") as f:
        f.writelines(f"{b}\n" for b in (barcodes or _barcodes()))
    return str(directory)


def _tenx(tmp_path):
    directory = _tenx_directory(tmp_path / "tenx", _counts(3))
    labels = _labels_file(tmp_path, "barcodes", "celltype", delimiter=",",
                          filename="labels.csv")
    return {"values": {"full": directory}, "labels": {"full": labels}}


def _tenx_tarball(tmp_path):
    dense = _counts(4)
    mtx = io.BytesIO()
    scipy.io.mmwrite(mtx, scipy.sparse.coo_matrix(dense.T), field="integer")
    genes = "".join(f"{i}\t{n}\n" for i, n in zip(_gene_ids(), _genes()))
    barcodes = "".join(f"{b}\n" for b in _barcodes())
    path = str(tmp_path / "tenx.tar.gz")
    with tarfile.open(path, "w:gz") as tar:
        for name, payload in [
            ("filtered/matrix.mtx.gz", gzip.compress(mtx.getvalue())),
            ("filtered/genes.tsv.gz", gzip.compress(genes.encode())),
            ("filtered/barcodes.tsv.gz", gzip.compress(barcodes.encode())),
        ]:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return {"values": {"full": path}}


def _tenx_combine(tmp_path):
    return {"all": {
        name: _tenx_directory(tmp_path / name, _counts(seed),
                              [f"{name}{b}" for b in _barcodes()])
        for seed, name in ((5, "B cells"), (6, "A cells"))
    }}


def _cellranger_h5(path, dense, version):
    import h5py

    csc = scipy.sparse.csc_matrix(dense.T)  # genes × cells
    with h5py.File(path, "w") as f:
        group = f.create_group("matrix" if version == 3 else "GRCh38")
        group.create_dataset("data", data=csc.data.astype(np.int32))
        group.create_dataset("indices", data=csc.indices.astype(np.int64))
        group.create_dataset("indptr", data=csc.indptr.astype(np.int64))
        group.create_dataset("shape", data=np.asarray(csc.shape, np.int32))
        group.create_dataset("barcodes", data=np.array(_barcodes(), "S"))
        if version == 3:
            features = group.create_group("features")
            features.create_dataset("id", data=np.array(_gene_ids(), "S"))
            features.create_dataset("name", data=np.array(_genes(), "S"))
        else:
            group.create_dataset("genes", data=np.array(_gene_ids(), "S"))
            group.create_dataset("gene_names", data=np.array(_genes(), "S"))
    return str(path)


def _h5(version):
    def build(tmp_path):
        pytest.importorskip("h5py")
        path = _cellranger_h5(tmp_path / "m.h5", _counts(7), version)
        return {"values": {"full": path},
                "labels": {"full": _labels_file(tmp_path)}}
    return build


def _tenx_h5(tmp_path):
    pytest.importorskip("h5py")
    return {"values": {"full": _cellranger_h5(tmp_path / "m.h5", _counts(8),
                                              3)}}


def _loom(cluster_names):
    def build(tmp_path):
        h5py = pytest.importorskip("h5py")
        path = str(tmp_path / "d.loom")
        with h5py.File(path, "w") as f:
            f.create_dataset("matrix",
                             data=_counts(9).T.astype(np.float32))
            rows = f.create_group("row_attrs")
            rows.create_dataset("Gene", data=np.array(_genes(), "S"))
            columns = f.create_group("col_attrs")
            columns.create_dataset("CellID", data=np.array(_barcodes(), "S"))
            if cluster_names:
                columns.create_dataset("ClusterName",
                                       data=np.array(_labels(), "S"))
            else:
                columns.create_dataset("ClusterID",
                                       data=np.arange(N_CELLS) % 3)
                columns.create_dataset("BatchID", data=np.arange(N_CELLS) % 2)
                f.attrs["CellTypes"] = np.array(["T", "B", "NK"], "S")
        return {"all": {"full": path}}
    return build


def _macosko(tmp_path):
    values = _write_table(tmp_path / "expr.txt", ["gene"] + _barcodes(),
                          _genes(), _counts(10).T)
    labels = str(tmp_path / "clusters.txt")
    with open(labels, "w") as f:
        f.writelines(f"{b}\t{i % 5}\n" for i, b in enumerate(_barcodes()[1:]))
    return {"values": {"full": values}, "labels": {"full": labels}}


def _tcga(tmp_path):
    log_values = np.log2(_counts(11) + 1.0).round(4)
    values = _write_table(tmp_path / "tcga.tsv.gz", ["sample"] + _barcodes(),
                          _gene_ids(), log_values.T)
    labels = _labels_file(tmp_path, "sampleID", "_primary_site",
                          labels=_labels()[:-1] + ["Lung"])
    mapping = str(tmp_path / "probemap.tsv")
    with open(mapping, "w") as f:
        f.write("#id\tgene\n")
        f.writelines(f"{i}\t{n[:5]}\n" for i, n in zip(_gene_ids(), _genes()))
    return {"values": {"full": values}, "labels": {"full": labels},
            "feature mapping": {"full": mapping}}


def _gtex(tmp_path):
    path = str(tmp_path / "gtex.gct")
    dense = _counts(12)
    with open(path, "w") as f:
        f.write("#1.2\n")
        f.write(f"{N_GENES}\t{N_CELLS}\n")
        f.write("Name\tDescription\t" + "\t".join(_barcodes()) + "\n")
        for j, (gene_id, name) in enumerate(zip(_gene_ids(), _genes())):
            f.write(f"{gene_id}\t{name[:5]}\t"
                    + "\t".join(map(str, dense[:, j])) + "\n")
    labels = _labels_file(tmp_path, "SAMPID", "SMTSD")
    return {"values": {"full": path}, "labels": {"full": labels}}


def _idx(path, array, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for size in array.shape:
            f.write(struct.pack(">I", size))
        f.write(array.tobytes())
    return str(path)


def _mnist_original(tmp_path):
    rng = np.random.RandomState(13)
    paths = {"values": {}, "labels": {}}
    for kind, n in (("training", 5), ("test", 3)):
        images = rng.randint(0, 256, (n, 4, 4)).astype(np.uint8)
        labels = rng.randint(0, 10, n).astype(np.int8)
        paths["values"][kind] = _idx(tmp_path / f"{kind}-images.gz", images,
                                     2051)
        paths["labels"][kind] = _idx(tmp_path / f"{kind}-labels.gz", labels,
                                     2049)
    return paths


def _mnist_pickle(binarised):
    def build(tmp_path):
        rng = np.random.RandomState(14)
        sets = []
        for n in (6, 2, 3):
            x = rng.rand(n, 9).astype(np.float32)
            sets.append(x.round() if binarised
                        else (x, rng.randint(0, 10, n)))
        path = str(tmp_path / "mnist.pkl.gz")
        with gzip.open(path, "wb") as f:
            pickle.dump(tuple(sets), f)
        return {"all": {"full": path}}
    return build


def _mnist_keras(tmp_path):
    rng = np.random.RandomState(15)
    path = str(tmp_path / "mnist.npz")
    np.savez(path, x_train=rng.randint(0, 256, (5, 3, 3), np.uint8),
             y_train=rng.randint(0, 10, 5), x_test=rng.randint(
                 0, 256, (2, 3, 3), np.uint8), y_test=rng.randint(0, 10, 2))
    return {"all": {"full": path}}


LOADER_CASES = {
    "matrix_ebf": _matrix_ebf,
    "matrix_fbe": _matrix_fbe,
    "10x": _tenx,
    "10x tar.gz": _tenx_tarball,
    "10x h5": _tenx_h5,
    "10x_combine": _tenx_combine,
    "h5 v3": _h5(3),
    "h5 v2": _h5(2),
    "loom names": _loom(True),
    "loom ids": _loom(False),
    "macosko": _macosko,
    "tcga": _tcga,
    "gtex": _gtex,
    "mnist_original": _mnist_original,
    "mnist_normalised": _mnist_pickle(False),
    "mnist_binarised": _mnist_pickle(True),
    "mnist_keras": _mnist_keras,
}


def test_every_loader_is_covered():
    names = {case.split()[0] for case in LOADER_CASES} | {"development"}
    assert names == set(jloaders.LOADERS) == set(loaders.LOADERS)


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_matches_jax(case, tmp_path):
    paths = LOADER_CASES[case](tmp_path)
    data_format = case.split()[0]
    got = loading.load_original_data_set(paths, data_format)
    want = jloading.load_original_data_set(paths, data_format)
    _same(got, want)
    assert isinstance(got["values"], sparse.SparseRowMatrix)


def test_development_set_matches_jax():
    got = loaders.create_development_data_set(n_examples=400)
    want = jloaders.create_development_data_set(n_examples=400)
    _same(got, want)
    assert got["labels"].dtype.kind == "U"
    _same(loaders.LOADERS["development"](None),
          jloaders.LOADERS["development"](None))


# -- name resolution and acquisition ----------------------------------------


def test_parsing_matches_jax(tmp_path):
    assert parsing.DATA_SET_CATALOGUE == jparsing.DATA_SET_CATALOGUE
    values = _write_table(tmp_path / "cells.tsv.gz", ["cell"] + _genes(),
                          _barcodes(), _counts())
    spec = str(tmp_path / "cells.json")
    with open(spec, "w") as f:
        json.dump({"values": "cells.tsv.gz", "labels": "labels.tsv",
                   "format": "matrix_ebf"}, f)
    for name in ("development", "Macosko-MRC", "mnist (original)", values,
                 spec):
        assert parsing.parse_input(name) == jparsing.parse_input(name)
    with pytest.raises(KeyError):
        parsing.parse_input("no such set")


class FakeResponse:
    """What ``_download`` reads of a streamed ``requests`` response: the
    body in chunks, or an HTTP error status."""

    def __init__(self, body=b"", status=200):
        self.body, self.status = body, status

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def raise_for_status(self):
        import requests

        if self.status >= 400:
            raise requests.HTTPError(f"{self.status} error")

    def iter_content(self, chunk_size=1):
        for start in range(0, len(self.body), chunk_size):
            yield self.body[start:start + chunk_size]


def test_acquisition_downloads_to_jax_path(tmp_path, monkeypatch):
    import requests

    body = b"cell\tgene\n" * 40_000  # over one 1 MiB chunk
    requested = []

    def get(url, stream=False, timeout=None):
        requested.append((url, stream, timeout))
        return FakeResponse(body)

    monkeypatch.setattr(requests, "get", get)
    urls = {"values": {"full": "https://example.org/x/counts.tsv.gz"},
            "labels": {"full": str(tmp_path)}}
    got = loading.acquire_data_set("Set", urls, str(tmp_path / "port"))
    want = jloading.acquire_data_set("Set", urls, str(tmp_path / "jax"))
    assert requested == [("https://example.org/x/counts.tsv.gz", True, 60)] * 2
    where = os.path.join("Set", "Set-values-full-counts.tsv.gz")
    assert got["values"]["full"] == os.path.join(str(tmp_path / "port"), where)
    assert want["values"]["full"] == os.path.join(str(tmp_path / "jax"), where)
    assert got["labels"] == want["labels"] == {"full": str(tmp_path)}
    for side in ("port", "jax"):
        assert (tmp_path / side / where).read_bytes() == body
        assert os.listdir(tmp_path / side / "Set") == [os.path.basename(where)]
    # a file already at that path is used, with no request
    assert loading.acquire_data_set("Set", urls, str(tmp_path / "port")) == got
    assert len(requested) == 2
    with pytest.raises(FileNotFoundError, match="not a URL"):
        loading.acquire_data_set("Set", {"values": {"full": "nowhere.tsv"}},
                                 str(tmp_path))
    # a catalogue set whose files are missing downloads them, as JAX's
    # does; an HTTP error leaves no file behind
    monkeypatch.setattr(requests, "get",
                        lambda url, **_: FakeResponse(status=404))
    with pytest.raises(requests.HTTPError, match="404"):
        dataset.DataSet("10x-MBC-20k", directory=str(tmp_path / "c")).load()
    assert not [name for _, _, names in os.walk(tmp_path / "c")
                for name in names]


def test_strings_match_jax():
    from scvae_tpu.utils import strings as jstrings

    translation = {"negative binomial": ["nb", "negative_binomial"]}
    for text in ("Negative Binomial", "MNIST (original)", "a/b\\c|d?e*",
                 "10x-PBMC-68k", "nb"):
        assert strings.normalise_string(text) == jstrings.normalise_string(text)
        assert (strings.proper_string(text, translation)
                == jstrings.proper_string(text, translation))


# -- the HDF5 cache ---------------------------------------------------------


def _data_dictionary():
    rng = np.random.RandomState(16)
    return {
        "values": sparse.SparseRowMatrix(scipy.sparse.csr_matrix(
            rng.poisson(1, (20, 6)).astype(np.float32))),
        "labels": np.array(["a", "β cell", "No class", "b"] * 5),
        "example names": np.array([f"e{i}" for i in range(20)]),
        "feature names": np.array([f"f{i}" for i in range(6)]),
        "batch indices": np.arange(20) % 3,
        "preprocessed values": None,
        "split indices": {"training": slice(0, 15), "test": slice(15, None)},
        "feature mapping": {"A/B": ["f0", "f1"], "C": ["f2"]},
        "count": 7, "ratio": 0.5, "title": "t",
    }


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_read_by_both_packages(writer, tmp_path):
    pytest.importorskip("h5py")
    data = _data_dictionary()
    path = str(tmp_path / "cache.h5")
    save, load = ((internal_io.save_data_dictionary,
                   jinternal_io.load_data_dictionary) if writer == "port"
                  else (jinternal_io.save_data_dictionary,
                        internal_io.load_data_dictionary))
    save(data, path)
    loaded = load(path)
    reference = jinternal_io.load_data_dictionary(path)
    _same(loaded, reference)
    assert loaded["labels"].dtype.kind == "U"
    np.testing.assert_array_equal(loaded["labels"], data["labels"])
    assert loaded["split indices"]["test"] == slice(15, None)
    assert loaded["preprocessed values"] is None
    assert loaded["feature mapping"]["A/B"].tolist() == ["f0", "f1"]


# -- feature mapping and selection, filters, preprocessors, splits ----------


def _values(seed=17, shape=(40, 9)):
    rng = np.random.RandomState(seed)
    dense = rng.poisson(rng.rand(1, shape[1]) * 4, shape).astype(np.float32)
    dense[:, 2] = 0
    return sparse.SparseRowMatrix(scipy.sparse.csr_matrix(dense))


def test_map_features_matches_jax():
    values = _values()
    ids = [f"g{j}" for j in range(9)]
    mapping = {"A": ["g0", "g5"], "B": ["g3"], "C": ["g8", "g1", "g2"]}
    _same(processing.map_features(values, ids, mapping)[1],
          jprocessing.map_features(values, ids, mapping)[1])
    _same(processing.map_features(values, ids, mapping)[0],
          jprocessing.map_features(values, ids, mapping)[0])


@pytest.mark.parametrize("method, parameters, rows", [
    ("remove_zeros", None, 40),
    ("keep_variances_above", None, 40),
    ("keep_variances_above", [2.0], 40),
    ("keep_highest_variances", [3], 40),
    ("keep_highest_variances", None, 12),  # keeps half the rows' number
])
def test_select_features_matches_jax(method, parameters, rows):
    values = {"original": _values(shape=(rows, 9)), "preprocessed": None}
    names = np.array([f"g{j}" for j in range(9)])
    got = processing.select_features(values, names, method, parameters)
    want = jprocessing.select_features(values, names, method, parameters)
    _same(got[0], want[0])
    _same(got[1], want[1])


FILTER_LABELS = np.array(["Rod", "Cone", "No class", "Cone", "Bipolar"] * 8)


@pytest.mark.parametrize("method, parameters, superset", [
    ("macosko", None, False),
    ("inverse_macosko", None, False),
    ("excluded_classes", None, False),
    ("excluded_classes", None, True),
    ("keep", ["cone", "bipolar"], False),
    ("remove", ["Rod"], False),
    ("remove_count_sum_above", [30], False),
    ("random", [25], False),
])
def test_filter_examples_matches_jax(method, parameters, superset):
    rng = np.random.RandomState(18)
    wide = rng.poisson(3.0, (40, 1200)).astype(np.float32)
    wide[::3, :800] = 0  # a third of the cells under Macosko's 900 genes
    values = {"original": sparse.SparseRowMatrix(
        scipy.sparse.csr_matrix(wide))}
    names = np.array([f"c{i}" for i in range(40)])
    kwargs = dict(
        labels=FILTER_LABELS, excluded_classes=["No class"],
        batch_indices=np.arange(40) % 4,
        count_sum=np.asarray(values["original"].sum(axis=1)).reshape(-1))
    if superset:
        kwargs.update(
            superset_labels=np.where(FILTER_LABELS == "Bipolar", "Other",
                                     FILTER_LABELS),
            excluded_superset_classes=["Other"])
    got = processing.filter_examples(values, names, method, parameters,
                                     **kwargs)
    want = jprocessing.filter_examples(values, names, method, parameters,
                                       **kwargs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)


def _dense_and_csr():
    dense = np.random.RandomState(19).rand(30, 8).astype(np.float32) * 3
    dense[dense < 1.2] = 0
    dense[:, 4] = 0
    return {"dense": dense, "csr": scipy.sparse.csr_matrix(dense)}


def _array(values):
    return values.toarray() if scipy.sparse.issparse(values) else values


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_normalise_and_binarise_match_sklearn(form):
    values = _dense_and_csr()[form]
    for got, want in (
        (processing._normalise(values),
         sklearn.preprocessing.normalize(values, norm="l2", axis=0)),
        (processing._binarise(values),
         sklearn.preprocessing.binarize(values, threshold=0.5)),
        (processing._normalise(values.astype(np.float64)),
         jprocessing._normalise(values.astype(np.float64))),
        (processing._binarise(values), jprocessing._binarise(values)),
    ):
        assert type(got).__name__ == type(want).__name__
        assert got.dtype == want.dtype
        np.testing.assert_allclose(_array(got), _array(want), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("methods", [["log"], ["exp"], ["normalise"],
                                     ["binarise"], ["log", "normalise"],
                                     ["normalise", "binarise"], []])
@pytest.mark.parametrize("form", ["dense", "csr"])
def test_preprocessors_match_jax(methods, form):
    values = _dense_and_csr()[form]
    got = processing.build_preprocessor(methods)(values.copy())
    want = jprocessing.build_preprocessor(methods)(values.copy())
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(_array(got), _array(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_noisy_binarise_matches_jax(form):
    values = _dense_and_csr()[form] / 3
    np.random.seed(20)
    got = processing.build_preprocessor(["binarise"], noisy=True)(values)
    np.random.seed(20)
    want = jprocessing.build_preprocessor(["binarise"], noisy=True)(values)
    np.testing.assert_array_equal(_array(got), _array(want))
    with pytest.raises(ValueError, match="not found"):
        processing.build_preprocessor(["no such method"])


def _split_dictionary(n=100):
    rng = np.random.RandomState(21)
    values = rng.poisson(2, (n, 1000)).astype(np.float32)
    values[: n // 2, :300] = 0
    return {
        "values": sparse.SparseRowMatrix(scipy.sparse.csr_matrix(values)),
        "preprocessed values": sparse.SparseRowMatrix(
            scipy.sparse.csr_matrix(np.log1p(values))),
        "labels": rng.randint(0, 3, n).astype(str),
        "example names": np.array([f"c{i}" for i in range(n)]),
        "feature names": np.array([f"g{j}" for j in range(1000)]),
        "batch indices": rng.randint(0, 2, (n, 1)),
        "class names": ["0", "1", "2"],
    }


@pytest.mark.parametrize("method, indices", [
    ("random", None), ("sequential", None), ("macosko", None),
    ("default", None),
    ("indices", {"training": slice(0, 70), "validation": slice(70, 85),
                 "test": slice(85, 100)}),
    ("default", {"training": slice(0, 80), "test": slice(80, 100)}),
])
def test_split_matches_jax(method, indices):
    data = _split_dictionary()
    if indices is not None:
        data["split indices"] = indices
    got = processing.split_data_set(data, method=method, fraction=0.8)
    want = jprocessing.split_data_set(data, method=method, fraction=0.8)
    _same(got, want)
    assert (processing.SPLITTING_SEED, processing.RANDOM_FILTER_SEED) == (
        42, 90)


def test_sparse_matrix_matches_jax():
    values = _values().toarray()
    got = sparse.SparseRowMatrix(scipy.sparse.csr_matrix(values))
    want = jsparse.SparseRowMatrix(scipy.sparse.csr_matrix(values))
    for statistic in ("mean", "var", "std"):
        assert getattr(got, statistic)() == getattr(want, statistic)()
        np.testing.assert_array_equal(getattr(got, statistic)(axis=0),
                                      getattr(want, statistic)(axis=0))
    assert got.var(ddof=1) == want.var(ddof=1)
    assert got.size_in_memory == want.size_in_memory
    assert sparse.sparsity(got) == jsparse.sparsity(want)
    assert sparse.sparsity(values) == jsparse.sparsity(values)


# -- DataSet ----------------------------------------------------------------


def _spec(tmp_path, labels=True):
    """A small labelled matrix as a JSON spec."""
    rng = np.random.RandomState(22)
    n, f = 60, 10
    dense = rng.poisson(rng.rand(1, f) * 5, (n, f))
    dense[:, 3] = 0
    barcodes = [f"cell{i}" for i in range(n)]
    _write_table(tmp_path / "cells.tsv", ["cell"] + [f"g{j}" for j in
                                                     range(f)],
                 barcodes, dense)
    classes = ["Rod", "Cone", "No class", "Bipolar cell", "Bipolar 2"]
    _write_table(tmp_path / "cells-labels.tsv", ["cell", "type"], barcodes,
                 [[classes[i % 5]] for i in range(n)])
    spec = {"values": "cells.tsv", "format": "matrix_ebf",
            "label superset": "infer", "excluded classes": ["No class"],
            "excluded superset classes": ["No class"]}
    if labels:
        spec["labels"] = "cells-labels.tsv"
    path = str(tmp_path / "cells.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


_DATA_SET_ATTRIBUTES = (
    "name", "title", "kind", "version", "values", "preprocessed_values",
    "binarised_values", "labels", "example_names", "feature_names",
    "batch_indices", "count_sum", "normalised_count_sum", "class_names",
    "number_of_classes", "excluded_classes", "superset_labels",
    "superset_class_names", "excluded_superset_classes",
    "class_id_to_class_name", "superset_class_name_to_superset_class_id",
    "number_of_examples", "number_of_features", "split_indices",
    "feature_mapping", "default_splitting_method",
)


def _same_data_set(got, want):
    for name in _DATA_SET_ATTRIBUTES:
        w = getattr(want, name)
        g = getattr(got, name)
        if isinstance(w, np.ndarray) or scipy.sparse.issparse(w):
            if w.dtype.kind == "f" and w is not want.values:
                np.testing.assert_allclose(_array(g), _array(w), rtol=1e-6,
                                           err_msg=name)
                continue
        _same(g, w, name)


@pytest.mark.parametrize("options", [
    {},
    {"preprocessing_methods": ["log"]},
    {"preprocessing_methods": ["normalise", "binarise"]},
    {"feature_selection": ["remove_zeros"],
     "example_filter": ["excluded_classes"]},
    {"feature_selection": ["keep_highest_variances", 4],
     "example_filter": ["keep", "rod", "cone"]},
    {"example_filter": ["random", 20], "binarise_values": True},
    {"map_features": True, "example_filter": ["remove_count_sum_above",
                                              20]},
])
def test_data_set_path_matches_jax(options, tmp_path):
    """Parse → load → cache → preprocess → split, each package with its
    own cache; then each reads the other's cache."""
    spec = _spec(tmp_path)
    built = {}
    for name, module in (("port", dataset), ("jax", jdataset)):
        data_set = module.DataSet(spec, directory=str(tmp_path / name),
                                  **options)
        data_set.load()
        built[name] = (data_set, data_set.split(method="random",
                                                fraction=0.8))
    _same_data_set(built["port"][0], built["jax"][0])
    for got, want in zip(built["port"][1], built["jax"][1]):
        _same_data_set(got, want)
    pytest.importorskip("h5py")
    for writer in ("port", "jax"):
        cached = [module.DataSet(spec, directory=str(tmp_path / writer),
                                 **options).load()
                  for module in (dataset, jdataset)]
        _same_data_set(*cached)


def test_data_set_in_memory_and_predictions():
    rng = np.random.RandomState(23)
    values = rng.poisson(2.0, (30, 5)).astype(np.float32)
    labels = np.array(["1", "2", "0", "3", "2"] * 6)
    specification = jparsing.DATA_SET_CATALOGUE["development"]
    sets = [module.DataSet("development", specifications=specification,
                           values=values, labels=labels,
                           batch_indices=np.arange(30) % 2)
            for module in (dataset, jdataset)]
    for data_set in sets:
        data_set.update_predictions(
            predicted_cluster_ids=np.arange(30) % 4,
            predicted_labels=labels[::-1],
            predicted_superset_labels=np.array(["Rods", "Cones"] * 15))
    got, want = sets
    _same_data_set(got, want)
    assert got.class_probabilities == want.class_probabilities
    for name in ("predicted_cluster_ids", "predicted_labels",
                 "predicted_class_names", "predicted_superset_labels",
                 "predicted_superset_class_names",
                 "number_of_predicted_classes", "number_of_batches"):
        _same(getattr(got, name), getattr(want, name), name)
    assert got.has_predictions and got.has_superset_labels
    got.reset_predictions()
    assert not got.has_predictions and got.predicted_labels is None
    for data_set in sets:
        data_set.binarise()
    _same(got.binarised_values, want.binarised_values)
    got.clear()
    assert not got.has_values and got.count_sum is None
    in_memory = [module.DataSet("in-memory", values=values,
                                labels=np.arange(30.0) % 3)
                 for module in (dataset, jdataset)]
    _same_data_set(*in_memory)
    assert in_memory[0].name == "in_memory"
    assert in_memory[0].labels.dtype.kind == "i"  # integral floats
    with pytest.raises(ValueError, match="example names"):
        dataset.DataSet("in-memory", values=values,
                        example_names=np.arange(3))


@pytest.mark.parametrize("superset", ["explicit", "infer"])
def test_superset_labels_match_jax(superset):
    labels = np.array(["1", "2", "0", "3", "CD4 T cells", "B cells"])
    label_superset = ({"Rods": ["1"], "Cones": ["2", "3"],
                       "No class": ["0"], "T": ["CD4 T cells"],
                       "B": ["B cells"]}
                      if superset == "explicit" else "infer")
    if superset == "infer":
        labels = labels[4:]
    _same(dataset._map_labels_to_superset_labels(labels, label_superset),
          jdataset._map_labels_to_superset_labels(labels, label_superset))
    assert dataset._map_labels_to_superset_labels(labels, None) is None


@pytest.mark.parametrize("case", ["unlabelled", "labelled", "superset",
                                  "many classes"])
def test_evaluation_subset_matches_jax(case):
    n = 90
    specification = {}
    labels = None
    if case != "unlabelled":
        labels = np.array([str(i % 7) for i in range(n)])
    if case == "superset":
        specification = {"label superset": {"A": ["0", "1", "2"],
                                            "B": ["3", "4", "5", "6"]}}
    if case == "many classes":
        labels = np.array([f"type {i % 30}" for i in range(n)])
    values = np.ones((n, 3), np.float32)
    got = utilities.indices_for_evaluation_subset(dataset.DataSet(
        "s", specifications=specification, values=values, labels=labels))
    want = jutilities.indices_for_evaluation_subset(jdataset.DataSet(
        "s", specifications=specification, values=values, labels=labels))
    _same(got, want)
    assert len(got) <= 25 and utilities.EVALUATION_SUBSET_SEED == 80


def test_directory_and_saved_values_match_jax(tmp_path):
    options = dict(feature_selection=["keep_variances_above", 0.5],
                   example_filter=["random", 10],
                   preprocessing_methods=["log"], map_features=True)
    port_set = dataset.DataSet("development", **options)
    jax_set = jdataset.DataSet("development", **options)
    for method, fraction in (("default", 0.9), ("indices", 0.9),
                             (None, None)):
        for preprocessing in (True, False):
            assert utilities.build_directory_path(
                "base", port_set, method, fraction, preprocessing) == (
                jutilities.build_directory_path(
                    "base", jax_set, method, fraction, preprocessing))
    values = scipy.sparse.csr_matrix(_values().toarray()[:5])
    for rows, columns in ((None, None), (list("abcde"), None),
                          (list("abcde"), [f"g{j}" for j in range(9)])):
        for module, directory in ((utilities, "port"), (jutilities, "jax")):
            module.save_values(values, "Some values", rows, columns,
                               str(tmp_path / directory))
        read = [gzip.open(tmp_path / d / "some_values.tsv.gz").read()
                for d in ("port", "jax")]
        assert read[0] == read[1]


def test_model_arrays_stage_preprocessed_values_as_float32():
    values = _values()
    data_set = dataset.DataSet("in-memory", values=values)
    arrays = pipeline.build_model_arrays(data_set)
    assert arrays["x"] is values and arrays["t"] is values
    data_set.update(preprocessed_values=processing.build_preprocessor(
        ["log"])(values.copy()))
    arrays = pipeline.build_model_arrays(data_set,
                                         use_count_sum_as_parameter=True)
    assert arrays["x"] is data_set.preprocessed_values is arrays["t"]
    assert pipeline.narrowest_count_dtype(arrays["x"]) is None
    staged = pipeline.device_resident_data(arrays, device="cpu")
    assert staged["x"].dtype == torch.float32 and staged["x"] is staged["t"]
    np.testing.assert_array_equal(staged["x"].numpy(),
                                  data_set.preprocessed_values.toarray())
    np.testing.assert_array_equal(staged["count_sum"].numpy(),
                                  data_set.count_sum.astype(np.float32))


# -- clusters to labels -----------------------------------------------------


@pytest.mark.parametrize("label_ids, cluster_ids, excluded, expected", [
    # majority per cluster
    ([0, 0, 1, 2, 2, 2], [0, 0, 0, 1, 1, 1], (), [0, 0, 0, 2, 2, 2]),
    # a tie goes to the smallest label id
    ([3, 1, 1, 3, 2], [5, 5, 5, 5, 7], (), [1, 1, 1, 1, 2]),
    # excluded classes do not vote; a cluster left with none keeps 0
    ([4, 4, 1, 4, 4], [0, 0, 0, 1, 1], (4,), [1, 1, 1, 0, 0]),
    ([2, 2, 0, 0, 0, 1], [1, 1, 1, 1, 2, 2], (0,), [2, 2, 2, 2, 1, 1]),
])
def test_map_cluster_ids_to_label_ids(label_ids, cluster_ids, excluded,
                                      expected):
    label_ids, cluster_ids = np.array(label_ids), np.array(cluster_ids)
    got = map_cluster_ids_to_label_ids(label_ids, cluster_ids, excluded)
    want = jax_map_cluster_ids_to_label_ids(label_ids, cluster_ids, excluded)
    _same(got, want)
    np.testing.assert_array_equal(got, expected)


def test_map_cluster_ids_to_label_ids_random():
    rng = np.random.RandomState(24)
    for _ in range(100):
        n = rng.randint(1, 50)
        label_ids, cluster_ids = rng.randint(0, 5, n), rng.randint(0, 4, n)
        excluded = tuple(rng.choice(5, rng.randint(0, 3), replace=False))
        _same(map_cluster_ids_to_label_ids(label_ids, cluster_ids, excluded),
              jax_map_cluster_ids_to_label_ids(label_ids, cluster_ids,
                                               excluded))


def test_labelled_gmvae_evaluate_matches_jax(tmp_path, monkeypatch):
    """A labelled GMVAE trained by the JAX package, evaluated by both from
    its checkpoint: the same cluster ids, predicted labels and predicted
    superset labels (q(y|x) draws nothing)."""
    monkeypatch.chdir(tmp_path)
    raw = jloaders.create_development_data_set(n_examples=300)
    specification = jparsing.DATA_SET_CATALOGUE["development"]
    sets = [module.DataSet("development", specifications=specification,
                           values=raw["values"], labels=raw["labels"],
                           example_names=raw["example names"],
                           feature_names=raw["feature names"])
            for module in (jdataset, dataset)]
    kwargs = dict(feature_size=25, latent_size=2, hidden_sizes=[16],
                  reconstruction_distribution="negative binomial",
                  number_of_latent_clusters=3,
                  log_directory=str(tmp_path / "models"))
    jax_model = JaxGMVAE(**kwargs)
    jax_model.train(sets[0], number_of_epochs=1, minibatch_size=50,
                    verbose=False)
    want = jax_model.evaluate(sets[0], output_versions="transformed",
                              verbose=False)
    got = GaussianMixtureVariationalAutoencoder(**kwargs).evaluate(
        sets[1], device="cpu", verbose=False)
    for output in (got[0], got[1], got[2]["z"], got[2]["y"]):
        for name in ("predicted_cluster_ids", "predicted_labels",
                     "predicted_superset_labels", "predicted_class_names",
                     "predicted_superset_class_names"):
            _same(getattr(output, name), getattr(want, name), name)
    reconstructed = got[1]
    for name in ("labels", "example_names", "feature_names", "title",
                 "specifications", "kind", "directory", "batch_indices"):
        _same(getattr(reconstructed, name), getattr(sets[1], name), name)
    assert got[2]["z"].specifications == {} and got[2]["z"].version == "z"
    np.testing.assert_array_equal(got[2]["z"].labels, sets[1].labels)


# -- what the package imports -------------------------------------------------


def test_training_imports_no_pandas_h5py_or_sklearn(tmp_path):
    """Importing the package, building and splitting the development set
    and training a labelled GMVAE one step need none of them.  The cache
    does: ``DataSet.load`` raises ``ImportError`` there, so the set is
    built in memory."""
    code = """
import sys
for name in ("pandas", "h5py", "sklearn", "jax", "scvae_tpu"):
    sys.modules[name] = None
import numpy as np
import scvae_tpu_torch
from scvae_tpu_torch.data import DataSet, create_development_data_set
from scvae_tpu_torch.data import processing
from scvae_tpu_torch.data.parsing import DATA_SET_CATALOGUE

try:
    DataSet("development", directory="data").load()
except ImportError as error:
    assert "h5py" in str(error), error
else:
    raise AssertionError("the cache was written without h5py")

raw = create_development_data_set(n_examples=500)
values, names, labels, _ = processing.filter_examples(
    {"original": raw["values"]}, raw["example names"], "random", [300],
    labels=raw["labels"])
data_set = DataSet("development",
                   specifications=DATA_SET_CATALOGUE["development"],
                   values=processing.build_preprocessor(["log"])(
                       values["original"]),
                   labels=labels, example_names=names,
                   feature_names=raw["feature names"])
training, validation, test = data_set.split(method="random", fraction=0.9)
model = scvae_tpu_torch.GaussianMixtureVariationalAutoencoder(
    feature_size=25, latent_size=2, hidden_sizes=[8],
    reconstruction_distribution="negative binomial",
    number_of_latent_clusters=2, log_directory="models")
result = model.train(training, validation, number_of_epochs=1,
                     minibatch_size=243, device="cpu", verbose=False)
assert result.train_state.step == 1
assert 0 <= result.history["validation"]["accuracy"][0] <= 1
blocked = [name for name in ("pandas", "h5py", "sklearn", "jax",
                             "scvae_tpu")
           if sys.modules.get(name) is not None]
assert not blocked, blocked
"""
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
