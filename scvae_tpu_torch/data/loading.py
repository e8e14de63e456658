"""Acquisition: download or copy the raw files a data-set spec points at,
then dispatch to the right format loader.

The port's copy of ``scvae_tpu/data/loading.py`` (the counterpart of
``scvae/data/loading.py:31-133``).  Downloads stream through ``requests``
into ``<path>.part``, renamed to the path the JAX package uses once
complete; local paths are used in place.  After loading, dense value
matrices are converted to CSR (``loading.py:119-127``).
"""

from __future__ import annotations

import os
import shutil
import urllib.parse
from typing import Any

import numpy as np
import scipy.sparse

from scvae_tpu_torch.data.loaders import LOADERS
from scvae_tpu_torch.data.sparse import SparseRowMatrix


def _download(url: str, path: str) -> None:
    import requests

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with requests.get(url, stream=True, timeout=60) as response:
        response.raise_for_status()
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            for chunk in response.iter_content(chunk_size=1 << 20):
                f.write(chunk)
        os.replace(tmp, path)


def acquire_data_set(
    title: str, urls: dict[str, Any], directory: str
) -> dict[str, Any]:
    """Fetch (or locate) every URL in the spec; returns the same nested
    structure with local paths (reference ``loading.py:31-94``)."""
    paths: dict[str, Any] = {}
    if not urls:
        return paths
    for values_or_labels, kinds in urls.items():
        paths[values_or_labels] = {}
        for kind, url in (kinds or {}).items():
            if url is None:
                continue
            if os.path.exists(url):  # already a local path
                paths[values_or_labels][kind] = url
                continue
            parsed = urllib.parse.urlparse(str(url))
            filename = "-".join(
                [
                    part
                    for part in (
                        title,
                        values_or_labels,
                        kind,
                        os.path.basename(parsed.path),
                    )
                    if part
                ]
            ).replace("/", "_")
            path = os.path.join(directory, title, filename)
            if not os.path.exists(path):
                if parsed.scheme in ("http", "https", "ftp"):
                    print(f"Downloading {url} → {path}")
                    _download(str(url), path)
                else:
                    raise FileNotFoundError(
                        f"Cannot acquire {url!r} (not a URL or local file)"
                    )
            paths[values_or_labels][kind] = path
    return paths


def load_original_data_set(
    paths: dict[str, Any], data_format: str
) -> dict[str, Any]:
    """Dispatch to the loader registry and sparsify values
    (reference ``loading.py:97-133``)."""
    data_format = data_format.lower()
    loader = LOADERS.get(data_format)
    if loader is None:
        raise ValueError(f"Data format `{data_format}` not recognised.")
    data_dictionary = loader(paths)

    values = data_dictionary["values"]
    if values is not None and not scipy.sparse.issparse(values):
        values = SparseRowMatrix(
            scipy.sparse.csr_matrix(np.asarray(values, np.float32))
        )
        data_dictionary["values"] = values
    elif values is not None and not isinstance(values, SparseRowMatrix):
        data_dictionary["values"] = SparseRowMatrix(values)
    return data_dictionary


def copy_or_link(source: str, destination: str) -> None:
    os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
    shutil.copyfile(source, destination)
