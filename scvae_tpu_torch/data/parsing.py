"""Input parsing: resolve a dataset name, file path, or JSON spec into a
data-set specification dictionary.

The port's copy of ``scvae_tpu/data/parsing.py``, the counterpart of
``scvae/data/parsing.py`` and the named-dataset catalog
``scvae/data/data_sets.json``.  The catalog lists the same public data
sets (names, acquisition URLs, formats, label supersets) the reference
ships; entries are Python dictionaries rather than a JSON resource.  The
port downloads nothing: a catalogue entry's files must already be in the
data directory (``loading.acquire_data_set``).
"""

from __future__ import annotations

import json
import os
from typing import Any

from scvae_tpu_torch.utils.strings import normalise_string

_CELL_TERMS = {
    "example": "cell",
    "feature": "gene",
    "class": "cell type",
    "type": "count",
    "item": "transcript",
}
_SAMPLE_TERMS = {
    "example": "sample",
    "feature": "gene",
    "class": "primary site",
    "type": "count",
    "item": "transcript",
}
_IMAGE_TERMS = {
    "example": "image",
    "feature": "pixel",
    "class": "digit",
    "type": "value",
    "item": "intensity",
}

_10X = "http://cf.10xgenomics.com/samples/cell-exp"

DATA_SET_CATALOGUE: dict[str, dict[str, Any]] = {
    "Macosko-MRC": {
        "terms": _CELL_TERMS,
        "format": "macosko",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": "ftp://ftp.ncbi.nlm.nih.gov/geo/series/GSE63nnn/"
                "GSE63472/suppl/GSE63472_P14Retina_merged_digital_"
                "expression.txt.gz"
            },
            "labels": {
                "full": "http://mccarrolllab.com/wp-content/uploads/2015/05/"
                "retina_clusteridentities.txt"
            },
        },
        "label superset": {
            "Horizontal": [1],
            "Retinal ganglion": [2],
            "Amacrine": list(range(3, 24)),
            "Rods": [24],
            "Cones": [25],
            "Bipolar": list(range(26, 34)),
            "Müller glia": [34],
            "Others": [35, 36, 37, 38, 39],
            "No class": [0],
        },
        "sorted superset class names": [
            "Horizontal", "Retinal ganglion", "Amacrine", "Rods", "Cones",
            "Bipolar", "Müller glia",
        ],
        "excluded classes": [0],
        "excluded superset classes": ["No class"],
        "splitting method": "macosko",
    },
    "10x-MBC-20k": {
        "terms": _CELL_TERMS,
        "format": "10x",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": f"{_10X}/1.3.0/1M_neurons/1M_neurons_neuron20k.h5"
            },
        },
    },
    "10x-MBC": {
        "terms": _CELL_TERMS,
        "format": "10x",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": f"{_10X}/1.3.0/1M_neurons/"
                "1M_neurons_filtered_gene_bc_matrices_h5.h5"
            },
        },
    },
    "10x-PBMC-PL": {
        "terms": _CELL_TERMS,
        "format": "10x_combine",
        "example type": "counts",
        "URLs": {
            "all": {
                "CD56+ natural killer cells":
                    f"{_10X}/1.1.0/cd56_nk/cd56_nk_filtered_gene_bc_matrices.tar.gz",
                "CD19+ B cells":
                    f"{_10X}/1.1.0/b_cells/b_cells_filtered_gene_bc_matrices.tar.gz",
                "CD4+/CD25+ regulatory T cells":
                    f"{_10X}/1.1.0/regulatory_t/regulatory_t_filtered_gene_bc_matrices.tar.gz",
            }
        },
    },
    "10x-PBMC-PT": {
        "terms": _CELL_TERMS,
        "format": "10x_combine",
        "example type": "counts",
        "URLs": {
            "all": {
                "CD8+/CD45RA+ naïve cytotoxic T cells":
                    f"{_10X}/1.1.0/naive_cytotoxic/naive_cytotoxic_filtered_gene_bc_matrices.tar.gz",
                "CD4+/CD25+ regulatory T cells":
                    f"{_10X}/1.1.0/regulatory_t/regulatory_t_filtered_gene_bc_matrices.tar.gz",
                "CD4+/CD45RA+/CD25- naïve T cells":
                    f"{_10X}/1.1.0/naive_t/naive_t_filtered_gene_bc_matrices.tar.gz",
            }
        },
    },
    "10x-PBMC-PP": {
        "terms": _CELL_TERMS,
        "format": "10x_combine",
        "example type": "counts",
        "URLs": {
            "all": {
                "CD19+ B cells":
                    f"{_10X}/1.1.0/b_cells/b_cells_filtered_gene_bc_matrices.tar.gz",
                "CD34+ cells":
                    f"{_10X}/1.1.0/cd34/cd34_filtered_gene_bc_matrices.tar.gz",
                "CD4+ helper T cells":
                    f"{_10X}/1.1.0/cd4_t_helper/cd4_t_helper_filtered_gene_bc_matrices.tar.gz",
                "CD4+/CD25+ regulatory T cells":
                    f"{_10X}/1.1.0/regulatory_t/regulatory_t_filtered_gene_bc_matrices.tar.gz",
                "CD4+/CD45RA+/CD25- naïve T cells":
                    f"{_10X}/1.1.0/naive_t/naive_t_filtered_gene_bc_matrices.tar.gz",
                "CD56+ natural killer cells":
                    f"{_10X}/1.1.0/cd56_nk/cd56_nk_filtered_gene_bc_matrices.tar.gz",
                "CD8+ cytotoxic T cells":
                    f"{_10X}/1.1.0/cytotoxic_t/cytotoxic_t_filtered_gene_bc_matrices.tar.gz",
                "CD8+/CD45RA+ naïve cytotoxic T cells":
                    f"{_10X}/1.1.0/naive_cytotoxic/naive_cytotoxic_filtered_gene_bc_matrices.tar.gz",
                "CD14+ monocytes":
                    f"{_10X}/1.1.0/cd14_monocytes/cd14_monocytes_filtered_gene_bc_matrices.tar.gz",
            }
        },
    },
    "10x-PBMC-68k": {
        "terms": _CELL_TERMS,
        "format": "10x",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": f"{_10X}/1.1.0/fresh_68k_pbmc_donor_a/"
                "fresh_68k_pbmc_donor_a_filtered_gene_bc_matrices.tar.gz"
            },
            "labels": {
                "full": "https://raw.githubusercontent.com/10XGenomics/"
                "single-cell-3prime-paper/master/pbmc68k_analysis/"
                "68k_pbmc_barcodes_annotation.tsv"
            },
        },
    },
    "TCGA-Kallisto": {
        "terms": _SAMPLE_TERMS,
        "format": "tcga",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": "https://toil.xenahubs.net/download/"
                "tcga_Kallisto_est_counts.gz"
            },
            "labels": {
                "full": "https://tcga.xenahubs.net/download/"
                "TCGA.PANCAN.sampleMap/PANCAN_clinicalMatrix.gz"
            },
            "feature mapping": {
                "full": "https://toil.xenahubs.net/download/"
                "gencode.v23.annotation.transcript.probemap.gz"
            },
        },
    },
    "TCGA-RSEM": {
        "terms": _SAMPLE_TERMS,
        "format": "tcga",
        "example type": "counts",
        "URLs": {
            "values": {
                "full": "https://toil.xenahubs.net/download/"
                "tcga_gene_expected_count.gz"
            },
            "labels": {
                "full": "https://tcga.xenahubs.net/download/"
                "TCGA.PANCAN.sampleMap/PANCAN_clinicalMatrix.gz"
            },
            "feature mapping": {
                "full": "https://toil.xenahubs.net/download/"
                "gencode.v23.annotation.gene.probeMap.gz"
            },
        },
    },
    "MNIST (original)": {
        "terms": _IMAGE_TERMS,
        "format": "mnist_original",
        "example type": "counts",
        "feature dimensions": [28, 28],
        "URLs": {
            "values": {
                "training": "http://yann.lecun.com/exdb/mnist/"
                "train-images-idx3-ubyte.gz",
                "test": "http://yann.lecun.com/exdb/mnist/"
                "t10k-images-idx3-ubyte.gz",
            },
            "labels": {
                "training": "http://yann.lecun.com/exdb/mnist/"
                "train-labels-idx1-ubyte.gz",
                "test": "http://yann.lecun.com/exdb/mnist/"
                "t10k-labels-idx1-ubyte.gz",
            },
        },
    },
    "MNIST (normalised)": {
        "terms": _IMAGE_TERMS,
        "format": "mnist_normalised",
        "example type": "images",
        "feature dimensions": [28, 28],
        "URLs": {
            "all": {"full": "http://deeplearning.net/data/mnist/mnist.pkl.gz"}
        },
    },
    "MNIST (binarised)": {
        "terms": _IMAGE_TERMS,
        "format": "mnist_binarised",
        "example type": "images",
        "feature dimensions": [28, 28],
        "preprocessing methods": ["binarise"],
        "URLs": {
            "all": {
                "full": "http://deeplearning.net/data/mnist/mnist.pkl.gz"
            }
        },
    },
    "development": {
        "terms": _CELL_TERMS,
        "format": "development",
        "example type": "counts",
        "feature dimensions": [5, 5],
        "URLs": {},
        "label superset": {
            "Rods": ["1"],
            "Cones": ["2", "3"],
            "No class": ["0"],
        },
        "sorted superset class names": ["Rods", "Cones"],
        "excluded classes": ["0"],
        "excluded superset classes": ["No class"],
    },
}


def _base_name(path: str) -> str:
    name = os.path.basename(path)
    for ext in (".tar.gz", ".tsv.gz", ".txt.gz", ".csv.gz", ".gz"):
        if name.endswith(ext):
            return name[: -len(ext)]
    return os.path.splitext(name)[0]


def _extension(filename: str) -> str | None:
    parts = filename.split(os.extsep, 1)
    return os.extsep + parts[1] if len(parts) > 1 else None


def find_data_set(name: str) -> tuple[str, dict[str, Any]]:
    """Resolve a (normalised) dataset title against the catalogue
    (reference ``parsing.py:84-105``)."""
    normalised = normalise_string(name)
    for title, spec in DATA_SET_CATALOGUE.items():
        if normalise_string(title) == normalised:
            return title, spec
    raise KeyError(f"Data set `{name}` not found in catalogue.")


def parse_input(input_file_or_name: str) -> tuple[str, dict[str, Any]]:
    """Name vs path vs JSON spec resolution (reference ``parsing.py:29-81``).

    Returns ``(name, specification)`` where specification carries either
    ``URLs`` for acquisition or local ``values``/``labels`` paths.
    """
    if input_file_or_name.endswith(".json"):
        json_path = input_file_or_name
        with open(json_path, "r") as json_file:
            spec = json.load(json_file)
        name = _base_name(json_path)
        if "URLs" not in spec:
            if "values" in spec:
                json_directory = os.path.dirname(json_path)
                spec["values"] = os.path.join(json_directory, spec["values"])
            else:
                raise KeyError("Missing path or URL to values.")
            if "labels" in spec:
                json_directory = os.path.dirname(json_path)
                spec["labels"] = os.path.join(json_directory, spec["labels"])
        return name, spec

    if os.path.isfile(input_file_or_name):
        file_path = input_file_or_name
        filename = os.path.basename(file_path)
        ext = _extension(filename)
        data_format = ext[1:].replace(".gz", "").strip(".") if ext else None
        name = _base_name(file_path)
        spec = {"values": file_path}
        if data_format:
            spec["format"] = data_format
        return name, spec

    title, spec = find_data_set(input_file_or_name)
    return title, dict(spec)
