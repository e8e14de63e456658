"""Build and load the port's CUDA kernels.

The kernels live in ``ops/csrc/*.cu`` and export a plain C interface, so the
sources include no PyTorch header.  They are compiled on first use with
``torch.utils.cpp_extension.load`` (ninja runs one ``nvcc`` per source, in
parallel) for ``sm_90a`` into ``build/kernels`` at the repository root, and
loaded with ``ctypes``.  Nothing here runs at import time: importing the
port needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")
SOURCES = ("gather.cu", "count_likelihood_tc.cu", "tc_product.cu",
           "cp_likelihood_tc.cu", "categorised_likelihood_tc.cu",
           "grouped_likelihood_tc.cu")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")
_NAME = "scvae_tpu_torch_kernels"

_lock = threading.Lock()
_library: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # src, src_dtype, idx, n_idx, n_rows, n_cols, out, out_dtype, path, grid,
    # stream
    "scvae_gather_rows": [_P, _I, _P, _I, ctypes.c_longlong, _I, _P, _I, _I,
                          _I, _P],
    # family, h, w, b, t, t_dtype, part, out, m, m_t, hp, f, subtract, stream
    "scvae_tc_forward": [_I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    # family, g, h, w, b, t, t_dtype, da, db_part, m, m_t, hp, f, stream
    "scvae_tc_gradient": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                          _P],
    # family, h, w0, w1, w2, b, t, t_dtype, hh, wp, part, out, m, m_t,
    # hidden, f, subtract, stream
    "scvae_tc_f32_forward": [_I] + [_P] * 6 + [_I] + [_P] * 4 + [_I] * 5
                            + [_P],
    # family, g, h, w0, w1, w2, b, t, t_dtype, hh, wp, da, db_part, m, m_t,
    # hidden, f, stream
    "scvae_tc_f32_gradient": [_I] + [_P] * 7 + [_I] + [_P] * 4 + [_I] * 4
                             + [_P],
    # family, h, w, b, t, t_dtype, part, out, lse, m, m_t, hp, f, n_classes,
    # stream
    "scvae_cat_tc_forward": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                             _I, _I, _P],
    # family, g, h, w, b, t, t_dtype, lse, da, db_part, m, m_t, hp, f,
    # n_classes, stream
    "scvae_cat_tc_gradient": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P],
    # family, h, w0, w1, w2, cat_w, b, t, t_dtype, hh, wp, part, out, lse, m,
    # m_t, hidden, f, n_classes, stream
    "scvae_cat_tc_f32_forward": [_I] + [_P] * 7 + [_I] + [_P] * 5 + [_I] * 5
                                + [_P],
    # family, g, h, w0, w1, w2, cat_w, b, t, t_dtype, lse, hh, wp, da,
    # db_part, m, m_t, hidden, f, n_classes, stream
    "scvae_cat_tc_f32_gradient": [_I] + [_P] * 8 + [_I] + [_P] * 5 + [_I] * 5
                                 + [_P],
    # da, w, dh, m, hidden, hp, k, splits, tiles_per_split, promote, stream
    "scvae_tc_dh": [_P, _P, _P] + [_I] * 7 + [_P],
    # h, da, db_part, dw, db, n_heads, m, hidden, hp, f, splits,
    # tiles_per_split, row_tiles, promote, stream
    "scvae_tc_dw": [_P] * 5 + [_I] * 9 + [_P],
    # h, w, b, t, t_dtype, n, part, ll, lse, m, m_t, hp, f, stream
    "scvae_cp_tc_forward": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P],
    # g, h, w, b, t, t_dtype, lse, sx, da, db_part, m, m_t, hp, f, stream
    "scvae_cp_tc_gradient": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P],
    # h, w, b, t, t_dtype, n, hh, wp, part, ll, lse, m, m_t, hidden, f,
    # stream
    "scvae_cp_tc_f32_forward": [_P] * 4 + [_I] + [_P] * 6 + [_I] * 4 + [_P],
    # g, h, w, b, t, t_dtype, lse, sx, hh, wp, da, db_part, m, m_t, hidden,
    # f, stream
    "scvae_cp_tc_f32_gradient": [_P] * 5 + [_I] + [_P] * 6 + [_I] * 4
                                + [_P],
    # family, h, w, b, t, t_dtype, part, out, n_groups, m, hp, f, w_rows,
    # slots, stream
    "scvae_grouped_tc_forward": [_I, _P, _P, _P, _P, _I, _P, _P] + [_I] * 6
                                + [_P],
    # family, g, h, w, b, t, t_dtype, da, db_part, n_groups, m, hp, f,
    # w_rows, slots, stream
    "scvae_grouped_tc_gradient": [_I, _P, _P, _P, _P, _P, _I, _P, _P]
                                 + [_I] * 6 + [_P],
    # family, h, w0, w1, w2, b, t, t_dtype, hh, wp, part, out, n_groups, m,
    # hidden, f, w_rows, slots, stream
    "scvae_grouped_tc_f32_forward": [_I] + [_P] * 6 + [_I] + [_P] * 4
                                    + [_I] * 6 + [_P],
    # family, g, h, w0, w1, w2, b, t, t_dtype, hh, wp, da, db_part, n_groups,
    # m, hidden, f, w_rows, slots, stream
    "scvae_grouped_tc_f32_gradient": [_I] + [_P] * 7 + [_I] + [_P] * 4
                                     + [_I] * 6 + [_P],
}


def load_kernels() -> ctypes.CDLL:
    """Compile (once per process) and load the kernel library."""
    global _library
    with _lock:
        if _library is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            load(
                name=_NAME,
                sources=[os.path.join(CSRC_DIR, s) for s in SOURCES],
                extra_cuda_cflags=list(CUDA_FLAGS),
                build_directory=BUILD_DIR,
                is_python_module=False,
            )
            library = ctypes.CDLL(os.path.join(BUILD_DIR, _NAME + ".so"))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(library, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            library.scvae_error_string.argtypes = [ctypes.c_int]
            library.scvae_error_string.restype = ctypes.c_char_p
            _library = library
        return _library


def call(name: str, device: torch.device, *args) -> None:
    """Launch one exported kernel entry on ``device`` (the device of its
    tensors) and that device's current stream; raise if CUDA refused the
    launch."""
    library = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(library, name)(*args, stream)
    if code:
        message = library.scvae_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({message})")
