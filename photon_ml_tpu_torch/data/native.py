"""The native LIBSVM parser, bound by ctypes.

The port's own loader of ``native/fast_parse.cpp`` (the counterpart of
``photon_ml_tpu/data/native.py``, LIBSVM part): the source is compiled
alone with ``g++`` into ``build/native/libphoton_parse.so`` beside the
checkout, rebuilt when the source is newer, and loaded once. It never
writes into ``native/``. ``PHOTON_NO_NATIVE=1`` hides the library, as in
the reference, so the pure-Python parser runs; it is read on every call.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

logger = logging.getLogger("photon_ml_tpu_torch.native")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "fast_parse.cpp")
_LIB_PATH = os.path.join(_REPO, "build", "native", "libphoton_parse.so")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native parser build failed (%s)", e)
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def load_native() -> Optional[ctypes.CDLL]:
    """The parser library, built on first use; None when it cannot be built
    or loaded, or when ``PHOTON_NO_NATIVE`` is set."""
    global _lib, _load_attempted
    if os.environ.get("PHOTON_NO_NATIVE"):
        return None
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_SOURCE):
        return None
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_SOURCE) > os.path.getmtime(_LIB_PATH))
    if stale and not _build() and not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        logger.info("native parser load failed (%s)", e)
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.libsvm_count.restype = ctypes.c_int
    lib.libsvm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p]
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.libsvm_parse.restype = ctypes.c_int64
    lib.libsvm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, f64, i64, i64,
                                 f64, i64p, i64p]
    _lib = lib
    return _lib


def parse_libsvm_native(
    data: bytes, zero_based: bool = False
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """(values, rows, cols, labels, num_features), or None when the library
    is unavailable. Raises ValueError on malformed input, as the Python
    parser does."""
    lib = load_native()
    if lib is None:
        return None
    n_rows, n_nnz = ctypes.c_int64(), ctypes.c_int64()
    lib.libsvm_count(data, len(data), ctypes.byref(n_rows), ctypes.byref(n_nnz))
    values = np.empty(n_nnz.value, np.float64)
    rows = np.empty(n_nnz.value, np.int64)
    cols = np.empty(n_nnz.value, np.int64)
    labels = np.empty(n_rows.value, np.float64)
    parsed_rows, parsed_slots = ctypes.c_int64(), ctypes.c_int64()
    max_col = lib.libsvm_parse(data, len(data), 0 if zero_based else 1, values, rows, cols,
                               labels, ctypes.byref(parsed_rows), ctypes.byref(parsed_slots))
    if max_col == -3:
        raise ValueError("negative feature index (wrong zero_based setting?)")
    if max_col == -2:
        raise ValueError("malformed libsvm token")
    # -1 is a valid labels-only file (num_features 0); the two passes must
    # agree, or the arrays hold uninitialized tails
    if parsed_rows.value != n_rows.value or parsed_slots.value != n_nnz.value:
        raise ValueError(
            "malformed libsvm input: count/parse passes disagree "
            f"(rows {parsed_rows.value} vs {n_rows.value}, "
            f"nnz {parsed_slots.value} vs {n_nnz.value})")
    return values, rows, cols, labels, int(max_col) + 1
