"""The native LIBSVM parser and Avro codec, bound by ctypes.

The port's own loader of ``native/*.cpp`` (the counterpart of
``photon_ml_tpu/data/native.py``). Two libraries, each built with ``g++``
beside the checkout on first use, rebuilt when a source is newer, and
loaded once; nothing is ever written into ``native/``:

- ``build/native/libphoton_parse.so`` from ``fast_parse.cpp`` alone
  (``load_native``);
- ``build/native/libphoton_avro.so`` from ``avro_decode.cpp`` and
  ``avro_encode.cpp``, linked with ``-pthread -lz`` (``load_avro_native``),
  a library of its own, so a host without zlib loses the Avro codec but
  keeps the LIBSVM parser.

``PHOTON_NO_NATIVE=1`` hides both, as in the reference, so the pure-Python
parser and decoder run; it is read on every call.
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
_NATIVE_DIR = os.path.join(_REPO, "native")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_SOURCE = os.path.join(_NATIVE_DIR, "fast_parse.cpp")
_LIB_PATH = os.path.join(_BUILD_DIR, "libphoton_parse.so")
_AVRO_SOURCES = tuple(os.path.join(_NATIVE_DIR, s) for s in ("avro_decode.cpp", "avro_encode.cpp"))
_AVRO_LIB_PATH = os.path.join(_BUILD_DIR, "libphoton_avro.so")
# library path -> the loaded library, or None once a build or load failed
_libs: dict[str, Optional[ctypes.CDLL]] = {}


def _build(lib_path: str, sources, libs=()) -> bool:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread", "-o", tmp, *sources,
           *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native build of %s failed (%s) %s", os.path.basename(lib_path), e,
                       detail.decode(errors="replace")[-2000:])
        return False
    os.replace(tmp, lib_path)
    return True


def _load(lib_path: str, sources, libs=()) -> Optional[ctypes.CDLL]:
    """Build (when missing or older than a source) and load one library,
    once per process; None when ``PHOTON_NO_NATIVE`` is set or the library
    cannot be built or loaded."""
    if os.environ.get("PHOTON_NO_NATIVE"):
        return None
    if lib_path in _libs:
        return _libs[lib_path]
    _libs[lib_path] = None
    if not all(os.path.exists(s) for s in sources):
        return None
    stale = (not os.path.exists(lib_path)
             or any(os.path.getmtime(s) > os.path.getmtime(lib_path) for s in sources))
    if stale and not _build(lib_path, sources, libs) and not os.path.exists(lib_path):
        return None
    try:
        _libs[lib_path] = ctypes.CDLL(lib_path)
    except OSError as e:
        logger.warning("native library load failed (%s)", e)
    return _libs[lib_path]


def load_avro_native() -> Optional[ctypes.CDLL]:
    """The Avro codec library (``avro_parse``, ``avro_write_training_blocks``
    and their helpers, prototyped by ``data/avro_native.py``), built on first
    use; None when it cannot be built or loaded, or when
    ``PHOTON_NO_NATIVE`` is set."""
    return _load(_AVRO_LIB_PATH, _AVRO_SOURCES, ("-lz",))


_parser_ready = False


def load_native() -> Optional[ctypes.CDLL]:
    """The parser library, built on first use; None when it cannot be built
    or loaded, or when ``PHOTON_NO_NATIVE`` is set."""
    global _parser_ready
    lib = _load(_LIB_PATH, (_SOURCE,))
    if lib is None or _parser_ready:
        return lib
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.libsvm_count.restype = ctypes.c_int
    lib.libsvm_count.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p, i64p]
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.libsvm_parse.restype = ctypes.c_int64
    lib.libsvm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, f64, i64, i64,
                                 f64, i64p, i64p]
    _parser_ready = True
    return lib


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
