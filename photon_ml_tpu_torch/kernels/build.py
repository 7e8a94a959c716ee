"""Build the Hopper kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` into its own object, all
``nvcc`` processes started together, and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and the headers they share (``csrc/*.cuh``), so a changed source is rebuilt
and an unchanged one is reused within a checkout. Nothing is built at import time: ``load_library()`` builds on its
first call, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _digest(paths: list[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(verbose: bool = False) -> str:
    """Compile and link the kernels; return the library's path.

    With ``verbose`` the compiler's register/shared-memory report
    (``-Xptxas -v``) is printed.
    """
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib_path = os.path.join(BUILD_DIR, f"libphoton_kernels-{_digest(srcs + headers())}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f"-{os.getpid()}.o")
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    failures = []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        if verbose and out:
            print(out, end="", flush=True)
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(src)} (rc={proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
        capture_output=True,
        text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.photon_csr_margins.argtypes = [p, p, p, p, p, p, f, p, i, i, p]
    lib.photon_csr_margins.restype = i
    # (rows, vals, tile_index, n_slots, n_pieces, finish_width, tile_rows,
    # piece_len, per_row, out, part, n_rows, n_features, square, stream)
    lib.photon_csc_scatter.argtypes = [p, p, p, i, i, i, i, i, p, p, p, i, i, i, p]
    lib.photon_csc_scatter.restype = i
    lib.photon_margins_pair.argtypes = [p, p, p, p, p, p, p, f, p, f, p, p, i, i, p]
    lib.photon_margins_pair.restype = i
    # the fused passes end with the scatter's (tile_index, n_slots, n_pieces,
    # finish_width, tile_rows, piece_len, part, n_rows, n_features, stream)
    scatter_tail = [p, i, i, i, i, i, p, i, i, p]
    lib.photon_value_grad.argtypes = [p] * 9 + [p, f, i, p, i, p, p] + scatter_tail
    lib.photon_value_grad.restype = i
    lib.photon_hessian_vector.argtypes = [p] * 10 + [p, f, p, f, i, p, i, p, p] + scatter_tail
    lib.photon_hessian_vector.restype = i
    lib.photon_hv_at.argtypes = [p] * 7 + [p, f, p, i, p, p] + scatter_tail
    lib.photon_hv_at.restype = i
    lib.photon_ell_margins.argtypes = [p, p, p, p, p, f, p, i, i, i, i, p]
    lib.photon_ell_margins.restype = i
    # (row_ptr, cols, vals, w, offsets, offsets_per_lane, shift_dev,
    # shift_host, out, n_rows, n_features, n_lanes, stream)
    lib.photon_csr_margins_lanes.argtypes = [p, p, p, p, p, i, p, f, p, i, i, i, p]
    lib.photon_csr_margins_lanes.restype = i
    # (rows, vals, tile_index, n_slots, n_pieces, finish_width, tile_rows,
    # piece_len, n_parts, per_row, out, part, n_rows, n_features, n_lanes,
    # square, stream)
    lib.photon_csc_scatter_lanes.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, i, i, i, p]
    lib.photon_csc_scatter_lanes.restype = i
    lib.photon_cuda_error_string.argtypes = [i]
    lib.photon_cuda_error_string.restype = ctypes.c_char_p


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build on first use (once per process) and return the loaded library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build(verbose=verbose))
            _declare(lib)
            _lib = lib
        return _lib
