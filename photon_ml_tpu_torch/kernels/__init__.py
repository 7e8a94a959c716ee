"""Wrappers of the Hopper kernels (``csrc/``), each with a launch count.

On a CPU tensor a wrapper runs the kernel's plain PyTorch version
(``kernels.reference``); on a CUDA tensor it launches the hand-written kernel
on the current stream or raises. There is no fallback from one to the other.
Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.kernels import reference
from photon_ml_tpu_torch.kernels.build import load_library

Tensor = torch.Tensor

LAUNCHES: dict[str, int] = {"csr_margins": 0, "csc_scatter": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _group_size(nnz: int, segments: int) -> int:
    """Lanes per segment: the power of two >= the mean segment length, <= 32."""
    mean = -(-nnz // max(segments, 1))
    g = 1
    while g < mean and g < 32:
        g *= 2
    return g


def _check(name: str, device: torch.device, **tensors: Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        want = torch.int32 if arg in ("row_ptr", "cols", "col_ptr", "rows") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(name: str, lib, rc: int) -> None:
    if rc != 0:
        msg = lib.photon_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def csr_margins(
    row_ptr: Tensor,
    cols: Tensor,
    vals: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """Per-row margins of a CSR matrix: sum_k vals_k*w[cols_k] + shift (+offsets)."""
    dev = row_ptr.device
    if dev.type == "cpu":
        return reference.csr_margins(row_ptr, cols, vals, w, offsets, shift, use_offsets)
    if dev.type != "cuda":
        raise ValueError(f"csr_margins: unsupported device {dev}")
    n = row_ptr.numel() - 1
    _check("csr_margins", dev, row_ptr=row_ptr, cols=cols, vals=vals, w=w, offsets=offsets)
    if cols.numel() != vals.numel() or offsets.numel() != n or w.dim() != 1:
        raise ValueError("csr_margins: inconsistent shapes")
    shift_ptr, shift_host = None, 0.0
    if isinstance(shift, Tensor):
        _check("csr_margins", dev, shift=shift)
        if shift.numel() != 1:
            raise ValueError("csr_margins: shift must hold one element")
        shift_ptr = shift.data_ptr()
    else:
        shift_host = float(shift)
    lib = load_library()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.photon_csr_margins(
            row_ptr.data_ptr(),
            cols.data_ptr(),
            vals.data_ptr(),
            w.data_ptr(),
            offsets.data_ptr() if use_offsets else None,
            shift_ptr,
            shift_host,
            out.data_ptr(),
            n,
            w.numel(),
            _group_size(vals.numel(), n),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on("csr_margins", lib, rc)
    LAUNCHES["csr_margins"] += 1
    return out


def csc_scatter(
    col_ptr: Tensor, rows: Tensor, vals: Tensor, per_row: Tensor, square: bool
) -> Tensor:
    """Feature-space scatter sum_i per_row[i]*x_i (x_i**2 with ``square``)."""
    dev = col_ptr.device
    if dev.type == "cpu":
        return reference.csc_scatter(col_ptr, rows, vals, per_row, square)
    if dev.type != "cuda":
        raise ValueError(f"csc_scatter: unsupported device {dev}")
    n_features = col_ptr.numel() - 1
    _check("csc_scatter", dev, col_ptr=col_ptr, rows=rows, vals=vals, per_row=per_row)
    if rows.numel() != vals.numel() or per_row.dim() != 1:
        raise ValueError("csc_scatter: inconsistent shapes")
    lib = load_library()
    out = torch.empty(n_features, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.photon_csc_scatter(
            col_ptr.data_ptr(),
            rows.data_ptr(),
            vals.data_ptr(),
            per_row.data_ptr(),
            out.data_ptr(),
            n_features,
            _group_size(vals.numel(), n_features),
            int(square),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on("csc_scatter", lib, rc)
    LAUNCHES["csc_scatter"] += 1
    return out
