"""Plain PyTorch versions of the two Hopper kernels.

They compute exactly what ``csrc/margins.cu`` and ``csrc/scatter.cu``
compute, with ``index_add_`` in place of the warp loops. The CPU path of
``CSRBatch`` runs them; the tests and ``chip_smoke.py`` hold the kernels
against them. They run on any device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _segment_ids(ptr: Tensor, total: int) -> Tensor:
    """Expand a CSR/CSC pointer array into one segment id per nonzero."""
    counts = ptr[1:] - ptr[:-1]
    ids = torch.arange(counts.numel(), device=ptr.device)
    return torch.repeat_interleave(ids, counts, output_size=total)


def csr_margins(
    row_ptr: Tensor,
    cols: Tensor,
    vals: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """z_i = sum_k vals_k * w[cols_k] over row i, + shift (+ offsets_i)."""
    n = row_ptr.numel() - 1
    contrib = vals * w.index_select(0, cols)
    rows = _segment_ids(row_ptr, vals.numel())
    z = torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
        0, rows, contrib
    )
    z = z + shift
    if use_offsets:
        z = z + offsets
    return z


def csc_scatter(
    col_ptr: Tensor, rows: Tensor, vals: Tensor, per_row: Tensor, square: bool
) -> Tensor:
    """g_f = sum_k per_row[rows_k] * vals_k (vals_k**2 with ``square``)."""
    n_features = col_ptr.numel() - 1
    v = vals * vals if square else vals
    contrib = per_row.index_select(0, rows) * v
    cols = _segment_ids(col_ptr, vals.numel())
    return torch.zeros(n_features, dtype=vals.dtype, device=vals.device).index_add_(
        0, cols, contrib
    )
