"""Plain PyTorch versions of the Hopper kernels.

They compute exactly what the kernels in ``csrc/`` compute, with
``index_add_`` in place of the warp loops and the losses of ``ops/losses.py``
in place of ``csrc/losses.cuh``. The CPU path of ``CSRBatch`` runs them; the
tests and ``chip_smoke.py`` hold the kernels against them. They run on any
device.

The fused passes take the row-sorted CSR as ``csr = (row_ptr, cols, vals)``
and its column-sorted mirror as ``csc = (col_ptr, rows, vals)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from photon_ml_tpu_torch.ops.losses import get_loss

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
    offsets: Optional[Tensor],
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


def ell_margins(
    vals: Tensor,
    cols: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """z_r = sum_s vals[s, r] * w[cols[s, r]] for the n = len(offsets) real
    rows of a slot-major ELL layout, + shift (+ offsets_r).

    The slots are summed one after another, in slot order: on the CPU that
    is the order in which ``csr_margins``'s ``index_add_`` adds a row's
    nonzeros, so the two layouts give the same float32 margins there.
    """
    n = offsets.numel()
    z = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    for s in range(vals.shape[0]):
        z = z + vals[s, :n] * w.index_select(0, cols[s, :n])
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


def margins_pair(
    csr: tuple[Tensor, Tensor, Tensor],
    w: Tensor,
    p: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    p_shift: Tensor | float,
) -> tuple[Tensor, Tensor]:
    """(X.w + shift + offsets, X.p + p_shift): only z carries offsets."""
    return (
        csr_margins(*csr, w, offsets, shift, True),
        csr_margins(*csr, p, None, p_shift, False),
    )


def value_grad(
    csr: tuple[Tensor, Tensor, Tensor],
    csc: tuple[Tensor, Tensor, Tensor],
    labels: Tensor,
    weights: Tensor,
    offsets: Tensor,
    w: Tensor,
    shift: Tensor | float,
    loss_name: str,
) -> tuple[Tensor, Tensor, Tensor]:
    """(sum wgt*l(z), sum_i wgt*l'(z_i)*x_i, sum wgt*l'(z)) at z = X.w + shift + offsets."""
    z = csr_margins(*csr, w, offsets, shift, True)
    l, dz = get_loss(loss_name).loss_and_dz(z, labels)
    g_row = weights * dz
    return torch.sum(weights * l), csc_scatter(*csc, g_row, False), torch.sum(g_row)


def hessian_vector(
    csr: tuple[Tensor, Tensor, Tensor],
    csc: tuple[Tensor, Tensor, Tensor],
    labels: Tensor,
    weights: Tensor,
    offsets: Tensor,
    w: Tensor,
    shift: Tensor | float,
    v: Tensor,
    v_shift: Tensor | float,
    loss_name: str,
) -> tuple[Tensor, Tensor]:
    """(sum_i q_i*x_i, sum q) with q = wgt*l''(X.w + shift + offsets)*(X.v + v_shift)."""
    z, u = margins_pair(csr, w, v, offsets, shift, v_shift)
    q = weights * get_loss(loss_name).d2z(z, labels) * u
    return csc_scatter(*csc, q, False), torch.sum(q)


def hv_at(
    csr: tuple[Tensor, Tensor, Tensor],
    csc: tuple[Tensor, Tensor, Tensor],
    d2: Tensor,
    v: Tensor,
    v_shift: Tensor | float,
) -> tuple[Tensor, Tensor]:
    """(sum_i q_i*x_i, sum q) with q = d2*(X.v + v_shift)."""
    q = d2 * csr_margins(*csr, v, None, v_shift, False)
    return csc_scatter(*csc, q, False), torch.sum(q)
