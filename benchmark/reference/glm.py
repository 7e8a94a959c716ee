"""Plain logistic GLM arithmetic over rows of ``k`` nonzeros each.

F(w) = sum_i l(x_i . w, y_i) + (l2/2) |w|^2 with l(z, y) = log(1 + e^z) - y z,
and its gradient, for G vectors at once, over row shards that may lie on
different cards. Every sum is taken in ``dtype``: float64 for the
reference, a lower precision for the control.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: rows a block; temporaries are k * G values a row
BLOCK_ROWS = 1 << 18

def value_grad(shards: Sequence, W: Tensor, l2, dtype=torch.float64,
               offsets: Sequence | None = None) -> tuple[Tensor, Tensor]:
    """F and its gradient for each row of ``W`` [G, F] (or one [F]) over the
    row shards (``cols``, ``vals``, ``labels``, ``nnz_per_row``), with
    per-row ``offsets`` (one tensor a shard) added to the margins. The
    partials of each shard are summed on ``W``'s device in shard order;
    ``l2`` is a number or a [G] tensor. Returns ([G], [G, F]) in ``dtype``
    (a 1-D ``W`` gives a scalar and [F])."""
    one = W.dim() == 1
    W2 = W.reshape(1, -1) if one else W
    G, nf = W2.shape
    home = W2.device
    value = torch.zeros(G, dtype=dtype, device=home)
    grad = torch.zeros(G, nf, dtype=dtype, device=home)
    for i, s in enumerate(shards):
        v, g = _shard_value_grad(s.cols, s.vals, s.labels, s.nnz_per_row,
                                 W2.to(s.vals.device), dtype,
                                 None if offsets is None else offsets[i])
        value = value + v.to(home)
        grad = grad + g.to(home)
    Wd = W2.to(dtype)
    l2 = torch.as_tensor(l2, dtype=dtype, device=home).reshape(-1, 1)
    value = value + 0.5 * (l2[:, 0] * (Wd * Wd).sum(1))
    grad = grad + l2 * Wd
    return (value[0], grad[0]) if one else (value, grad)

def _shard_value_grad(cols: Tensor, vals: Tensor, labels: Tensor, k: int, W: Tensor,
                      dtype, offsets: Tensor | None = None) -> tuple[Tensor, Tensor]:
    G, nf = W.shape
    n = labels.shape[0]
    dev = vals.device
    Wt = W.t().to(dtype).contiguous()  # [F, G]
    value = torch.zeros(G, dtype=dtype, device=dev)
    grad = torch.zeros(nf, G, dtype=dtype, device=dev)
    step = max(1024, BLOCK_ROWS * 16 // max(G, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        c = cols[s * k:e * k].long()
        v = vals[s * k:e * k].to(dtype).unsqueeze(1)
        y = labels[s:e].to(dtype).unsqueeze(1)
        z = (v * Wt[c]).view(e - s, k, G).sum(1)  # [b, G]
        if offsets is not None:
            z = z + offsets[s:e].to(dtype).unsqueeze(1)
        value = value + (F.softplus(z) - y * z).sum(0)
        r = torch.sigmoid(z) - y
        grad.index_add_(0, c, v * r.repeat_interleave(k, dim=0))
    return value, grad.t()

def margins(cols: Tensor, vals: Tensor, k: int, w: Tensor, dtype=torch.float64) -> Tensor:
    """x_i . w for every row, in ``dtype`` (w may lie on another card)."""
    n = vals.shape[0] // k
    wd = w.to(device=vals.device, dtype=dtype)
    out = torch.empty(n, dtype=dtype, device=vals.device)
    for s in range(0, n, BLOCK_ROWS * 4):
        e = min(n, s + BLOCK_ROWS * 4)
        out[s:e] = (vals[s * k:e * k].to(dtype) * wd[cols[s * k:e * k].long()]).view(
            e - s, k).sum(1)
    return out

def scatter(cols: Tensor, vals: Tensor, k: int, per_row: Tensor, num_features: int) -> Tensor:
    """X^T per_row, in per_row's dtype."""
    n = vals.shape[0] // k
    out = torch.zeros(num_features, dtype=per_row.dtype, device=vals.device)
    for s in range(0, n, BLOCK_ROWS * 4):
        e = min(n, s + BLOCK_ROWS * 4)
        out.index_add_(0, cols[s * k:e * k].long(),
                       vals[s * k:e * k].to(per_row.dtype)
                       * per_row[s:e].repeat_interleave(k))
    return out

def logistic_sum(z: Tensor, y: Tensor) -> Tensor:
    """sum_i l(z_i, y_i)."""
    return (F.softplus(z) - y.to(z.dtype) * z).sum()
