"""COO sparse batches in PyTorch.

Counterpart of ``photon_ml_tpu/ops/sparse.py``: parallel ``values``/``rows``/
``cols`` arrays plus per-row ``labels``/``offsets``/``weights``. Margins are
``index_select`` + ``index_add_`` over rows, the gradient an ``index_add_``
over features. PyTorch runs eagerly, so shapes need not be static and
nothing is padded (the reference pads for ``jit``).

Its fused passes (``margins_pair``, ``fused_*``) are compositions of
``margins``/``dot_rows``/``scatter_features`` (the reference semantics of
``ops/sparse.py:230-315``); ``CSRBatch`` runs fused kernels instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor


def validate_coo_indices(
    rows: np.ndarray, cols: np.ndarray, num_rows: int, num_features: int
) -> None:
    """Reject out-of-range COO indices (copy of the reference's check,
    ``photon_ml_tpu/ops/sparse.py:43-58``): an out-of-range column would
    corrupt the scatter."""
    if len(cols) and (cols.min() < 0 or cols.max() >= num_features):
        raise ValueError(
            f"feature indices must be in [0, {num_features}); got "
            f"[{cols.min()}, {cols.max()}]"
        )
    if len(rows) and (rows.min() < 0 or rows.max() >= num_rows):
        raise ValueError(
            f"row indices must be in [0, {num_rows}); got [{rows.min()}, {rows.max()}]"
        )


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """A batch of sparse labeled examples (COO, sorted by row)."""

    values: Tensor  # f32[nnz]
    rows: Tensor  # i64[nnz], non-decreasing
    cols: Tensor  # i64[nnz]
    labels: Tensor  # f32[n]
    offsets: Tensor  # f32[n]
    weights: Tensor  # f32[n]
    num_features: int

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @staticmethod
    def from_coo(
        values: np.ndarray,
        rows: np.ndarray,
        cols: np.ndarray,
        labels: np.ndarray,
        num_features: int,
        offsets: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        device: torch.device | str | None = None,
    ) -> "SparseBatch":
        """Sort by row and upload to ``device`` (default cuda)."""
        dev = resolve_device(device)
        n = int(len(labels))
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        validate_coo_indices(rows, cols, n, num_features)
        values = np.asarray(values)
        if len(rows) and not np.all(rows[1:] >= rows[:-1]):
            order = np.argsort(rows, kind="stable")
            values, rows, cols = values[order], rows[order], cols[order]
        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        def i64(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

        return SparseBatch(
            values=f32(values),
            rows=i64(rows),
            cols=i64(cols),
            labels=f32(labels),
            offsets=f32(np.zeros(n) if offsets is None else offsets),
            weights=f32(np.ones(n) if weights is None else weights),
            num_features=int(num_features),
        )

    @staticmethod
    def from_dense(X, labels, offsets=None, weights=None, device=None) -> "SparseBatch":
        X = np.asarray(X)
        rows, cols = np.nonzero(X)
        return SparseBatch.from_coo(
            values=X[rows, cols], rows=rows, cols=cols, labels=labels,
            num_features=X.shape[1], offsets=offsets, weights=weights, device=device,
        )

    def dense_rows(self) -> Tensor:
        """Densify on the device: [num_rows, num_features], for small feature
        dimensions (``ops/sparse.py:191-196``)."""
        X = torch.zeros((self.num_rows, self.num_features), dtype=self.values.dtype,
                        device=self.values.device)
        return X.index_put_((self.rows, self.cols), self.values, accumulate=True)

    def _row_sums(self, contrib: Tensor) -> Tensor:
        return torch.zeros(
            self.num_rows, dtype=contrib.dtype, device=contrib.device
        ).index_add_(0, self.rows, contrib)

    def margins(self, w: Tensor, shift: Tensor | float = 0.0) -> Tensor:
        """z_i = x_i . w + offset_i + shift."""
        return self.dot_rows(w) + self.offsets + shift

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_i . w (no offset, no shift)."""
        return self._row_sums(self.values * w.index_select(0, self.cols))

    def _scatter(self, v: Tensor, per_row: Tensor) -> Tensor:
        contrib = v * per_row.index_select(0, self.rows)
        return torch.zeros(
            self.num_features, dtype=contrib.dtype, device=contrib.device
        ).index_add_(0, self.cols, contrib)

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[i] * x_i as a dense feature vector."""
        return self._scatter(self.values, per_row)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[i] * x_i**2 elementwise (Hessian diagonal)."""
        return self._scatter(self.values * self.values, per_row)

    # -- fused passes as compositions (ops/sparse.py:230-315) --------------

    def margins_pair(self, w: Tensor, shift, p: Tensor, p_shift) -> tuple[Tensor, Tensor]:
        """(margins(w, shift), dot_rows(p) + p_shift)."""
        return self.margins(w, shift), self.dot_rows(p) + p_shift

    def fused_value_grad(
        self, w: Tensor, shift, loss_name: str
    ) -> tuple[Tensor, Tensor, Tensor]:
        """(sum wgt*l(z), raw gradient scatter sum wgt*dz*x, sum wgt*dz)."""
        z = self.margins(w, shift)
        l, dz = get_loss(loss_name).loss_and_dz(z, self.labels)
        g_row = self.weights * dz
        return torch.sum(self.weights * l), self.scatter_features(g_row), torch.sum(g_row)

    def fused_hessian_vector(
        self, w: Tensor, shift, v: Tensor, v_shift, loss_name: str
    ) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter sum wgt*l''(z)*(x.v)*x, sum of the row terms q)."""
        z, xv = self.margins_pair(w, shift, v, v_shift)
        q = self.weights * get_loss(loss_name).d2z(z, self.labels) * xv
        return self.scatter_features(q), torch.sum(q)

    def fused_hv_at(self, d2_row: Tensor, v_eff: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter, sum q) with q = d2 * (x.v + v_shift) precomputed d2."""
        q = d2_row * (self.dot_rows(v_eff) + v_shift)
        return self.scatter_features(q), torch.sum(q)

    def feature_moment_sums(self) -> tuple[Tensor, Tensor, Tensor]:
        """Per-feature (sum x, sum x^2, count nonzero) over valid rows."""
        valid = (self.weights > 0).to(self.values.dtype)
        v = self.values * valid.index_select(0, self.rows)
        zeros = torch.zeros(self.num_features, dtype=v.dtype, device=v.device)
        return (
            zeros.index_add(0, self.cols, v),
            zeros.index_add(0, self.cols, v * v),
            zeros.index_add(0, self.cols, (v != 0).to(v.dtype)),
        )

    def with_offsets(self, offsets: Tensor) -> "SparseBatch":
        return dataclasses.replace(self, offsets=offsets)
