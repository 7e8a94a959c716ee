"""CSR/CSC batch: the GPU fast-path layout of the GLM training loop.

Counterpart of ``TiledBatch`` (``photon_ml_tpu/ops/tiled.py:418-701``), with
the same duck-typed interface as ``SparseBatch``. The TPU layout groups
nonzeros into 128-row tiles for one-hot matmuls; the GPU does random access
well, so the layout is plain:

  - a row-sorted CSR (``row_ptr`` i32[n+1], ``cols`` i32, ``vals`` f32) that
    the margins kernel (``csrc/margins.cu``) walks one row per lane group;
  - a column-sorted CSC mirror (``col_ptr``, ``csc_rows``, ``csc_vals``) that
    the scatter kernel (``csrc/scatter.cu``) walks one feature per lane
    group, so the gradient needs no atomics and is reproducible.

The mirror doubles the slot storage (about 320 MB at 20M nonzeros). Rows
are not padded: ``num_rows`` is n. ``margins_pair`` and the ``fused_*``
passes launch the fused kernels (``csrc/margins_pair.cu``,
``csrc/value_grad.cu``, ``csrc/hessian_vector.cu``): one row pass over the
CSR, then the CSC scatter for the feature-space half.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.sparse import validate_coo_indices

Tensor = torch.Tensor

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class CSRBatch:
    row_ptr: Tensor  # i32[n+1]
    cols: Tensor  # i32[nnz], row-sorted
    vals: Tensor  # f32[nnz]
    col_ptr: Tensor  # i32[F+1]
    csc_rows: Tensor  # i32[nnz], column-sorted (rows ascending inside a column)
    csc_vals: Tensor  # f32[nnz]
    labels: Tensor  # f32[n]
    offsets: Tensor  # f32[n]
    weights: Tensor  # f32[n]
    num_features: int

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

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
    ) -> "CSRBatch":
        """Host-side layout build from COO, then one upload to ``device``."""
        dev = resolve_device(device)
        n = int(len(labels))
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        values = np.asarray(values, np.float32)
        validate_coo_indices(rows, cols, n, num_features)
        if len(values) > _INT32_MAX:
            raise ValueError(f"{len(values)} nonzeros exceed the int32 index range")
        if len(rows) and not np.all(rows[1:] >= rows[:-1]):
            order = np.argsort(rows, kind="stable")
            rows, cols, values = rows[order], cols[order], values[order]
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
        # stable sort of the row-sorted COO keeps rows ascending per column
        corder = np.argsort(cols, kind="stable")
        col_ptr = np.zeros(int(num_features) + 1, np.int64)
        np.cumsum(np.bincount(cols, minlength=int(num_features)), out=col_ptr[1:])

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        def per_row(a, default):
            return up(np.full(n, default) if a is None else np.asarray(a, np.float64),
                      np.float32)

        return CSRBatch(
            row_ptr=up(row_ptr, np.int32),
            cols=up(cols, np.int32),
            vals=up(values, np.float32),
            col_ptr=up(col_ptr, np.int32),
            csc_rows=up(rows[corder], np.int32),
            csc_vals=up(values[corder], np.float32),
            labels=up(np.asarray(labels, np.float64), np.float32),
            offsets=per_row(offsets, 0.0),
            weights=per_row(weights, 1.0),
            num_features=int(num_features),
        )

    @staticmethod
    def from_dense(X, labels, offsets=None, weights=None, device=None) -> "CSRBatch":
        X = np.asarray(X)
        rows, cols = np.nonzero(X)
        return CSRBatch.from_coo(
            values=X[rows, cols], rows=rows, cols=cols, labels=labels,
            num_features=X.shape[1], offsets=offsets, weights=weights, device=device,
        )

    def to_dense(self) -> np.ndarray:
        """Host-side densify (tests / diagnostics only)."""
        counts = np.diff(self.row_ptr.cpu().numpy())
        rows = np.repeat(np.arange(self.num_rows), counts)
        X = np.zeros((self.num_rows, self.num_features), np.float64)
        np.add.at(X, (rows, self.cols.cpu().numpy()), self.vals.cpu().numpy())
        return X

    @property
    def _csr(self) -> tuple[Tensor, Tensor, Tensor]:
        return self.row_ptr, self.cols, self.vals

    @property
    def _csc(self) -> tuple[Tensor, Tensor, Tensor]:
        return self.col_ptr, self.csc_rows, self.csc_vals

    # -- the kernels ---------------------------------------------------------

    def margins(self, w: Tensor, shift: Tensor | float = 0.0) -> Tensor:
        """z_i = x_i . w + shift + offset_i (margins kernel)."""
        return kernels.csr_margins(
            self.row_ptr, self.cols, self.vals, w, self.offsets, shift, True
        )

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_i . w, no offset or shift (margins kernel)."""
        return kernels.csr_margins(
            self.row_ptr, self.cols, self.vals, w, self.offsets, 0.0, False
        )

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[i] * x_i (scatter kernel)."""
        return kernels.csc_scatter(
            self.col_ptr, self.csc_rows, self.csc_vals, per_row, False
        )

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[i] * x_i**2 (scatter kernel, square)."""
        return kernels.csc_scatter(
            self.col_ptr, self.csc_rows, self.csc_vals, per_row, True
        )

    def margins_pair(self, w: Tensor, shift, p: Tensor, p_shift) -> tuple[Tensor, Tensor]:
        """(margins(w, shift), dot_rows(p) + p_shift) in one sweep (pair kernel)."""
        return kernels.margins_pair(self._csr, w, p, self.offsets, shift, p_shift)

    def fused_value_grad(
        self, w: Tensor, shift, loss_name: str
    ) -> tuple[Tensor, Tensor, Tensor]:
        """(sum wgt*l(z), raw gradient scatter sum wgt*dz*x, sum wgt*dz)
        (value_grad kernel)."""
        return kernels.value_grad(
            self._csr, self._csc, self.labels, self.weights, self.offsets, w, shift,
            loss_name,
        )

    def fused_hessian_vector(
        self, w: Tensor, shift, v: Tensor, v_shift, loss_name: str
    ) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter sum wgt*l''(z)*(x.v)*x, sum of the row terms q)
        (hv kernel)."""
        return kernels.hv(
            self._csr, self._csc, self.labels, self.weights, self.offsets, w, shift, v,
            v_shift, loss_name,
        )

    def fused_hv_at(self, d2_row: Tensor, v_eff: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter, sum q) with q = d2 * (x.v + v_shift) (hv_at kernel)."""
        return kernels.hv_at(self._csr, self._csc, d2_row, v_eff, v_shift)

    def feature_moment_sums(self) -> tuple[Tensor, Tensor, Tensor]:
        """Per-feature (sum x, sum x^2, count nonzero) over valid rows."""
        valid = (self.weights > 0).to(torch.float32)
        ones = dataclasses.replace(self, csc_vals=(self.csc_vals != 0).to(torch.float32))
        return (
            self.scatter_features(valid),
            self.scatter_features_sq(valid),
            ones.scatter_features(valid),
        )

    def with_offsets(self, offsets: Tensor) -> "CSRBatch":
        return dataclasses.replace(
            self, offsets=offsets.to(torch.float32).contiguous()
        )
