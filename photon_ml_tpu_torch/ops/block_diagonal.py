"""The block-diagonal batch of a COO-routed random-effect bucket.

A bucket of E entities, each with R (padded) rows over K local features, is
one block-diagonal sparse matrix of [E*R x E*K]: entity e's row r is row
e*R + r and its local feature c is column e*K + c. ``BlockDiagonalBatch``
holds it as one ``CSRBatch`` (the CSR, its CSC mirror and, on a CUDA device,
the scatter's tile index), so each per-entity sweep of every lane of the
bucket is one call of a hand-written kernel:

  - X.w and X.p (margins, directional margins, scores): ``csr_margins``;
  - X^T r (gradients): ``csc_scatter``; (X*X)^T r (the Hessian diagonal
    of the variances): ``csc_scatter`` with ``square``;
  - X^T (d2 * X.v) (TRON's CG; the box path's Hv after one
    ``csr_margins``): ``hv_at``;
  - the margins of a box-constrained LBFGS line search: ``margins_pair``.

Coefficients ``[E, K]`` flatten to the E*K columns and per-row arrays
``[E, R]`` to the E*R rows: padded rows stay, with no nonzeros and weight 0,
so the reshape is exact; padded nonzeros (value 0) are dropped. The per-row
losses and the per-lane sums are plain tensor ops, ``[E, R].sum(-1)``, whose
order is fixed. The tile-fused ``value_grad`` and ``hv`` are not used: their
loss sum runs over all rows of the batch, all lanes together; nor is
``hv_at``'s sum of its row terms, which only a shift normalization reads,
and a random effect has none (the batch refuses a shift).

The reference runs these sweeps as ``vmap`` over one padded-COO
``SparseBatch`` per entity (``photon_ml_tpu/game/coordinates.py:658-720``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor

_INT32_MAX = 2**31 - 1


def _no_shift(shift) -> None:
    if isinstance(shift, Tensor) or shift != 0.0:
        raise ValueError("the block-diagonal batch takes no shift normalization (a random "
                         "effect's objective has none)")


@dataclasses.dataclass(frozen=True)
class BlockDiagonalBatch:
    csr: CSRBatch  # rows e*R + r, columns e*K + c
    num_entities: int
    rows_per_entity: int
    num_local_features: int

    @staticmethod
    def from_bucket(
        values: np.ndarray,
        rows: np.ndarray,
        cols: np.ndarray,
        labels: np.ndarray,
        offsets: np.ndarray,
        weights: np.ndarray,
        num_local_features: int,
        device: torch.device | str | None = None,
    ) -> "BlockDiagonalBatch":
        """The batch of a bucket's host arrays: ``values``/``rows``/``cols``
        ``[E, NZ]`` (local rows in [0, R), local features in [0, K)),
        ``labels``/``offsets``/``weights`` ``[E, R]``; the layout is built on
        the host and uploaded to ``device`` once. A bucket whose rows or
        columns pass the int32 range is refused."""
        n_ent, n_rows = np.shape(labels)
        k = int(num_local_features)
        if n_ent * n_rows > _INT32_MAX or n_ent * k > _INT32_MAX:
            raise ValueError(
                f"a bucket of {n_ent} entities x {n_rows} rows x {k} features passes the "
                f"int32 range of the block-diagonal batch ({n_ent * n_rows} rows, "
                f"{n_ent * k} columns)")
        values = np.asarray(values, np.float32)
        keep = values != 0
        ent = np.nonzero(keep)[0].astype(np.int64)
        g_rows = ent * n_rows + np.asarray(rows, np.int64)[keep]
        g_cols = ent * k + np.asarray(cols, np.int64)[keep]
        csr = CSRBatch.from_coo(
            values[keep], g_rows, g_cols, np.reshape(labels, -1), n_ent * k,
            offsets=np.reshape(offsets, -1), weights=np.reshape(weights, -1), device=device)
        return BlockDiagonalBatch(csr, int(n_ent), int(n_rows), k)

    @property
    def _lanes(self) -> tuple[int, int]:
        return self.num_entities, self.rows_per_entity

    @property
    def labels(self) -> Tensor:
        return self.csr.labels.view(self._lanes)

    @property
    def offsets(self) -> Tensor:
        return self.csr.offsets.view(self._lanes)

    @property
    def weights(self) -> Tensor:
        return self.csr.weights.view(self._lanes)

    @property
    def device(self) -> torch.device:
        return self.csr.device

    def _by_entity(self, w: Tensor) -> Tensor:
        """Per-entity coefficients ``[E, K]`` as the batch's column vector."""
        if tuple(w.shape) != (self.num_entities, self.num_local_features):
            raise ValueError(f"coefficients must be [{self.num_entities}, "
                             f"{self.num_local_features}], got {tuple(w.shape)}")
        return w.reshape(-1).contiguous()

    def _features(self, out: Tensor) -> Tensor:
        return out.view(self.num_entities, self.num_local_features)

    # -- sweeps (the DenseBatch duck type, one problem per entity) ---------------

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_er . w_e -> [E, R] (margins kernel)."""
        return self.csr.dot_rows(self._by_entity(w)).view(self._lanes)

    def margins(self, w: Tensor, shift=0.0) -> Tensor:
        """x_er . w_e + offset_er -> [E, R] (margins kernel)."""
        _no_shift(shift)
        return self.csr.margins(self._by_entity(w)).view(self._lanes)

    def margins_pair(self, w, shift, p, p_shift) -> tuple[Tensor, Tensor]:
        """(margins(w), dot_rows(p)) in one sweep (pair kernel)."""
        _no_shift(shift)
        _no_shift(p_shift)
        z, u = self.csr.margins_pair(self._by_entity(w), 0.0, self._by_entity(p), 0.0)
        return z.view(self._lanes), u.view(self._lanes)

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[e, r] * x_er -> [E, K] (scatter kernel)."""
        return self._features(self.csr.scatter_features(per_row.reshape(-1).contiguous()))

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[e, r] * x_er**2 -> [E, K] (scatter kernel, square)."""
        return self._features(self.csr.scatter_features_sq(per_row.reshape(-1).contiguous()))

    def fused_value_grad(self, w, shift, loss_name: str) -> tuple[Tensor, Tensor, Tensor]:
        """Per entity: (sum wgt*l(z), raw gradient sum wgt*dz*x, sum wgt*dz);
        the margins and scatter kernels, the sums over each lane's rows."""
        z = self.margins(w, shift)
        l, dz = get_loss(loss_name).loss_and_dz(z, self.labels)
        wdz = self.weights * dz
        return (torch.sum(self.weights * l, dim=-1), self.scatter_features(wdz),
                torch.sum(wdz, dim=-1))

    def fused_hv_at(self, d2_row: Tensor, v: Tensor, v_shift) -> tuple[Tensor, None]:
        """(raw Hv [E, K] with the row curvature d2 given, None): the hv_at
        kernel. Its sum of the row terms spans all lanes and is not returned."""
        _no_shift(v_shift)
        c = self.csr
        hv, _ = kernels.hv_at(c._csr, c._csc, d2_row.reshape(-1).contiguous(),
                              self._by_entity(v), 0.0, c.tiles)
        return self._features(hv), None

    def fused_hessian_vector(self, w, shift, v, v_shift, loss_name: str) -> tuple[Tensor, None]:
        """(raw Hv at w, None): the row curvature from one margins launch,
        then ``fused_hv_at``."""
        d2 = self.weights * get_loss(loss_name).d2z(self.margins(w, shift), self.labels)
        return self.fused_hv_at(d2, v, v_shift)

    def dense_rows(self) -> Tensor:
        """The dense designs [E, R, K] on the batch's device, for NEWTON's
        explicit Hessians (the reference's ``SparseBatch.dense_rows``). A
        repeated (row, feature) pair is summed by a segment sum in a fixed
        order, not by atomics."""
        c = self.csr
        n_ent, n_rows = self._lanes
        k = self.num_local_features
        counts = (c.row_ptr[1:] - c.row_ptr[:-1]).long()
        rows = torch.repeat_interleave(torch.arange(n_ent * n_rows, device=c.device), counts,
                                       output_size=c.nnz)
        flat = rows * k + c.cols.long() - (rows // n_rows) * k
        flat, order = torch.sort(flat, stable=True)
        at, lengths = torch.unique_consecutive(flat, return_counts=True)
        x = torch.zeros(n_ent * n_rows * k, dtype=torch.float32, device=c.device)
        x[at] = torch.segment_reduce(c.vals[order], "sum", lengths=lengths)
        return x.view(n_ent, n_rows, k)

    def with_offsets(self, offsets: Tensor) -> "BlockDiagonalBatch":
        return dataclasses.replace(self, csr=self.csr.with_offsets(offsets.reshape(-1)))

