"""ELL batch: a fixed-width, slot-major layout of the margins.

Counterpart of the arrays that ``tools/probe_ell.py:89-98`` builds for the
TPU kernel ``_ell_margins_kernel`` (lane-aligned tiles ``[T, S, 128]`` with
the column split into a block id and a lane). The GPU needs no split: slot
``s`` of every row lies in row ``s`` of ``vals f32[S, n_pad]`` and
``cols i32[S, n_pad]``, so the 32 threads of a warp, one per row, read 32
neighbouring words per slot. ``S`` is the largest row length; a shorter
row's missing slots carry value 0 and column 0. ``n_pad`` rounds the row
count up to a multiple of 128; outputs are cut to the ``n`` real rows.
There is no ``row_ptr``.

``dot_rows`` and ``margins`` launch ``csrc/ell_margins.cu`` on a CUDA
device and its plain version on the CPU.
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

ROW_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class ELLBatch:
    vals: Tensor  # f32[S, n_pad]
    cols: Tensor  # i32[S, n_pad]
    labels: Tensor  # f32[n]
    offsets: Tensor  # f32[n]
    num_features: int

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def slots_per_row(self) -> int:
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
        device: torch.device | str | None = None,
    ) -> "ELLBatch":
        """Host-side layout build from COO (slots keep each row's order),
        then one upload to ``device``."""
        dev = resolve_device(device)
        n = int(len(labels))
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        values = np.asarray(values, np.float32)
        validate_coo_indices(rows, cols, n, num_features)
        order = np.argsort(rows, kind="stable")
        rows, cols, values = rows[order], cols[order], values[order]
        counts = np.bincount(rows, minlength=n)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rows)) - starts[rows]
        n_slots = int(counts.max()) if n else 0
        n_pad = -(-max(n, 1) // ROW_ALIGN) * ROW_ALIGN
        ell_vals = np.zeros((n_slots, n_pad), np.float32)
        ell_cols = np.zeros((n_slots, n_pad), np.int32)
        ell_vals[slot, rows] = values
        ell_cols[slot, rows] = cols

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return ELLBatch(
            vals=up(ell_vals, np.float32),
            cols=up(ell_cols, np.int32),
            labels=up(np.asarray(labels, np.float64), np.float32),
            offsets=up(np.zeros(n) if offsets is None else np.asarray(offsets, np.float64),
                       np.float32),
            num_features=int(num_features),
        )

    @staticmethod
    def from_csr(batch) -> "ELLBatch":
        """The same rows from a ``CSRBatch``, built on the host and placed on
        the CSR's device."""
        counts = np.diff(batch.row_ptr.cpu().numpy())
        rows = np.repeat(np.arange(batch.num_rows), counts)
        return ELLBatch.from_coo(
            values=batch.vals.cpu().numpy(), rows=rows, cols=batch.cols.cpu().numpy(),
            labels=batch.labels.cpu().numpy(), num_features=batch.num_features,
            offsets=batch.offsets.cpu().numpy(), device=batch.device,
        )

    def margins(self, w: Tensor, shift: Tensor | float = 0.0) -> Tensor:
        """z_i = x_i . w + shift + offset_i (ELL margins kernel)."""
        return kernels.ell_margins(self.vals, self.cols, w, self.offsets, shift, True)

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_i . w, no offset or shift (ELL margins kernel)."""
        return kernels.ell_margins(self.vals, self.cols, w, self.offsets, 0.0, False)
