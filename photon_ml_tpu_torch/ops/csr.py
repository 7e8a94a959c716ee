"""CSR/CSC batch: the GPU fast-path layout of the GLM training loop.

Counterpart of ``TiledBatch`` (``photon_ml_tpu/ops/tiled.py:418-701``), with
the same duck-typed interface as ``SparseBatch``. The TPU layout groups
nonzeros into 128-row tiles for one-hot matmuls; the GPU does random access
well, so the layout is plain:

  - a row-sorted CSR (``row_ptr`` i32[n+1], ``cols`` i32, ``vals`` f32) that
    the row pass (``csrc/rowpass.cuh``) streams 32 rows per warp, one thread
    summing each row;
  - a mirror of the same nonzeros sorted for the feature-space half
    (``col_ptr``, ``csc_rows``, ``csc_vals``), summed feature by feature in a
    fixed order, so the gradient needs no atomics and is reproducible;
  - on a CUDA device, ``tiles``, the index over row tiles of
    ``SCATTER_TILE_ROWS`` (``scatter_tiles``): about 12 bytes per non-empty
    (tile, feature) segment, so at most about 12 per nonzero, and 15.1 MB at
    1M rows x 10K features x 20 nonzeros a row. With it the scatter
    (``csrc/scatter.cu``) and the tile-fused passes (``csrc/tile_fused.cuh``)
    stage per_row tile by tile in shared memory instead of gathering it from
    L2.

The mirror's order follows ``tiles``. Without them (a CPU batch, whose plain
versions read no index) it is column-major: columns ascending, rows
ascending inside a column, as ``col_ptr`` counts them. With them it is in
the index's slot order (``slot_order``): tile, then feature, then row, so
the 32 segments of a group are one contiguous span, each slot's segment
starts where ``off`` says (``start == off``), and the feature-space half
streams spans as the row pass does. ``column_major`` rebuilds the
column-major view on demand, for checks; the batch never holds both.

The mirror doubles the slot storage (about 320 MB at 20M nonzeros). Rows
are not padded: ``num_rows`` is n. A batch built with ``refreshable=True``
keeps ``value_order``, the CSR position of each mirror entry (4 bytes a
nonzero), so that ``with_values`` takes new values over the same structure
and gathers the mirror from them: nothing else is rebuilt and the tile index
is kept (the factored coordinate's refit changes only its values). ``margins_pair`` and the ``fused_*``
passes launch the fused kernels (``csrc/margins_pair.cu``,
``csrc/value_grad.cu``, ``csrc/hessian_vector.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import kernels
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.kernels import ScatterTiles
from photon_ml_tpu_torch.ops.sparse import validate_coo_indices

Tensor = torch.Tensor

_INT32_MAX = 2**31 - 1

# rows per tile of the tiled CSC scatter (per_row of one tile, 32 KB, is
# staged in a block's shared memory) and nonzeros per work piece
SCATTER_TILE_ROWS = 8192
SCATTER_PIECE_LEN = 2048


def scatter_tiles(csc_rows: np.ndarray, csc_cols: np.ndarray, n_rows: int, n_features: int,
                  tile_rows: int, piece_len: int) -> tuple[np.ndarray, ...]:
    """The tiled scatter's index (``csrc/scatter.cu``) for nonzeros in CSC
    order (columns ascending, rows ascending inside a column) at rows
    ``csc_rows`` and columns ``csc_cols``, as int64 arrays.

    A segment is the run of column f's entries with rows in tile t, one
    contiguous CSC range. Only the S non-empty segments are listed, tile by
    tile in feature order; each tile's list is padded with empty segments to
    a multiple of 32 slots, so there are at most S + 31 T slots and
    slots / 32 groups:

      - start[slots]: the CSC position where each slot's segment begins;
      - off[slots + 1]: the prefix sum of the segment lengths in slot order;
      - tile_group[T + 1]: the first group of each tile;
      - piece_ptr[groups + 1]: the first work piece of each group: its
        nonzeros in order, cut every piece_len;
      - feat_ptr[F + 1]: the first part of each feature, where a part is
        the sum of one segment over one piece it meets, and the parts lie
        feature by feature, tiles and then pieces ascending;
      - piece_group[pieces]: the group of each piece;
      - part_at[slots]: the part of each segment in the first piece it
        meets (0 for the padding).

    ``slot_order`` then lays the mirror out in slot order, where ``start``
    becomes ``off[:-1]``.
    """
    n_tiles = -(-n_rows // tile_rows)
    rows = np.asarray(csc_rows, np.int64)
    cols = np.asarray(csc_cols, np.int64)
    tile = rows // tile_rows
    # segments in CSC order (feature-major): where the (column, tile) changes
    first = np.ones(len(rows), bool)
    first[1:] = (cols[1:] != cols[:-1]) | (tile[1:] != tile[:-1])
    seg_start = np.flatnonzero(first)
    seg_len = np.diff(np.append(seg_start, len(rows)))
    seg_tile, seg_feat = tile[seg_start], cols[seg_start]
    # their slots: tile-major, features ascending inside a tile
    order = np.argsort(seg_tile, kind="stable")
    per_tile = np.bincount(seg_tile, minlength=n_tiles)
    tile_slot = np.concatenate([[0], np.cumsum(-(-per_tile // 32) * 32)])
    rank = np.arange(len(order)) - np.concatenate([[0], np.cumsum(per_tile)])[seg_tile[order]]
    slot = np.empty(len(order), np.int64)
    slot[order] = tile_slot[seg_tile[order]] + rank
    n_slots = int(tile_slot[-1])
    start = np.zeros(n_slots, np.int64)
    start[slot] = seg_start
    lengths = np.zeros(n_slots, np.int64)
    lengths[slot] = seg_len
    off = np.concatenate([[0], np.cumsum(lengths)])
    pieces = -(-np.diff(off[::32]) // piece_len)
    piece_ptr = np.concatenate([[0], np.cumsum(pieces)])
    piece_group = np.repeat(np.arange(n_slots // 32), pieces)
    # the pieces each segment meets, and its parts' places in CSC order
    into_group = off[slot] - off[slot // 32 * 32]
    parts = (into_group + seg_len - 1) // piece_len - into_group // piece_len + 1
    first_part = np.concatenate([[0], np.cumsum(parts)])
    part_at = np.zeros(n_slots, np.int64)
    part_at[slot] = first_part[:-1]
    feat_ptr = first_part[np.searchsorted(seg_feat, np.arange(n_features + 1))]
    return start, off, tile_slot // 32, piece_ptr, feat_ptr, piece_group, part_at


def slot_order(start: np.ndarray, off: np.ndarray) -> np.ndarray:
    """The mirror in ``scatter_tiles``' slot order: position p of the
    slot-ordered mirror holds entry ``perm[p]`` of the CSC order, so slot s's
    segment lies at [off[s], off[s + 1]) and its ``start`` becomes off[s]."""
    lengths = np.diff(off)
    return np.repeat(start - off[:-1], lengths) + np.arange(off[-1], dtype=np.int64)


def _tile_layout(csc_rows, csc_cols, n_rows, n_features, tile_rows, piece_len,
                 device) -> tuple[ScatterTiles, np.ndarray]:
    """``scatter_tiles`` for the slot-ordered mirror, as one int32 tensor on
    ``device`` with its sizes, and ``slot_order``'s permutation of the CSC
    entries."""
    start, off, *rest = scatter_tiles(csc_rows, csc_cols, n_rows, n_features, tile_rows,
                                      piece_len)
    perm = slot_order(start, off)
    arrays = (off[:-1], off, *rest)
    index = torch.from_numpy(np.concatenate(arrays).astype(np.int32)).to(device)
    tiles = ScatterTiles(index, tile_rows, piece_len, n_slots=len(start),
                         n_pieces=len(rest[3]), n_parts=int(rest[2][-1]))
    return tiles, perm


@dataclasses.dataclass(frozen=True)
class CSRBatch:
    row_ptr: Tensor  # i32[n+1]
    cols: Tensor  # i32[nnz], row-sorted
    vals: Tensor  # f32[nnz]
    col_ptr: Tensor  # i32[F+1], the column counts
    csc_rows: Tensor  # i32[nnz], column-major; in slot order with tiles
    csc_vals: Tensor  # f32[nnz], the same order
    labels: Tensor  # f32[n]
    offsets: Tensor  # f32[n]
    weights: Tensor  # f32[n]
    num_features: int
    tiles: Optional[ScatterTiles] = None  # the scatter's index, on a CUDA device
    value_order: Optional[Tensor] = None  # i32[nnz] CSR position of each mirror entry

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

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
        refreshable: bool = False,
    ) -> "CSRBatch":
        """Host-side layout build from COO, then one upload to ``device``;
        on a CUDA device with the tile index and the mirror in its slot
        order. The CSR order is the input's, stably sorted by row when it is
        not sorted; ``refreshable`` keeps ``value_order`` for
        ``with_values``."""
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

        csc_rows, csc_vals, tiles = rows[corder], values[corder], None
        if dev.type == "cuda":
            tiles, perm = _tile_layout(csc_rows, cols[corder], n, int(num_features),
                                       SCATTER_TILE_ROWS, SCATTER_PIECE_LEN, dev)
            csc_rows, csc_vals, corder = csc_rows[perm], csc_vals[perm], corder[perm]

        return CSRBatch(
            row_ptr=up(row_ptr, np.int32),
            cols=up(cols, np.int32),
            vals=up(values, np.float32),
            col_ptr=up(col_ptr, np.int32),
            csc_rows=up(csc_rows, np.int32),
            csc_vals=up(csc_vals, np.float32),
            labels=up(np.asarray(labels, np.float64), np.float32),
            offsets=per_row(offsets, 0.0),
            weights=per_row(weights, 1.0),
            num_features=int(num_features),
            tiles=tiles,
            value_order=up(corder, np.int32) if refreshable else None,
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

    def column_major(self) -> tuple[Tensor, Tensor, Tensor]:
        """The mirror as (col_ptr, rows, vals) in column-major order, built on
        the batch's device from the slot-ordered one (the plain versions read
        it; for checks, the batch does not hold it)."""
        return kernels.column_major(self._csc, self.tiles)

    def with_tiles(self, tile_rows: int = SCATTER_TILE_ROWS,
                   piece_len: int = SCATTER_PIECE_LEN) -> "CSRBatch":
        """This batch with the tile index built for ``tile_rows`` and
        ``piece_len`` and the mirror in its slot order, on its device."""
        col_ptr, rows, vals = (t.cpu().numpy() for t in self.column_major())
        cols = np.repeat(np.arange(self.num_features), np.diff(col_ptr))
        tiles, perm = _tile_layout(rows, cols, self.num_rows, self.num_features, tile_rows,
                                   piece_len, self.device)
        # value_order addressed the old mirror order: a re-tiled batch is not
        # refreshable
        return dataclasses.replace(
            self, csc_rows=torch.from_numpy(rows[perm]).to(self.device),
            csc_vals=torch.from_numpy(vals[perm]).to(self.device), tiles=tiles,
            value_order=None)

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
        return kernels.csc_scatter(*self._csc, per_row, False, self.tiles)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_i per_row[i] * x_i**2 (scatter kernel, square)."""
        return kernels.csc_scatter(*self._csc, per_row, True, self.tiles)

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
            loss_name, self.tiles,
        )

    def fused_hessian_vector(
        self, w: Tensor, shift, v: Tensor, v_shift, loss_name: str
    ) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter sum wgt*l''(z)*(x.v)*x, sum of the row terms q)
        (hv kernel)."""
        return kernels.hv(
            self._csr, self._csc, self.labels, self.weights, self.offsets, w, shift, v,
            v_shift, loss_name, self.tiles,
        )

    def fused_hv_at(self, d2_row: Tensor, v_eff: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        """(raw Hv scatter, sum q) with q = d2 * (x.v + v_shift) (hv_at kernel)."""
        return kernels.hv_at(self._csr, self._csc, d2_row, v_eff, v_shift, self.tiles)

    def feature_moment_sums(self) -> tuple[Tensor, Tensor, Tensor]:
        """Per-feature (sum x, sum x^2, count nonzero) over the valid
        (weight > 0) rows, as ``TiledBatch.feature_moment_sums``
        (``tiled.py:686-694``): the scatter kernel, plain and ``square``, of
        the valid-row indicator, and the count as the scatter of the same
        indicator over the mirror's nonzero pattern. Every sum is the
        kernel's fixed-order sum, with no float atomics, and the count is
        exact below 2^24 rows."""
        valid = (self.weights > 0).to(torch.float32)
        ones = dataclasses.replace(self, csc_vals=(self.csc_vals != 0).to(torch.float32))
        return (
            self.scatter_features(valid),
            self.scatter_features_sq(valid),
            ones.scatter_features(valid),
        )

    def with_values(self, vals: Tensor) -> "CSRBatch":
        """The same structure with new values ``vals`` in CSR order; the
        mirror is gathered from them through ``value_order`` on the device,
        so the margins and the scatter both see the new values."""
        if self.value_order is None:
            raise ValueError("with_values needs a batch built with refreshable=True")
        vals = vals.to(torch.float32).contiguous()
        if vals.shape != self.vals.shape:
            raise ValueError(f"values must be [{self.nnz}], got {tuple(vals.shape)}")
        return dataclasses.replace(self, vals=vals,
                                   csc_vals=vals.index_select(0, self.value_order))

    def with_offsets(self, offsets: Tensor) -> "CSRBatch":
        return dataclasses.replace(
            self, offsets=offsets.to(torch.float32).contiguous()
        )
