"""The modelled work of each kernel of the program: ``(flops, bytes)`` from a
call's shapes alone.

A frozen copy of ``photon_ml_tpu_torch/kernels/cost.py`` as the benchmark
was defined: the program may change its own copy, the yardstick stays. The
bytes are what a call must move, each input read once and each output
written once (4 bytes a value or an index: float32 or int32); the flops are
its multiply-adds, two a product. Over the card's peaks (``peaks.py``) they
give the least time the card could take for the call.
"""

from __future__ import annotations

__all__ = [
    "WORD",
    "csr_margins",
    "csc_scatter",
    "margins_pair",
    "value_grad",
    "hv",
    "hv_at",
    "ell_margins",
    "csr_margins_lanes",
    "csc_scatter_lanes",
    "dense_rows",
    "dense_scatter",
    "tiles_traffic",
]

#: Bytes of one value or index (float32 or int32).
WORD = 4


def _slots(n_rows: int, nnz: int) -> int:
    """Words of one layout's slots: the row (or column) pointer and the
    index and value of every nonzero."""
    return (n_rows + 1) + 2 * nnz


def csr_margins(n_rows: int, nnz: int, n_features: int,
                use_offsets: bool = False) -> tuple[int, int]:
    """X.w (+ offsets): the CSR, w and the margins (and the offsets)."""
    words = _slots(n_rows, nnz) + n_features + n_rows + (n_rows if use_offsets else 0)
    return 2 * nnz, WORD * words


def csc_scatter(n_rows: int, nnz: int, n_features: int) -> tuple[int, int]:
    """X^T r: the mirror, the per-row vector and the feature sums."""
    return 2 * nnz, WORD * (_slots(n_features, nnz) + n_rows + n_features)


def margins_pair(n_rows: int, nnz: int, n_features: int) -> tuple[int, int]:
    """(X.w + offsets, X.p): the CSR, w and p, the offsets, both margins."""
    return 4 * nnz, WORD * (_slots(n_rows, nnz) + 2 * n_features + n_rows + 2 * n_rows)


def value_grad(n_rows: int, nnz: int, n_features: int) -> tuple[int, int]:
    """Loss, gradient and the sum of l': the CSR, labels, weights and
    offsets, w, the gradient and the two sums."""
    return 4 * nnz, WORD * (_slots(n_rows, nnz) + 3 * n_rows + 2 * n_features + 2)


def hv(n_rows: int, nnz: int, n_features: int) -> tuple[int, int]:
    """Hv at w: the CSR, labels, weights and offsets, w and v, Hv and its
    one sum."""
    return 6 * nnz, WORD * (_slots(n_rows, nnz) + 3 * n_rows + 3 * n_features + 1)


def hv_at(n_rows: int, nnz: int, n_features: int) -> tuple[int, int]:
    """Hv at a given row curvature: the CSR, d2, v, Hv and its one sum."""
    return 4 * nnz, WORD * (_slots(n_rows, nnz) + n_rows + 2 * n_features + 1)


def ell_margins(n_slots: int, n_pad: int, n_features: int, n_rows: int,
                use_offsets: bool = False, nnz: int | None = None) -> tuple[int, int]:
    """X.w over the slot-major ELL layout: every slot (value and column,
    padding included), w and one margin a padded row (and the offsets).
    ``nnz`` is the real nonzeros where the caller knows them; the wrapper
    counts every slot, as it cannot look at the data without a fetch."""
    words = 2 * n_slots * n_pad + n_features + n_pad + (n_rows if use_offsets else 0)
    return 2 * (n_slots * n_pad if nnz is None else nnz), WORD * words


def csr_margins_lanes(n_rows: int, nnz: int, n_features: int, lanes: int,
                      offset_words: int = 0) -> tuple[int, int]:
    """G margins over one CSR: the CSR once, W [G, F] and Z [G, N] (and
    ``offset_words`` of offsets: N shared, G*N per lane, 0 without)."""
    words = _slots(n_rows, nnz) + lanes * n_features + lanes * n_rows + offset_words
    return 2 * nnz * lanes, WORD * words


def csc_scatter_lanes(n_rows: int, nnz: int, n_features: int, lanes: int) -> tuple[int, int]:
    """G scatters over one mirror: the mirror once, R [G, N] and the sums
    [G, F]."""
    return 2 * nnz * lanes, WORD * (_slots(n_features, nnz) + lanes * n_rows
                                    + lanes * n_features)


def dense_rows(entities: int, rows: int, k: int, vectors: int = 1) -> tuple[int, int]:
    """``vectors`` batched row products of a dense bucket (``x [E, R, K]``
    against ``[E, K]`` per vector): x once, the vectors, the margins."""
    return (2 * entities * rows * k * vectors,
            WORD * (entities * rows * k + vectors * entities * (k + rows)))


def dense_scatter(entities: int, rows: int, k: int, square: bool = False) -> tuple[int, int]:
    """The batched scatter sum_r per_row[e, r] * x_er (x_er**2 with
    ``square``): x once, the per-row values, the [E, K] sums."""
    products = entities * rows * k
    return ((3 if square else 2) * products,
            WORD * (products + entities * rows + entities * k))


def tiles_traffic(index_words: int, n_slots: int, n_parts: int, lanes: int = 1) -> int:
    """Bytes a tile-index scatter moves beyond its bound: the index but its
    ``start`` array, and ``lanes`` parts a piece written and read again."""
    return WORD * (index_words - n_slots) + 2 * WORD * lanes * n_parts
