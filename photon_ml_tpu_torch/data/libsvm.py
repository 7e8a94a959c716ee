"""LIBSVM text reader.

Counterpart of ``photon_ml_tpu/data/libsvm.py`` (:20-145): parsing is on
the host, by the native parser (``data/native.py``) or the pure-Python
one, into ``LibSVMData``; ``to_batch`` uploads a ``CSRBatch`` (or a
``SparseBatch``) to the device, with the intercept as the last column.
``write_libsvm`` writes COO arrays as fixed-width LIBSVM text, for test and
benchmark data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.native import load_native, parse_libsvm_native
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.sparse import SparseBatch


@dataclasses.dataclass
class LibSVMData:
    """Host COO arrays parsed from LIBSVM text (rows ascending)."""

    values: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    labels: np.ndarray
    num_features: int

    def coo(self, num_features: Optional[int] = None,
            add_intercept: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(values, rows, cols, num_features). With ``add_intercept`` the
        entries are sorted by row and each row's intercept entry follows its
        features, in the last column (``intercept_index``), where the
        reference's stable sort by row puts it."""
        d = int(num_features if num_features is not None else self.num_features)
        values, rows, cols = self.values, self.rows, self.cols
        if add_intercept:
            n = len(self.labels)
            if len(rows) and not np.all(rows[1:] >= rows[:-1]):
                order = np.argsort(rows, kind="stable")
                values, rows, cols = values[order], rows[order], cols[order]
            at = np.searchsorted(rows, np.arange(1, n + 1))
            values = np.insert(values, at, 1.0)
            rows = np.insert(rows, at, np.arange(n, dtype=rows.dtype))
            cols = np.insert(cols, at, d)
            d += 1
        return values, rows, cols, d

    def to_batch(
        self,
        num_features: Optional[int] = None,
        add_intercept: bool = True,
        offsets: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        layout: str = "csr",
        device: torch.device | str | None = None,
    ) -> CSRBatch | SparseBatch:
        """The batch on ``device`` (default cuda): a ``CSRBatch``, or a
        ``SparseBatch`` with ``layout="sparse"``, of ``coo``'s arrays."""
        if layout not in ("csr", "sparse"):
            raise ValueError(f"unknown layout '{layout}'")
        values, rows, cols, d = self.coo(num_features, add_intercept)
        cls = CSRBatch if layout == "csr" else SparseBatch
        return cls.from_coo(values=values, rows=rows, cols=cols, labels=self.labels,
                            num_features=d, offsets=offsets, weights=weights, device=device)

    @property
    def intercept_index(self) -> int:
        """The intercept's column after ``to_batch(add_intercept=True)``."""
        return self.num_features


def read_libsvm(
    path: str,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
    engine: str = "auto",
) -> LibSVMData:
    """Parse a LIBSVM file. Labels {-1, +1} become {0, 1} under
    ``binary_labels_to_01`` (the evaluators expect {0, 1}).

    ``engine``: "auto" uses the native parser when it can be built and the
    Python parser otherwise; "native" raises when it cannot; "python" forces
    the Python parser.
    """
    if engine not in ("auto", "python", "native"):
        raise ValueError(f"unknown engine '{engine}'")
    if engine in ("auto", "native"):
        if load_native() is not None:
            with open(path, "rb") as f:
                parsed = parse_libsvm_native(f.read(), zero_based=zero_based)
            return _finish(*parsed, binary_labels_to_01)
        if engine == "native":
            raise RuntimeError("native parser unavailable (no g++ / build failed)")
    labels: list[float] = []
    rows: list[int] = []
    cols: list[int] = []
    vals: list[float] = []
    max_col = -1
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break
                k, v = tok.split(":")
                c = int(k) - (0 if zero_based else 1)
                if c < 0:
                    raise ValueError(f"negative feature index at line {i}: {tok} "
                                     f"(wrong zero_based setting?)")
                rows.append(len(labels) - 1)
                cols.append(c)
                vals.append(float(v))
                max_col = max(max_col, c)
    return _finish(np.asarray(vals), np.asarray(rows, dtype=np.int64),
                   np.asarray(cols, dtype=np.int64), np.asarray(labels), max_col + 1,
                   binary_labels_to_01)


def _finish(values, rows, cols, y, num_features, binary_labels_to_01) -> LibSVMData:
    """Both engines' tail: the label mapping and the container."""
    if binary_labels_to_01 and set(np.unique(y)).issubset({-1.0, 1.0}):
        y = (y > 0).astype(np.float64)
    return LibSVMData(values=values, rows=rows, cols=cols, labels=y,
                      num_features=num_features)


def _number(out: np.ndarray, x: np.ndarray, width: int, decimals: int) -> tuple:
    """``x`` rounded to ``decimals`` places as fixed-width ASCII into the
    columns of ``out`` [len(x), 2 + width + decimals]: the sign, the integer
    part zero-padded to ``width``, the point and the decimals. Returns the
    rounded magnitudes (in units of the last place) and the signs."""
    scale = 10 ** decimals
    q = np.round(np.abs(np.asarray(x, np.float64)) * scale).astype(np.int64)
    neg = np.signbit(x)
    out[:, 0] = np.where(neg, ord("-"), ord("+"))
    _digits(out[:, 1:1 + width], q // scale)
    out[:, 1 + width] = ord(".")
    _digits(out[:, 2 + width:], q % scale)
    return q, neg


def _digits(out: np.ndarray, x: np.ndarray) -> None:
    """The decimal digits of the non-negative integers ``x``, zero-padded to
    the width of ``out`` [len(x), width], one column at a time."""
    width = out.shape[1]
    for p in range(width):
        out[:, p] = 48 + (x // 10 ** (width - 1 - p)) % 10


def write_libsvm(path: str, values: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                 labels: np.ndarray, decimals: int = 4) -> np.ndarray:
    """Write row-sorted COO (0-based ``cols``) as LIBSVM text with 1-based
    columns and labels and values rounded to ``decimals`` places, and return
    the values as written (float64).

    Every token has a fixed width, so the file is assembled in one uint8
    buffer by integer arithmetic, with no string formatting per token: the
    label as ``+d.dddd``, each feature as `` ccccc:+d.dddd`` with the column
    and the integer part zero-padded to the widest one (both parsers read
    the leading zeros and the ``+``)."""
    rows = np.asarray(rows, np.int64)
    n = len(labels)
    if len(rows) and not np.all(rows[1:] >= rows[:-1]):
        raise ValueError("write_libsvm needs COO sorted by row")
    scale = 10 ** decimals

    def width(x) -> int:
        return len(str(int(np.round(np.max(np.abs(x), initial=0) * scale)) // scale))

    lw, vw = width(labels), width(values)
    cw = len(str(int(np.max(cols, initial=0)) + 1))
    head = np.empty((n, 2 + lw + decimals), np.uint8)
    _number(head, labels, lw, decimals)
    toks = np.empty((len(rows), 4 + cw + vw + decimals), np.uint8)
    toks[:, 0] = ord(" ")
    _digits(toks[:, 1:1 + cw], np.asarray(cols, np.int64) + 1)
    toks[:, 1 + cw] = ord(":")
    vq, vneg = _number(toks[:, 2 + cw:], values, vw, decimals)
    # each line: its label, its tokens, a newline
    line_len = head.shape[1] + np.bincount(rows, minlength=n) * toks.shape[1] + 1
    ends = np.cumsum(line_len)
    buf = np.empty(int(ends[-1]) if n else 0, np.uint8)
    head_at = (ends - line_len)[:, None] + np.arange(head.shape[1])
    is_tok = np.ones(len(buf), bool)
    is_tok[head_at] = False
    is_tok[ends - 1] = False
    buf[head_at] = head
    buf[ends - 1] = ord("\n")
    buf[is_tok] = toks.ravel()
    with open(path, "wb") as f:
        f.write(buf.tobytes())
    return np.where(vneg, -1.0, 1.0) * (vq / scale)
