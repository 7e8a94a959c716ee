"""Wrappers of the Hopper kernels (``csrc/``), each with a launch count.

On a CPU tensor a wrapper runs the kernel's plain PyTorch version
(``kernels.reference``); on a CUDA tensor it launches the hand-written kernel
on the current stream or raises. There is no fallback from one to the other.
Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernels.

The fused passes (``margins_pair``, ``value_grad``, ``hv``, ``hv_at``) take
the CSR as ``csr = (row_ptr, cols, vals)`` and its mirror as
``csc = (col_ptr, rows, vals)``. One call of ``value_grad``, ``hv`` or
``hv_at`` is one C call and counts once, under its own name: each is the
tile-fused kernel (``csrc/tile_fused.cuh``: the row pass and the scatter of
each row tile in one launch) and its finish. The scatter and
the passes that end with it take ``tiles``, the row-tile index of a
``CSRBatch`` (``ScatterTiles``, built by ``ops/csr.py``), which the CUDA
kernels need: they stage per_row by row tiles in shared memory and walk the
non-empty (tile, feature) segments of a mirror held in the index's slot
order. Where ``tiles`` are given on the CPU, the plain versions read the
mirror through ``column_major``. ``ell_margins`` takes the slot-major ELL
layout of ``ops/ell.py``.

The lane kernels (``csr_margins_lanes``, ``csc_scatter_lanes``) are the
margins and the scatter for G vectors over one design (``W [G, F]``,
``R [G, N]``), the written-out ``vmap`` of a sweep or a bootstrap: one C
call reads the design from device memory once per 16 lanes, and each lane
comes out bit for bit as the single-vector kernel gives it for that lane's
vector.

Each wrapper is an instrumented executable under its launch-count name
(``telemetry/executables.py``): its calls are counted and sampled by the
profiler, and each call reports its modelled work from ``kernels/cost.py``
(on the CPU too: the cost is the function's, not the implementation's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from photon_ml_tpu_torch.kernels import cost, reference
from photon_ml_tpu_torch.kernels.build import load_library
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.telemetry.executables import account, instrumented
from photon_ml_tpu_torch.telemetry.profile import launch_window

Tensor = torch.Tensor

LAUNCHES: dict[str, int] = {
    "csr_margins": 0,
    "csc_scatter": 0,
    "margins_pair": 0,
    "value_grad": 0,
    "hv": 0,
    "hv_at": 0,
    "ell_margins": 0,
    "csr_margins_lanes": 0,
    "csc_scatter_lanes": 0,
}

# the loss codes of csrc/losses.cuh
LOSS_CODES = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}
_HV_LOSSES = ("logistic", "squared", "poisson")

# capacity of the block-partials scratch; the row pass and the tile-fused
# kernel launch at most the resident block count (at most 4 blocks of 512
# threads on each of 132 SMs)
_MAX_BLOCKS = 2048

_INT_ARGS = ("row_ptr", "cols", "col_ptr", "rows", "ell_cols", "tile_index")


class ScatterTiles(NamedTuple):
    """The CSC scatter's row-tile index (``ops/csr.py`` ``scatter_tiles``):
    its int32 arrays one after another on the batch's device, the tile and
    piece sizes it was built for, and its slot, piece and part counts."""

    index: Tensor
    tile_rows: int
    piece_len: int
    n_slots: int
    n_pieces: int
    n_parts: int


def column_major(csc: tuple[Tensor, Tensor, Tensor],
                 tiles: ScatterTiles | None) -> tuple[Tensor, Tensor, Tensor]:
    """The mirror ``csc`` = (col_ptr, rows, vals), laid out as ``tiles``
    say, in column-major order (columns ascending, then rows), on its device.

    The index lists each feature's parts in (tile, piece) order, so sorting
    the non-empty slots by the place of their first part (``part_at``) puts
    the segments in column-major order; a segment of slot s is the run of
    ``off[s + 1] - off[s]`` entries from ``start[s]``."""
    if tiles is None:
        return csc
    col_ptr, rows, vals = csc
    ix, slots = tiles.index.long(), tiles.n_slots
    start, off = ix[:slots], ix[slots:2 * slots + 1]
    part_at = ix[ix.numel() - slots:]
    lengths = off[1:] - off[:-1]
    order = torch.argsort(torch.where(lengths > 0, part_at, -1), stable=True)
    lengths, start = lengths[order], start[order]
    before = torch.cumsum(lengths, 0) - lengths
    perm = torch.repeat_interleave(start - before, lengths, output_size=rows.numel())
    perm += torch.arange(rows.numel(), device=perm.device)
    return col_ptr, rows[perm], vals[perm]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _group_size(count: int, groups: int) -> int:
    """The power of two >= ceil(count / groups), at most 32 (a warp): the
    lanes the scatter's finish gives one feature, for ``count`` parts over
    ``groups`` features."""
    mean = -(-count // max(groups, 1))
    g = 1
    while g < mean and g < 32:
        g *= 2
    return g


def _check(name: str, device: torch.device, **tensors: Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        want = torch.int32 if arg in _INT_ARGS else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _raise_on(name: str, lib, rc: int) -> None:
    if rc != 0:
        msg = lib.photon_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _on_cuda(name: str, dev: torch.device) -> bool:
    """True for a CUDA device, False for the CPU (plain version); else raise."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _shift_args(name: str, dev: torch.device, shift: Tensor | float):
    """(device pointer or None, host float) for a shift that is a one-element
    device tensor or a host number; the kernel adds the two."""
    if isinstance(shift, Tensor):
        _check(name, dev, shift=shift)
        if shift.numel() != 1:
            raise ValueError(f"{name}: shift must hold one element")
        return shift.data_ptr(), 0.0
    return None, float(shift)


def _check_fused(name, dev, csr, csc, n_features, **per_row_and_tables) -> int:
    """Check the two layouts and the per-row / per-feature tensors; return
    the row count."""
    (row_ptr, cols, vals), (col_ptr, rows, csc_vals) = csr, csc
    _check(name, dev, row_ptr=row_ptr, cols=cols, vals=vals, col_ptr=col_ptr, rows=rows,
           csc_vals=csc_vals, **per_row_and_tables)
    n, nnz = row_ptr.numel() - 1, vals.numel()
    if cols.numel() != nnz or rows.numel() != nnz or csc_vals.numel() != nnz:
        raise ValueError(f"{name}: inconsistent slot counts")
    for arg, t in per_row_and_tables.items():
        want = n_features if arg in ("w", "v") else n
        if t.dim() != 1 or t.numel() != want:
            raise ValueError(f"{name}: {arg} must have shape ({want},), got {tuple(t.shape)}")
    return n


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


@instrumented(name="csr_margins")
def csr_margins(
    row_ptr: Tensor,
    cols: Tensor,
    vals: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """Per-row margins of a CSR matrix: sum_k vals_k*w[cols_k] + shift (+offsets)."""
    dev = row_ptr.device
    work = cost.csr_margins(row_ptr.numel() - 1, vals.numel(), w.numel(), use_offsets)
    if not _on_cuda("csr_margins", dev):
        out = reference.csr_margins(row_ptr, cols, vals, w, offsets, shift, use_offsets)
        account(*work)
        return out
    n = row_ptr.numel() - 1
    _check("csr_margins", dev, row_ptr=row_ptr, cols=cols, vals=vals, w=w, offsets=offsets)
    if cols.numel() != vals.numel() or offsets.numel() != n or w.dim() != 1:
        raise ValueError("csr_margins: inconsistent shapes")
    shift_ptr, shift_host = _shift_args("csr_margins", dev, shift)
    lib = load_library()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("csr_margins"):
        rc = lib.photon_csr_margins(
            row_ptr.data_ptr(),
            cols.data_ptr(),
            vals.data_ptr(),
            w.data_ptr(),
            offsets.data_ptr() if use_offsets else None,
            shift_ptr,
            shift_host,
            out.data_ptr(),
            n,
            w.numel(),
            _stream(dev),
        )
    _raise_on("csr_margins", lib, rc)
    LAUNCHES["csr_margins"] += 1
    account(*work)
    return out


@instrumented(name="ell_margins")
def ell_margins(
    vals: Tensor,
    cols: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """Per-row margins of a slot-major ELL layout (``vals``/``cols``
    ``[S, n_pad]``, n_pad a multiple of 128): sum_s vals[s,r]*w[cols[s,r]] +
    shift (+ offsets) for the n = len(offsets) real rows."""
    dev = vals.device
    work = cost.ell_margins(*vals.shape, w.numel(), offsets.numel(), use_offsets)
    if not _on_cuda("ell_margins", dev):
        out = reference.ell_margins(vals, cols, w, offsets, shift, use_offsets)
        account(*work)
        return out
    _check("ell_margins", dev, ell_cols=cols, vals=vals, w=w, offsets=offsets)
    n = offsets.numel()
    if (vals.dim() != 2 or cols.shape != vals.shape or w.dim() != 1
            or vals.shape[1] % 128 != 0 or vals.shape[1] < n):
        raise ValueError("ell_margins: vals and cols must be [S, n_pad] with n_pad a "
                         "multiple of 128 and >= len(offsets); w must be 1-D")
    shift_ptr, shift_host = _shift_args("ell_margins", dev, shift)
    lib = load_library()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("ell_margins"):
        rc = lib.photon_ell_margins(
            vals.data_ptr(), cols.data_ptr(), w.data_ptr(),
            offsets.data_ptr() if use_offsets else None, shift_ptr, shift_host,
            out.data_ptr(), n, vals.shape[1], vals.shape[0], w.numel(), _stream(dev),
        )
    _raise_on("ell_margins", lib, rc)
    LAUNCHES["ell_margins"] += 1
    account(*work)
    return out


def _scatter_args(name, dev, tiles: ScatterTiles | None, n_rows: int, n_features: int):
    """The scatter's C arguments (tile_index, n_slots, n_pieces,
    finish_width, tile_rows, piece_len) and ``part``, its scratch of one
    float per part."""
    if tiles is None:
        raise ValueError(f"{name}: the CUDA scatter needs the batch's tile index "
                         "(CSRBatch.tiles, built by from_coo on a CUDA device)")
    _check(name, dev, tile_index=tiles.index)
    n_tiles = -(-n_rows // tiles.tile_rows) if tiles.tile_rows > 0 else -1
    size = 3 * tiles.n_slots + n_tiles + tiles.n_slots // 32 + n_features + tiles.n_pieces + 4
    if (n_tiles < 0 or tiles.piece_len <= 0 or tiles.n_slots % 32
            or tiles.index.numel() != size):
        raise ValueError(f"{name}: the tile index does not fit {n_rows} rows in tiles of "
                         f"{tiles.tile_rows} and {n_features} features")
    part = torch.empty(tiles.n_parts, dtype=torch.float32, device=dev)
    return (tiles.index.data_ptr(), tiles.n_slots, tiles.n_pieces,
            _group_size(tiles.n_parts, n_features), tiles.tile_rows, tiles.piece_len), part


@instrumented(name="csc_scatter")
def csc_scatter(
    col_ptr: Tensor,
    rows: Tensor,
    vals: Tensor,
    per_row: Tensor,
    square: bool,
    tiles: ScatterTiles | None = None,
) -> Tensor:
    """Feature-space scatter sum_i per_row[i]*x_i (x_i**2 with ``square``);
    on a CUDA device ``tiles`` is the batch's tile index (module docstring)."""
    dev = col_ptr.device
    work = cost.csc_scatter(per_row.numel(), vals.numel(), col_ptr.numel() - 1)
    if not _on_cuda("csc_scatter", dev):
        out = reference.csc_scatter(*column_major((col_ptr, rows, vals), tiles), per_row,
                                    square)
        account(*work)
        return out
    n_features = col_ptr.numel() - 1
    _check("csc_scatter", dev, col_ptr=col_ptr, rows=rows, vals=vals, per_row=per_row)
    if rows.numel() != vals.numel() or per_row.dim() != 1:
        raise ValueError("csc_scatter: inconsistent shapes")
    n = per_row.numel()
    index_args, part = _scatter_args("csc_scatter", dev, tiles, n, n_features)
    lib = load_library()
    out = torch.empty(n_features, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("csc_scatter"):
        rc = lib.photon_csc_scatter(
            rows.data_ptr(), vals.data_ptr(), *index_args, per_row.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, n_features, int(square), _stream(dev),
        )
    _raise_on("csc_scatter", lib, rc)
    LAUNCHES["csc_scatter"] += 1
    account(*work)
    return out


@instrumented(name="margins_pair")
def margins_pair(
    csr: tuple[Tensor, Tensor, Tensor],
    w: Tensor,
    p: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    p_shift: Tensor | float,
) -> tuple[Tensor, Tensor]:
    """(X.w + shift + offsets, X.p + p_shift) from one read of the slots."""
    row_ptr, cols, vals = csr
    dev = row_ptr.device
    work = cost.margins_pair(row_ptr.numel() - 1, vals.numel(), w.numel())
    if not _on_cuda("margins_pair", dev):
        out = reference.margins_pair(csr, w, p, offsets, shift, p_shift)
        account(*work)
        return out
    n = row_ptr.numel() - 1
    _check("margins_pair", dev, row_ptr=row_ptr, cols=cols, vals=vals, w=w, p=p,
           offsets=offsets)
    if (cols.numel() != vals.numel() or offsets.numel() != n or w.dim() != 1
            or p.shape != w.shape):
        raise ValueError("margins_pair: inconsistent shapes")
    s0_ptr, s0_host = _shift_args("margins_pair", dev, shift)
    s1_ptr, s1_host = _shift_args("margins_pair", dev, p_shift)
    lib = load_library()
    z = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("margins_pair"):
        rc = lib.photon_margins_pair(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
            p.data_ptr(), offsets.data_ptr(), s0_ptr, s0_host, s1_ptr, s1_host,
            z.data_ptr(), u.data_ptr(), n, w.numel(), _stream(dev),
        )
    _raise_on("margins_pair", lib, rc)
    LAUNCHES["margins_pair"] += 1
    account(*work)
    return z, u


def _sums_scratch(n_sums: int, dev: torch.device):
    """(block partials, sums) buffers of one fused pass."""
    return (torch.empty(_MAX_BLOCKS * n_sums, dtype=torch.float32, device=dev),
            torch.empty(n_sums, dtype=torch.float32, device=dev))


@instrumented(name="value_grad")
def value_grad(
    csr: tuple[Tensor, Tensor, Tensor],
    csc: tuple[Tensor, Tensor, Tensor],
    labels: Tensor,
    weights: Tensor,
    offsets: Tensor,
    w: Tensor,
    shift: Tensor | float,
    loss_name: str,
    tiles: ScatterTiles | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """(sum wgt*l(z), raw gradient sum_i wgt*l'(z_i)*x_i, sum wgt*l'(z)) at
    z = X.w + shift + offsets, in one fused pass (0-d device sums)."""
    loss = get_loss(loss_name).name
    dev = csr[0].device
    work = cost.value_grad(csr[0].numel() - 1, csr[2].numel(), csc[0].numel() - 1)
    if not _on_cuda("value_grad", dev):
        out = reference.value_grad(csr, column_major(csc, tiles), labels, weights, offsets,
                                   w, shift, loss)
        account(*work)
        return out
    n_features = csc[0].numel() - 1
    n = _check_fused("value_grad", dev, csr, csc, n_features, labels=labels,
                     weights=weights, offsets=offsets, w=w)
    s_ptr, s_host = _shift_args("value_grad", dev, shift)
    index_args, part = _scatter_args("value_grad", dev, tiles, n, n_features)
    lib = load_library()
    partials, sums = _sums_scratch(2, dev)
    grad = torch.empty(n_features, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("value_grad"):
        rc = lib.photon_value_grad(
            *(t.data_ptr() for t in (*csr, *csc[1:], labels, weights, offsets, w)),
            s_ptr, s_host, LOSS_CODES[loss], partials.data_ptr(), _MAX_BLOCKS, sums.data_ptr(),
            grad.data_ptr(), *index_args, part.data_ptr(), n, n_features, _stream(dev),
        )
    _raise_on("value_grad", lib, rc)
    LAUNCHES["value_grad"] += 1
    account(*work)
    return sums[0], grad, sums[1]


@instrumented(name="hv")
def hv(
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
    tiles: ScatterTiles | None = None,
) -> tuple[Tensor, Tensor]:
    """(raw Hv sum_i q_i*x_i, sum q) with q = wgt*l''(X.w + shift + offsets)*
    (X.v + v_shift), in one fused pass (0-d device sum)."""
    loss = get_loss(loss_name).name
    if loss not in _HV_LOSSES:
        raise ValueError(f"hv: '{loss}' is not twice differentiable")
    dev = csr[0].device
    work = cost.hv(csr[0].numel() - 1, csr[2].numel(), csc[0].numel() - 1)
    if not _on_cuda("hv", dev):
        out = reference.hessian_vector(csr, column_major(csc, tiles), labels, weights,
                                       offsets, w, shift, v, v_shift, loss)
        account(*work)
        return out
    n_features = csc[0].numel() - 1
    n = _check_fused("hv", dev, csr, csc, n_features, labels=labels, weights=weights,
                     offsets=offsets, w=w, v=v)
    s0_ptr, s0_host = _shift_args("hv", dev, shift)
    s1_ptr, s1_host = _shift_args("hv", dev, v_shift)
    index_args, part = _scatter_args("hv", dev, tiles, n, n_features)
    lib = load_library()
    partials, sums = _sums_scratch(1, dev)
    out = torch.empty(n_features, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("hv"):
        rc = lib.photon_hessian_vector(
            *(t.data_ptr() for t in (*csr, *csc[1:], labels, weights, offsets, w, v)),
            s0_ptr, s0_host, s1_ptr, s1_host, LOSS_CODES[loss], partials.data_ptr(),
            _MAX_BLOCKS, sums.data_ptr(), out.data_ptr(), *index_args, part.data_ptr(), n,
            n_features, _stream(dev),
        )
    _raise_on("hv", lib, rc)
    LAUNCHES["hv"] += 1
    account(*work)
    return out, sums[0]


@instrumented(name="hv_at")
def hv_at(
    csr: tuple[Tensor, Tensor, Tensor],
    csc: tuple[Tensor, Tensor, Tensor],
    d2: Tensor,
    v: Tensor,
    v_shift: Tensor | float,
    tiles: ScatterTiles | None = None,
) -> tuple[Tensor, Tensor]:
    """(raw Hv sum_i q_i*x_i, sum q) with q = d2*(X.v + v_shift) for a row
    curvature d2 computed once per TRON step (0-d device sum)."""
    dev = csr[0].device
    work = cost.hv_at(csr[0].numel() - 1, csr[2].numel(), csc[0].numel() - 1)
    if not _on_cuda("hv_at", dev):
        out = reference.hv_at(csr, column_major(csc, tiles), d2, v, v_shift)
        account(*work)
        return out
    n_features = csc[0].numel() - 1
    n = _check_fused("hv_at", dev, csr, csc, n_features, d2=d2, v=v)
    s_ptr, s_host = _shift_args("hv_at", dev, v_shift)
    index_args, part = _scatter_args("hv_at", dev, tiles, n, n_features)
    lib = load_library()
    partials, sums = _sums_scratch(1, dev)
    out = torch.empty(n_features, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("hv_at"):
        rc = lib.photon_hv_at(
            *(t.data_ptr() for t in (*csr, *csc[1:], d2, v)),
            s_ptr, s_host, partials.data_ptr(), _MAX_BLOCKS, sums.data_ptr(), out.data_ptr(),
            *index_args, part.data_ptr(), n, n_features, _stream(dev),
        )
    _raise_on("hv_at", lib, rc)
    LAUNCHES["hv_at"] += 1
    account(*work)
    return out, sums[0]


def _lane_shift_args(name: str, dev: torch.device, shift: Tensor | float, n_lanes: int):
    """(device pointer or None, host float) for a per-lane shift, a ``[G]``
    device tensor, or one host number for every lane."""
    if isinstance(shift, Tensor):
        _check(name, dev, shift=shift)
        if shift.shape != (n_lanes,):
            raise ValueError(f"{name}: shift must be [{n_lanes}], got {tuple(shift.shape)}")
        return shift.data_ptr(), 0.0
    return None, float(shift)


@instrumented(name="csr_margins_lanes")
def csr_margins_lanes(
    row_ptr: Tensor,
    cols: Tensor,
    vals: Tensor,
    w: Tensor,
    offsets: Tensor,
    shift: Tensor | float,
    use_offsets: bool,
) -> Tensor:
    """Per-row margins of one CSR matrix for each of G vectors ``w [G, F]``:
    ``Z[g] = X.w[g] + shift[g] (+ offsets[g])`` as ``[G, N]``. ``offsets``
    is ``[G, N]`` or one ``[N]`` for every lane; ``shift`` is a ``[G]``
    tensor or one number."""
    dev = row_ptr.device
    if w.dim() != 2:
        raise ValueError(f"csr_margins_lanes: w must be [G, F], got {tuple(w.shape)}")
    n, n_lanes = row_ptr.numel() - 1, w.shape[0]
    if use_offsets and offsets.shape not in ((n,), (n_lanes, n)):
        raise ValueError(f"csr_margins_lanes: offsets must be [{n}] or [{n_lanes}, {n}], "
                         f"got {tuple(offsets.shape)}")
    if isinstance(shift, Tensor) and shift.shape != (n_lanes,):
        raise ValueError(f"csr_margins_lanes: shift must be [{n_lanes}], got "
                         f"{tuple(shift.shape)}")
    work = cost.csr_margins_lanes(n, vals.numel(), w.shape[1], n_lanes,
                                  offsets.numel() if use_offsets else 0)
    if not _on_cuda("csr_margins_lanes", dev):
        out = reference.csr_margins_lanes(row_ptr, cols, vals, w, offsets, shift, use_offsets)
        account(*work)
        return out
    _check("csr_margins_lanes", dev, row_ptr=row_ptr, cols=cols, vals=vals, w=w,
           offsets=offsets)
    if cols.numel() != vals.numel():
        raise ValueError("csr_margins_lanes: inconsistent shapes")
    shift_ptr, shift_host = _lane_shift_args("csr_margins_lanes", dev, shift, n_lanes)
    lib = load_library()
    out = torch.empty((n_lanes, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("csr_margins_lanes"):
        rc = lib.photon_csr_margins_lanes(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), w.data_ptr(),
            offsets.data_ptr() if use_offsets else None, int(offsets.dim() == 2),
            shift_ptr, shift_host, out.data_ptr(), n, w.shape[1], n_lanes, _stream(dev),
        )
    _raise_on("csr_margins_lanes", lib, rc)
    LAUNCHES["csr_margins_lanes"] += 1
    account(*work)
    return out


@instrumented(name="csc_scatter_lanes")
def csc_scatter_lanes(
    col_ptr: Tensor,
    rows: Tensor,
    vals: Tensor,
    per_row: Tensor,
    square: bool,
    tiles: ScatterTiles | None = None,
) -> Tensor:
    """Feature-space scatter of each of G per-row vectors ``per_row [G, N]``:
    ``Out[g] = sum_i per_row[g, i] * x_i`` (x_i**2 with ``square``) as
    ``[G, F]``; on a CUDA device ``tiles`` is the batch's tile index."""
    dev = col_ptr.device
    if per_row.dim() != 2:
        raise ValueError(f"csc_scatter_lanes: per_row must be [G, N], got "
                         f"{tuple(per_row.shape)}")
    work = cost.csc_scatter_lanes(per_row.shape[1], vals.numel(), col_ptr.numel() - 1,
                                  per_row.shape[0])
    if not _on_cuda("csc_scatter_lanes", dev):
        out = reference.csc_scatter_lanes(*column_major((col_ptr, rows, vals), tiles),
                                          per_row, square)
        account(*work)
        return out
    n_features = col_ptr.numel() - 1
    _check("csc_scatter_lanes", dev, col_ptr=col_ptr, rows=rows, vals=vals, per_row=per_row)
    if rows.numel() != vals.numel():
        raise ValueError("csc_scatter_lanes: inconsistent shapes")
    n_lanes, n = per_row.shape
    (index, n_slots, n_pieces, width, tile_rows, piece_len), _ = _scatter_args(
        "csc_scatter_lanes", dev, tiles, n, n_features)
    lib = load_library()
    # the parts lane-minor, the lanes rounded up to the kernel's groups of 4
    part = torch.empty((tiles.n_parts, -(-n_lanes // 4) * 4), dtype=torch.float32, device=dev)
    out = torch.empty((n_lanes, n_features), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), launch_window("csc_scatter_lanes"):
        rc = lib.photon_csc_scatter_lanes(
            rows.data_ptr(), vals.data_ptr(), index, n_slots, n_pieces, width, tile_rows,
            piece_len, tiles.n_parts, per_row.data_ptr(), out.data_ptr(), part.data_ptr(), n,
            n_features, n_lanes, int(square), _stream(dev),
        )
    _raise_on("csc_scatter_lanes", lib, rc)
    LAUNCHES["csc_scatter_lanes"] += 1
    account(*work)
    return out
