"""The device mesh and the row-shard layout.

Counterpart of ``photon_ml_tpu/parallel/mesh.py``. A ``Mesh`` is a named-axis
array of explicit ``torch.device``s, driven by one process (the reference's
single-controller mesh, :58-80). ``make_mesh`` defaults to the first N CUDA
devices and raises when fewer are visible; it never reuses a device on its
own. A caller may pass a device list in which a device repeats (``[cpu] * 8``
in the tests, the reference's 8 virtual CPU devices; ``[cuda:0] * 4`` on one
card): such a mesh runs the sharding code, not transfers between cards.

``shard_rows`` splits a ``CSRBatch`` into equal row blocks with local row
indices, each padded with zero-weight rows (the reference's stacked layout,
:83-160), as plain CSR pieces on the batch's device; ``host_row_shards``
cuts the same blocks out of host COO, so a batch that was never uploaded
whole reaches each device as its own block; ``put_sharded`` places piece i
on the i-th device of an axis, where its mirror and tile index are built
(``CSRBatch.from_device_csr``).

A mesh of a multi-process fleet (``multihost.global_mesh``) records which
process owns each position (``owners``): a process addresses only its own
devices, and the other positions name the devices their owners gave.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

DATA_AXIS = "data"
ENTITY_AXIS = "entity"


class Mesh:
    """``devices`` laid out as an array of ``shape`` with one name per axis."""

    def __init__(self, devices: Sequence[torch.device], axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None,
                 owners: Optional[Sequence[int]] = None, process: int = 0):
        devices = [torch.device(d) for d in devices]
        shape = (len(devices),) if shape is None else tuple(int(s) for s in shape)
        if len(axis_names) != len(shape) or math.prod(shape) != len(devices):
            raise ValueError(f"mesh axes {tuple(axis_names)} of sizes {shape} do not lay out "
                             f"{len(devices)} devices")
        self.axis_names = tuple(axis_names)
        self._devices = np.empty(len(devices), dtype=object)
        self._devices[:] = devices
        self._devices = self._devices.reshape(shape)
        # the process of each position (None: every position is this process's)
        self._owners = (None if owners is None
                        else np.asarray(list(owners), np.int64).reshape(shape))
        self.process = int(process)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self._devices.shape))

    @property
    def devices(self) -> np.ndarray:
        """The device array, one dimension per axis."""
        return self._devices

    def device_list(self) -> list[torch.device]:
        return list(self._devices.reshape(-1))

    @property
    def first_device(self) -> torch.device:
        """Where the solver state lives and the partials are summed."""
        return self._devices.reshape(-1)[0]

    def axis_devices(self, axis: str) -> tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis: shard i
        of a placement over ``axis`` lives on the i-th (the other axes hold
        replicas, which one process does not need twice)."""
        i = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        index[i] = slice(None)
        return tuple(self._devices[tuple(index)])

    def key(self) -> tuple:
        """Axis names, sizes and devices: equal for meshes that place alike."""
        owners = None if self._owners is None else tuple(self._owners.reshape(-1).tolist())
        return (self.axis_names, self._devices.shape, tuple(str(d) for d in self.device_list()),
                owners)

    @property
    def is_multiprocess(self) -> bool:
        return self._owners is not None and bool((self._owners != self.process).any())

    def axis_owners(self, axis: str) -> tuple[int, ...]:
        """The process of each position along ``axis`` (``axis_devices``'s)."""
        n = self.shape[axis]
        if self._owners is None:
            return (self.process,) * n
        i = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        index[i] = slice(None)
        return tuple(int(p) for p in self._owners[tuple(index)])

    def device_owners(self) -> list[int]:
        """The process of each device of ``device_list``."""
        if self._owners is None:
            return [self.process] * self._devices.size
        return [int(p) for p in self._owners.reshape(-1)]

    def local_positions(self, axis: str) -> list[int]:
        """The positions along ``axis`` whose device this process drives."""
        return [i for i, p in enumerate(self.axis_owners(axis)) if p == self.process]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list()]})"


def make_mesh(axis_sizes: Optional[dict[str, int]] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh of ``axis_sizes`` (default: one ``data`` axis over every CUDA
    device) over ``devices`` (default: the first N CUDA devices)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if axis_sizes is None:
            axis_sizes = {DATA_AXIS: count}
        total = math.prod(int(s) for s in axis_sizes.values())
        if total > count or total < 1:
            raise ValueError(f"mesh {dict(axis_sizes)} needs {total} devices, have {count} "
                             "CUDA device(s); pass devices= to lay a mesh over others")
        devices = [torch.device("cuda", i) for i in range(total)]
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: len(devices)}
    total = math.prod(int(s) for s in axis_sizes.values())
    if total != len(devices):
        raise ValueError(f"mesh {dict(axis_sizes)} needs {total} devices, have {len(devices)}")
    return Mesh(devices, tuple(axis_sizes), tuple(int(s) for s in axis_sizes.values()))


class RowShard(NamedTuple):
    """One row block of a batch as a plain CSR with local row indices:
    ``row_ptr`` [rows + 1], ``cols``/``vals`` [nnz], and the per-row arrays
    [rows], padding rows included (no nonzeros, weight 0)."""

    row_ptr: Tensor
    cols: Tensor
    vals: Tensor
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    num_features: int


def rows_per_shard(num_rows: int, num_shards: int) -> int:
    return -(-int(num_rows) // int(num_shards))


def pad_rows(per_row: Tensor, total: int) -> Tensor:
    """``per_row`` padded with zeros to ``total`` entries."""
    if per_row.shape[0] == total:
        return per_row
    return torch.cat([per_row, per_row.new_zeros(total - per_row.shape[0])])


def shard_rows(batch, num_shards: int) -> list[RowShard]:
    """Split a ``CSRBatch`` into ``num_shards`` equal contiguous row blocks
    with local row indices, on the batch's device. The last blocks are
    padded with zero-weight rows that hold no nonzeros, so every kernel
    reads them as inert."""
    n = batch.num_rows
    per = rows_per_shard(n, num_shards)
    ptr = batch.row_ptr.long()
    bounds = [min(s * per, n) for s in range(num_shards + 1)]
    starts = ptr[torch.tensor(bounds, device=ptr.device)].tolist()  # one fetch
    shards = []
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        a, b = starts[s], starts[s + 1]
        local = ptr[lo:hi + 1] - a
        local = torch.cat([local, local[-1:].expand(per - (hi - lo))])
        shards.append(RowShard(
            row_ptr=local.to(torch.int32), cols=batch.cols[a:b], vals=batch.vals[a:b],
            labels=pad_rows(batch.labels[lo:hi], per),
            offsets=pad_rows(batch.offsets[lo:hi], per),
            weights=pad_rows(batch.weights[lo:hi], per),
            num_features=batch.num_features))
    return shards


def host_row_shards(values: np.ndarray, rows: np.ndarray, cols: np.ndarray, labels,
                    offsets, weights, num_features: int, num_shards: int) -> list[RowShard]:
    """``shard_rows`` over host COO sorted by row: each equal row block as a
    CPU ``RowShard``, read from the host arrays alone."""
    n = len(labels)
    per = rows_per_shard(n, num_shards)
    rows = np.asarray(rows, np.int64)
    cuts = np.searchsorted(rows, [min(s * per, n) for s in range(num_shards + 1)])
    out = []
    for s in range(num_shards):
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        a, b = int(cuts[s]), int(cuts[s + 1])
        ptr = np.zeros(per + 1, np.int64)
        np.cumsum(np.bincount(rows[a:b] - lo, minlength=per), out=ptr[1:])

        def block(v):
            return pad_rows(torch.from_numpy(np.asarray(v[lo:hi], np.float64)
                                             .astype(np.float32)), per)

        out.append(RowShard(
            row_ptr=torch.from_numpy(ptr.astype(np.int32)),
            cols=torch.from_numpy(np.asarray(cols[a:b], np.int32)),
            vals=torch.from_numpy(np.asarray(values[a:b], np.float32)),
            labels=block(labels), offsets=block(offsets), weights=block(weights),
            num_features=int(num_features)))
    return out


def put_sharded(shards: Sequence[RowShard], mesh: Mesh, axis: str = DATA_AXIS,
                num_rows: Optional[int] = None):
    """Place row shard i on the i-th device of ``axis``, where its mirror and
    tile index are built; a ``ShardedBatch`` of ``num_rows`` real rows
    (default: every row, padding included)."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch
    from photon_ml_tpu_torch.parallel.sharding import ShardedBatch

    devices = mesh.axis_devices(axis)
    if len(shards) != len(devices):
        raise ValueError(f"{len(shards)} row shards for the {len(devices)}-device '{axis}' axis")
    placed = []
    for s, dev in zip(shards, devices):
        placed.append(CSRBatch.from_device_csr(
            s.row_ptr.to(dev), s.cols.to(dev), s.vals.to(dev), s.labels.to(dev), s.num_features,
            offsets=s.offsets.to(dev), weights=s.weights.to(dev)))
    rows = sum(int(s.labels.shape[0]) for s in shards) if num_rows is None else int(num_rows)
    return ShardedBatch(shards=tuple(placed), num_rows=rows, mesh=mesh, axis=axis)
