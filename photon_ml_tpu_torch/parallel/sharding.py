"""Named axes, placement over a mesh, and the fixed-order reduction.

Counterpart of ``photon_ml_tpu/parallel/sharding.py:38-388``:

  - axis ``batch`` (legacy ``data``): examples sharded for the data-parallel
    fixed-effect solve; ``place_batch`` gives each device its own
    ``CSRBatch`` of a contiguous row block (a ``ShardedBatch``);
  - axis ``model`` (legacy ``entity``): per-entity state, split into
    contiguous row blocks, one per device (``place_entities``,
    ``place_entity_rows``, an ``EntityShards``).

The reference's ``psum`` becomes ``ShardedBatch.reduce``: each shard's
partial is copied to the mesh's first device and the partials are summed
there in shard order, so the sum is the same bits on every run and the one
copy of the solver state takes every decision once. A sum of one partial is
that partial. No float atomics, and no NCCL: its single-process all-reduce
refuses a device that repeats.

``valid_entity_axis_sizes``, ``entity_axis_mismatch``, ``member_row_range``
and ``owner_of_row`` are the reference's ownership arithmetic, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENTITY_AXIS,
    Mesh,
    RowShard,
    host_row_shards,
    pad_rows,
    put_sharded,
    rows_per_shard,
    shard_rows,
)
from photon_ml_tpu_torch.telemetry.executables import instrumented

Tensor = torch.Tensor

BATCH_AXIS = "batch"
MODEL_AXIS = "model"

#: axis names taken as the example (row) axis, then as the entity axis, most
#: preferred first; "data" and "entity" are the legacy 1-D spellings
_DATA_AXES = (BATCH_AXIS, DATA_AXIS)
_MODEL_AXES = (MODEL_AXIS, ENTITY_AXIS)


def data_axis(mesh: Mesh) -> Optional[str]:
    """The mesh's example axis (``batch``/``data``), or None."""
    return next((a for a in _DATA_AXES if a in mesh.axis_names), None)


def model_axis(mesh: Mesh) -> Optional[str]:
    """The mesh's entity axis (``model``/``entity``), or None."""
    return next((a for a in _MODEL_AXES if a in mesh.axis_names), None)


def axis_size(mesh: Mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def pad_count(n: int, shards: int) -> int:
    """The smallest multiple of ``shards`` that is >= ``n``."""
    return -(-int(n) // int(shards)) * int(shards)


def _resolve(mesh: Mesh, axis: Optional[str], find, what: str) -> str:
    axis = axis or find(mesh)
    if axis is None:
        raise ValueError(f"mesh {mesh.shape} has no {what} axis to shard over")
    return axis


class RowShards(tuple):
    """Per-row values of a ``ShardedBatch``: one tensor a shard, on the
    shard's device. ``+`` adds shard by shard (TRON's trial margins)."""

    def __add__(self, other):
        return RowShards(a + b for a, b in zip(self, other))


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """A design's rows split over a mesh axis: shard i is a ``CSRBatch`` of
    ``rows_per_shard`` rows on the axis's i-th device, the last padded with
    zero-weight rows; ``num_rows`` counts the real rows."""

    shards: tuple
    num_rows: int
    mesh: Mesh
    axis: str

    @staticmethod
    def whole(batch) -> "ShardedBatch":
        """``batch`` as the one shard of a one-device mesh: every broadcast
        is the value itself and every reduction the one partial, so the
        sharded adapter computes exactly what the batch alone gives."""
        return ShardedBatch(shards=(batch,), num_rows=batch.num_rows,
                            mesh=Mesh([batch.device], (DATA_AXIS,)), axis=DATA_AXIS)

    @property
    def num_features(self) -> int:
        return self.shards[0].num_features

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].num_rows

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(b.device for b in self.shards)

    @property
    def device(self) -> torch.device:
        """The first shard's device, where the reductions land."""
        return self.shards[0].device

    @property
    def labels(self) -> RowShards:
        return RowShards(b.labels for b in self.shards)

    @property
    def weights(self) -> RowShards:
        return RowShards(b.weights for b in self.shards)

    def broadcast(self, t):
        """A copy of ``t`` (a tensor or a number) on every shard's device."""
        if not isinstance(t, Tensor):
            return (t,) * len(self.shards)
        return tuple(t.to(d) for d in self.devices)

    def reduce(self, parts: Sequence[Tensor]) -> Tensor:
        """The partials summed on the first device, in shard order."""
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        return acc

    def each(self, fn: Callable, *per_shard) -> list:
        """``fn(shard_batch, *args)`` per shard, with the i-th element of
        every argument sequence."""
        return [fn(b, *args) for b, *args in zip(self.shards, *per_shard)]

    def split_rows(self, per_row: Tensor) -> tuple[Tensor, ...]:
        """A global [num_rows] vector as each shard's padded slice, on its
        device."""
        per = self.rows_per_shard
        out = []
        for i, dev in enumerate(self.devices):
            piece = per_row[min(i * per, self.num_rows):min((i + 1) * per, self.num_rows)]
            out.append(pad_rows(piece.to(device=dev, dtype=torch.float32), per).contiguous())
        return tuple(out)

    def with_offsets(self, offsets: Tensor) -> "ShardedBatch":
        """Offsets re-placed into each shard; the designs are kept."""
        return dataclasses.replace(self, shards=tuple(
            b.with_offsets(o) for b, o in zip(self.shards, self.split_rows(offsets))))

    def with_weights(self, weights: Tensor) -> "ShardedBatch":
        return dataclasses.replace(self, shards=tuple(
            dataclasses.replace(b, weights=w)
            for b, w in zip(self.shards, self.split_rows(weights))))


def as_sharded(batch, mesh: Optional[Mesh] = None, axis: Optional[str] = None) -> ShardedBatch:
    """``batch`` split over ``axis`` of ``mesh``: a ``ShardedBatch`` as it
    is, the stacked layout placed, a ``CSRBatch`` placed by rows; without a
    mesh, the batch as one shard (``ShardedBatch.whole``)."""
    if isinstance(batch, ShardedBatch):
        return batch
    if mesh is None:
        return ShardedBatch.whole(batch)
    if isinstance(batch, (list, tuple)) and batch and isinstance(batch[0], RowShard):
        return put_sharded(batch, mesh, axis or DATA_AXIS)
    return place_batch(batch, mesh, axis)


def pad_batch_rows(batch, shards: int):
    """A ``CSRBatch`` whose rows are padded to a multiple of ``shards`` with
    zero-weight rows that hold no nonzeros (inert in every kernel), built on
    the batch's device (the flat analog of ``shard_rows``)."""
    from photon_ml_tpu_torch.ops.csr import CSRBatch

    n_p = pad_count(batch.num_rows, shards)
    if n_p == batch.num_rows:
        return batch
    (piece,) = shard_rows(batch, 1)
    ptr = torch.cat([piece.row_ptr, piece.row_ptr[-1:].expand(n_p - batch.num_rows)])
    return CSRBatch.from_device_csr(
        ptr, piece.cols, piece.vals, pad_rows(piece.labels, n_p), batch.num_features,
        offsets=pad_rows(piece.offsets, n_p), weights=pad_rows(piece.weights, n_p))


def place_host_rows(shard, labels, offsets, weights, mesh: Mesh,
                    axis: Optional[str] = None) -> ShardedBatch:
    """A host feature shard (row-sorted COO: ``values``, ``rows``, ``cols``,
    ``num_features``) with its per-row vectors, split into equal row blocks
    over ``axis``: each block is cut on the host and built on its own
    device, so no device ever holds the whole batch."""
    axis = _resolve(mesh, axis, data_axis, "batch/data")
    pieces = host_row_shards(shard.values, shard.rows, shard.cols, labels, offsets, weights,
                             shard.num_features, axis_size(mesh, axis))
    return put_sharded(pieces, mesh, axis, num_rows=len(labels))


def place_batch(batch, mesh: Mesh, axis: Optional[str] = None) -> ShardedBatch:
    """Split a ``CSRBatch`` into equal row blocks over ``axis`` (default the
    mesh's batch/data axis), each its own ``CSRBatch`` on its device."""
    axis = _resolve(mesh, axis, data_axis, "batch/data")
    return put_sharded(shard_rows(batch, axis_size(mesh, axis)), mesh, axis,
                       num_rows=batch.num_rows)


# ---------------------------------------------------------------------------
# entity placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EntityShards:
    """An entity-leading ``[E, ...]`` array split into equal contiguous row
    blocks over a mesh axis, block i on the axis's i-th device. On a fleet's
    mesh the blocks of other members' devices are shapes only (``meta``
    tensors): a member holds its own blocks."""

    parts: tuple
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> tuple[int, ...]:
        return (sum(int(p.shape[0]) for p in self.parts),) + tuple(self.parts[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def rows_per_part(self) -> int:
        return int(self.parts[0].shape[0])

    def row_starts(self) -> list[int]:
        return [i * self.rows_per_part for i in range(len(self.parts))]

    def sharding_record(self) -> dict:
        """The reference's JSON record of a placement: mesh axes and spec."""
        return {"mesh_axes": {k: int(v) for k, v in self.mesh.shape.items()},
                "spec": [self.axis]}

    def numpy(self) -> np.ndarray:
        """The whole array on the host (across a fleet, every member's
        blocks: ``multihost.gather_to_host``)."""
        if self.mesh.is_multiprocess:
            from photon_ml_tpu_torch.parallel.multihost import gather_to_host

            return gather_to_host(self)
        return np.concatenate([p.detach().cpu().numpy() for p in self.parts])

    def local_blocks(self) -> list[tuple[int, Tensor]]:
        """(first row, block) of each block this process holds."""
        return [(start, p) for start, p in zip(self.row_starts(), self.parts)
                if p.device.type != "meta"]


@dataclasses.dataclass(frozen=True)
class OwnerBlocks:
    """Per-entity state ``[E, ...]`` kept where its owners solve it: part o
    holds entities ``[o * per, o * per + counts[o])`` of the joined order on
    its device, then padding rows up to ``per`` (``split_by_owner``'s
    blocks). Nothing joins the parts until a caller asks (``gather``:
    a model returned or saved)."""

    parts: tuple
    counts: tuple

    @property
    def rows_per_part(self) -> int:
        return int(self.parts[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(self.counts),) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first owner's device, where a gather lands by default."""
        return self.parts[0].device

    def gather(self, device: Optional[torch.device] = None) -> Tensor:
        """The joined ``[E, ...]`` tensor on ``device`` (default the first
        owner's), the real rows of each part in owner order."""
        dev = self.device if device is None else device
        return torch.cat([p[:n].to(dev) for p, n in zip(self.parts, self.counts)])

    def owner_ranges(self) -> list[tuple[int, int]]:
        """``[lo, hi)`` of each part's real rows in the joined order."""
        per = self.rows_per_part
        return [(o * per, o * per + n) for o, n in enumerate(self.counts)]

    @staticmethod
    def split(t: Tensor, devices: Sequence[torch.device]) -> "OwnerBlocks":
        """``t`` cut into ``split_by_owner``'s padded blocks, each on its
        owner's device."""
        parts, counts = [], []
        for (lo, hi, pad), d in zip(split_by_owner(int(t.shape[0]), len(devices)), devices):
            block = t[lo:hi].to(d, copy=True)
            if pad:
                block = torch.cat([block, block.new_zeros((pad,) + tuple(block.shape[1:]))])
            parts.append(block)
            counts.append(hi - lo)
        return OwnerBlocks(parts=tuple(parts), counts=tuple(counts))


def joined(t):
    """A tensor as it is; ``OwnerBlocks`` gathered on their first device."""
    return t.gather() if isinstance(t, OwnerBlocks) else t


class ElasticPlacementError(ValueError):
    """The target topology cannot hold this table: its entity count does not
    divide over the mesh's model axis (a configuration error, not a corrupt
    checkpoint)."""


def valid_entity_axis_sizes(num_entities: int, device_count: Optional[int] = None) -> list[int]:
    """The axis sizes ``num_entities`` divides over, up to ``device_count``
    (default: the CUDA devices, at least 1)."""
    if device_count is None:
        device_count = max(torch.cuda.device_count() if torch.cuda.is_available() else 0, 1)
    return [d for d in range(1, min(int(num_entities), int(device_count)) + 1)
            if num_entities % d == 0]


def entity_axis_mismatch(num_entities: int, axis: str, size: int,
                         what: str = "re-place elastically") -> ElasticPlacementError:
    """The indivisible-entity-axis error, listing the valid sizes."""
    return ElasticPlacementError(
        f"num_entities={num_entities} must divide over the {size}-device '{axis}' axis to "
        f"{what}; valid target axis sizes for this table: "
        f"{valid_entity_axis_sizes(num_entities, max(size, 1))}")


_FLEET_SIZE_LISTING_CAP = 64


def valid_fleet_sizes(num_entities: int) -> list[int]:
    """Fleet sizes ``num_entities`` divides over (not capped by devices)."""
    n = int(num_entities)
    return [d for d in range(1, min(n, _FLEET_SIZE_LISTING_CAP) + 1) if n % d == 0]


def fleet_size_mismatch(num_entities: int, num_members: int,
                        what: str = "slice the serving fleet") -> ElasticPlacementError:
    return ElasticPlacementError(
        f"num_entities={num_entities} must divide over a {num_members}-member serving fleet "
        f"to {what}; valid fleet sizes for this table: {valid_fleet_sizes(num_entities)}")


def member_row_range(num_entities: int, member: int, num_members: int) -> tuple[int, int]:
    """The contiguous entity-code block ``[lo, hi)`` that member ``member``
    of ``num_members`` owns, a function of the fleet size alone."""
    num_entities, num_members = int(num_entities), int(num_members)
    if num_members < 1:
        raise ValueError(f"num_members must be >= 1, got {num_members}")
    if not 0 <= int(member) < num_members:
        raise ValueError(f"member {member} outside fleet of {num_members}")
    if num_entities % num_members:
        raise fleet_size_mismatch(num_entities, num_members)
    per = num_entities // num_members
    return int(member) * per, (int(member) + 1) * per


def owner_of_row(num_entities: int, row: int, num_members: int) -> int:
    """The member owning entity code ``row`` (``member_row_range``'s inverse)."""
    num_entities, num_members = int(num_entities), int(num_members)
    if num_entities % num_members:
        raise fleet_size_mismatch(num_entities, num_members)
    if not 0 <= int(row) < num_entities:
        raise ValueError(f"entity code {row} outside table of {num_entities}")
    return int(row) // (num_entities // num_members)


def place_entities(t: Tensor, mesh: Mesh, axis: Optional[str] = None) -> EntityShards:
    """Split ``t`` ([E, ...], E a multiple of the axis size) into the axis's
    row blocks, each copied to its device."""
    axis = _resolve(mesh, axis, model_axis, "model/entity")
    devices = mesh.axis_devices(axis)
    if t.shape[0] % len(devices):
        raise entity_axis_mismatch(int(t.shape[0]), axis, len(devices), "place")
    per = t.shape[0] // len(devices)
    return EntityShards(parts=tuple(_owned_copy(t[i * per:(i + 1) * per], d)
                                    for i, d in enumerate(devices)), mesh=mesh, axis=axis)


@instrumented(name="place_entity_rows_copy")
def _owned_copy(t: Tensor, device: torch.device) -> Tensor:
    """A copy of ``t`` on ``device``."""
    return t.to(device, copy=True)


def place_entity_rows(read_rows: Callable[[int, int], np.ndarray], num_entities: int,
                      tail_shape: tuple, dtype, mesh: Optional[Mesh] = None,
                      axis: Optional[str] = None, device: Optional[torch.device] = None):
    """An ``[E, *tail_shape]`` table from a row-range reader
    (``read_rows(lo, hi)`` gives host rows [lo, hi)): with a mesh, each
    device's block is read on its own and placed (the host holds one block
    at a time), an ``EntityShards``; without, the whole table on ``device``."""
    shape = (int(num_entities),) + tuple(int(d) for d in tail_shape)

    def owned(lo, hi, dev, mine=True):
        if not mine:  # another member's block of a fleet mesh: its shape only
            return torch.empty((hi - lo,) + shape[1:], dtype=torch.from_numpy(
                np.zeros(0, dtype)).dtype, device="meta")
        # an owned copy, never a view of a memory-mapped file
        return torch.from_numpy(np.array(read_rows(lo, hi), dtype=dtype, copy=True)).to(dev)

    if mesh is None:
        return owned(0, shape[0], device)
    axis = _resolve(mesh, axis, model_axis, "model/entity")
    devices = mesh.axis_devices(axis)
    if shape[0] % len(devices):
        raise entity_axis_mismatch(shape[0], axis, len(devices))
    per = shape[0] // len(devices)
    return EntityShards(parts=tuple(owned(i * per, (i + 1) * per, d, p == mesh.process)
                                    for i, (d, p) in enumerate(zip(devices,
                                                                   mesh.axis_owners(axis)))),
                        mesh=mesh, axis=axis)


def split_by_owner(n: int, owners: int) -> list[tuple[int, int, int]]:
    """``n`` entities padded to a multiple of ``owners``: per owner its
    ``(lo, hi, pad)``, real entities [lo, hi) then ``pad`` padding ones."""
    per = rows_per_shard(n, owners) if n else 0
    out = []
    for i in range(owners):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        out.append((lo, hi, per - (hi - lo)))
    return out
