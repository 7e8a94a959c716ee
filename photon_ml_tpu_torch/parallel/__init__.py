"""The single-controller device mesh (counterpart of ``photon_ml_tpu/parallel``):
one process drives every device of a ``Mesh``; a fixed-effect design is split
by rows over the ``batch`` axis (``place_batch``), per-entity state over the
``model`` axis (``place_entities``), and each data sum is the shards'
partials summed on the first device in shard order. Of the reference's
per-process fleet, ``multihost.py`` holds the ``torch.distributed`` wiring
(``initialize``, ``process_slice``, ``fleet_any``, ``gather_to_host``) and
the liveness files, and ``fleet_status.py`` the supervisor's live status.
Per-entity state on a mesh stays with its owners (``OwnerBlocks``), and a
host dataset reaches each batch-axis device as its own row block
(``place_host_rows``). The solves of
``distributed.py`` load on first use, since they import the optimizers,
which import this package."""

from photon_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ENTITY_AXIS,
    Mesh,
    RowShard,
    host_row_shards,
    make_mesh,
    put_sharded,
    shard_rows,
)
from photon_ml_tpu_torch.parallel.sharding import (
    BATCH_AXIS,
    MODEL_AXIS,
    ElasticPlacementError,
    EntityShards,
    OwnerBlocks,
    RowShards,
    ShardedBatch,
    axis_size,
    data_axis,
    entity_axis_mismatch,
    joined,
    member_row_range,
    model_axis,
    owner_of_row,
    pad_batch_rows,
    pad_count,
    place_batch,
    place_entities,
    place_host_rows,
    place_entity_rows,
    valid_entity_axis_sizes,
)

_SOLVES = ("distributed_hessian_diagonal", "distributed_solve", "distributed_value_and_grad",
           "gspmd_solve")

__all__ = [
    "BATCH_AXIS", "DATA_AXIS", "ENTITY_AXIS", "MODEL_AXIS", "ElasticPlacementError",
    "EntityShards", "Mesh", "OwnerBlocks", "RowShard", "RowShards", "ShardedBatch", "axis_size",
    "data_axis", "entity_axis_mismatch", "host_row_shards", "joined", "make_mesh",
    "member_row_range", "model_axis", "owner_of_row", "pad_batch_rows", "pad_count",
    "place_batch", "place_entities", "place_entity_rows", "place_host_rows",
    "put_sharded", "shard_rows", "valid_entity_axis_sizes", *_SOLVES,
]


def __getattr__(name):
    if name in _SOLVES:
        from photon_ml_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
