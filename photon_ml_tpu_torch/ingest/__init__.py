"""Streamed ingestion: a staged, threaded pipeline that turns a directory of
Avro files into a backpressured stream of device-ready chunks.

Counterpart of ``photon_ml_tpu/ingest``:

- ``planner``: assigns sync-delimited Avro block ranges to chunks in a
  deterministic order (stable across runs, so a resume replays the same
  stream from a chunk boundary); host code copied from the reference;
- ``buffers``: the ring of staging slots (pinned host tensors for a CUDA
  device) that decode workers fill with each chunk's CSR;
- ``decode``: one chunk's block range through the native decoder (the
  Python schema walker when the native program cannot be built, the same
  arrays);
- ``pipeline``: ``ChunkStream``, decode workers -> deterministic reorder ->
  one uploader thread copying chunk K+1 on its own CUDA stream while chunk
  K is used, with bounded queues and the typed stall protocol
  (``IngestStall``);
- ``assemble``: ``read_game_dataset_streamed``, a GameDataset whose feature
  shards are assembled on the device, bit for bit the in-core reader's;
- ``prefetch``: ``double_buffered``, the bounded background feeder of
  ``game/streaming.py``.

Telemetry: ``ingest.rows``, ``ingest.chunks``, ``ingest.stalls``,
``ingest.solve_waits`` counters, the ``ingest.queue_depth``,
``ingest.staging_bytes`` and ``ingest.rows_per_sec`` gauges, and per-stage
spans: the heartbeat's ``ingest_*`` fields and the RunReport's "Ingestion"
section read them.
"""

from photon_ml_tpu_torch.ingest.errors import (  # noqa: F401
    ChunkDecodeError,
    IngestConfigError,
    IngestError,
    IngestStall,
    PipelineClosed,
)
from photon_ml_tpu_torch.ingest.planner import (  # noqa: F401
    ChunkPlan,
    FileMeta,
    plan_chunks,
    plans_for_host,
    read_file_meta,
    scan_blocks,
)
from photon_ml_tpu_torch.ingest.pipeline import (  # noqa: F401
    ChunkStream,
    DeviceChunk,
    IngestSpec,
)
from photon_ml_tpu_torch.ingest.assemble import (  # noqa: F401
    read_game_dataset_streamed,
)
from photon_ml_tpu_torch.ingest.prefetch import double_buffered  # noqa: F401

__all__ = [
    "ChunkDecodeError",
    "ChunkPlan",
    "ChunkStream",
    "DeviceChunk",
    "FileMeta",
    "IngestConfigError",
    "IngestError",
    "IngestSpec",
    "IngestStall",
    "PipelineClosed",
    "double_buffered",
    "plan_chunks",
    "plans_for_host",
    "read_file_meta",
    "read_game_dataset_streamed",
    "scan_blocks",
]
