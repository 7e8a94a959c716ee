"""Pre-allocated staging buffers between the decode workers and the uploader.

Counterpart of ``photon_ml_tpu/ingest/buffers.py``. A ring slot holds one
decoded chunk in the layout the device receives: per feature shard a chunk
of CSR (values f32, columns i32, the row pointer i32, unpadded), plus the
chunk's per-row scalars (exact f64) and id codes, which stay on the host.
On a CUDA device the CSR tensors are pinned host memory, so the uploader's
copies are asynchronous DMA; decode workers write them through their numpy
views and launch nothing on the card. On the CPU they are plain tensors.

A slot also holds the native decoder's float64/int64 COO scratch
(``DecodeScratch``), as the reference's slots do: one, shared by the shards
one at a time, on the native path; one a shard on the pure-Python path,
which fills every shard at once. A decode worker decodes only into the
slot it holds, so the ring's bytes, scratch included, are the stream's
staging memory as the reference counts it (the chunk's raw bytes and the
native decoder's own buffers live only while one chunk decodes and are not
counted in either package): what ``resident_budget_mb`` bounds and what the
gauge ``ingest.staging_bytes`` reads (set again after every growth).

Capacity: the row capacity is the plan's largest chunk; the scratch and a
shard's nonzero capacity start at ``rows_cap * nnz_per_row_hint`` (the
shard's plus one intercept a row) and double when a chunk overflows them
(``ingest.buffer_growths``).
The ring is bounded: decode blocks when the uploader stops draining
(backpressure), and a wait past the stall timeout raises ``IngestStall``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.ingest.errors import IngestStall, PipelineClosed
from photon_ml_tpu_torch.ingest.planner import ChunkPlan

_FP_RING_ACQUIRE = faults.register_point(
    "ingest.ring.acquire",
    description="staging-ring buffer acquisition by a decode worker",
)


def _host_tensor(n: int, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    return torch.empty(max(int(n), 1), dtype=dtype, pin_memory=pin)


class ShardStage:
    """One feature shard's chunk of CSR in a slot: ``values``, ``cols`` and
    ``row_ptr`` (host tensors, pinned for a CUDA device); ``nnz_used``
    entries of the first two and ``rows + 1`` of the last are filled."""

    __slots__ = ("nnz_cap", "values", "cols", "row_ptr", "nnz_used", "_pin")

    def __init__(self, nnz_cap: int, rows_cap: int, pin: bool):
        self._pin = pin
        self.nnz_used = 0
        self.row_ptr = _host_tensor(rows_cap + 1, torch.int32, pin)
        self._alloc(nnz_cap)

    def _alloc(self, nnz_cap: int) -> None:
        self.nnz_cap = max(int(nnz_cap), 1)
        self.values = _host_tensor(self.nnz_cap, torch.float32, self._pin)
        self.cols = _host_tensor(self.nnz_cap, torch.int32, self._pin)

    def grow(self, need: int) -> bool:
        """Make room for ``need`` nonzeros (doubling); True if it grew. The
        slot is the caller's, so its old contents need not survive."""
        if need <= self.nnz_cap:
            return False
        self._alloc(max(self.nnz_cap * 2, need))
        return True

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.values, self.cols, self.row_ptr))


class DecodeScratch:
    """A slot's float64/int64 COO scratch (the native decoder's output
    format), reused across the slot's chunks and grown geometrically."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.vals = np.empty(self.cap, np.float64)
        self.rows = np.empty(self.cap, np.int64)
        self.cols = np.empty(self.cap, np.int64)

    def ensure(self, need: int, preserve: int = 0) -> bool:
        """Room for ``need`` entries, keeping the first ``preserve`` (the
        Python decoder grows in the middle of a fill); True if it grew."""
        if need <= self.cap:
            return False
        cap = max(self.cap * 2, int(need))
        old = (self.vals, self.rows, self.cols)
        self.vals = np.empty(cap, np.float64)
        self.rows = np.empty(cap, np.int64)
        self.cols = np.empty(cap, np.int64)
        for new, prev in zip((self.vals, self.rows, self.cols), old):
            new[:preserve] = prev[:preserve]
        self.cap = cap
        return True

    @property
    def nbytes(self) -> int:
        return self.vals.nbytes + self.rows.nbytes + self.cols.nbytes


class StagingBuffer:
    """One ring slot: a decoded chunk's CSR per shard, its per-row data, and
    the decoder's scratch."""

    def __init__(self, rows_cap: int, raw_nnz_cap: int, n_shards: int, n_id_columns: int,
                 intercept: bool, n_scratch: int, pin: bool):
        nnz_cap = raw_nnz_cap + (rows_cap if intercept else 0)
        self.shards = [ShardStage(nnz_cap, rows_cap, pin) for _ in range(n_shards)]
        self.scratch = [DecodeScratch(raw_nnz_cap) for _ in range(n_scratch)]
        # the native decoder's scalar output format: exact f64, presence bytes
        self.labels = np.zeros(rows_cap, np.float64)
        self.offsets = np.zeros(rows_cap, np.float64)
        self.weights = np.ones(rows_cap, np.float64)
        self.label_seen = np.empty(rows_cap, np.uint8)
        self.id_codes = np.empty((n_id_columns, rows_cap), np.int64)
        # -- fill state (set by the decode worker, read by the uploader) ------
        self.plan: Optional[ChunkPlan] = None
        self.id_vocabs: list[np.ndarray] = []

    @property
    def nbytes(self) -> int:
        return (sum(s.nbytes for s in self.shards) + sum(c.nbytes for c in self.scratch)
                + self.labels.nbytes * 3 + self.label_seen.nbytes + self.id_codes.nbytes)


class BufferRing:
    """Bounded free-list of staging buffers with a condition variable.

    ``acquire`` blocks until a buffer is free, the backpressure edge
    between decode and upload, and raises a typed ``IngestStall`` after
    ``stall_timeout_s``. ``nbytes`` is the ring's current size; ``peak_bytes``
    the largest it has been (growth only adds)."""

    def __init__(self, buffers: Sequence[StagingBuffer], stall_timeout_s: float):
        self._cv = threading.Condition()
        self._free: deque[StagingBuffer] = deque(buffers)
        self._all = tuple(buffers)
        self._closed = False
        self._stall_timeout_s = float(stall_timeout_s)
        self.peak_bytes = 0
        self.note_size()

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._all)

    @property
    def capacity(self) -> int:
        return len(self._all)

    def note_size(self) -> None:
        """Set ``ingest.staging_bytes`` to the ring's size (after a growth)."""
        with self._cv:
            size = self.nbytes
            self.peak_bytes = max(self.peak_bytes, size)
        telemetry.gauge("ingest.staging_bytes").set(size)

    def acquire(self) -> StagingBuffer:
        faults.fault_point(_FP_RING_ACQUIRE)
        with self._cv:
            waited = self._cv.wait_for(lambda: self._free or self._closed,
                                       timeout=self._stall_timeout_s)
            if self._closed:
                raise PipelineClosed("buffer ring closed")
            if not waited:
                telemetry.counter("ingest.stalls").inc()
                raise IngestStall("decode", self._stall_timeout_s,
                                  "no free staging buffer (consumer not draining?)")
            return self._free.popleft()

    def release(self, buf: StagingBuffer) -> None:
        with self._cv:
            buf.plan = None
            self._free.append(buf)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
