"""The staged, threaded ingest pipeline: ``ChunkStream``.

Counterpart of ``photon_ml_tpu/ingest/pipeline.py``. Stages, each its own
thread(s), joined by bounded hand-offs:

  decode workers (N)  -- fill staging slots from block ranges
        |  deterministic reorder (chunks re-sequence to plan order)
  uploader (1)        -- copies chunk K+1 to the device while chunk K is used
        |  bounded output queue (``prefetch_depth``)
  consumer            -- the caller, iterating DeviceChunks

Backpressure is structural: decode blocks on the buffer ring, the uploader
on the output queue, and every wait has a stall timeout that raises a typed
``IngestStall``. Chunks leave in plan order whichever worker finished
first, so ``start_chunk=K`` replays the exact remaining stream, and the
stream-global interning of id codes is reproducible.

On a CUDA device the uploader copies each slot's pinned tensors with
``non_blocking`` copies on its own stream, records an event after them and
waits on it before the slot goes back to the decode workers (a slot
recycled before its copy lands would corrupt that chunk silently). The
consumer's stream waits on the same event and each chunk tensor is marked
used on it (``record_stream``), so the caching allocator cannot hand a
chunk's blocks to the next upload while the consumer still reads them. On
the CPU the uploader clones the slot (a tensor view would alias it).

Telemetry: counters ``ingest.rows``, ``ingest.chunks``, ``ingest.stalls``,
``ingest.buffer_growths``, ``ingest.read_retries``, ``ingest.solve_waits``;
gauges ``ingest.queue_depth``, ``ingest.staging_bytes``,
``ingest.rows_per_sec``; spans
``ingest_decode`` and ``ingest_upload``. The reference's fault-injection
points (ROADMAP.md Queue 1 item 14c) are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ingest.buffers import BufferRing, StagingBuffer
from photon_ml_tpu_torch.ingest.decode import (
    DecodeContext,
    build_decode_context,
    decode_chunk,
    scratch_count,
)
from photon_ml_tpu_torch.ingest.errors import (
    ChunkDecodeError,
    IngestConfigError,
    IngestStall,
    PipelineClosed,
)
from photon_ml_tpu_torch.ingest.planner import ChunkPlan, plan_chunks

Tensor = torch.Tensor

_END = object()


@dataclasses.dataclass(frozen=True)
class IngestSpec:
    """Tuning knobs of one ingest pipeline.

    ``workers=0`` means one decode worker per host core; a stream starts no
    more workers than the ring has slots (a worker decodes only into a slot
    it holds). ``prefetch_depth`` bounds how many device-ready chunks may
    wait ahead of the consumer. ``ring_slots=0`` sizes the staging ring to
    ``workers + prefetch_depth + 1``. ``resident_budget_mb`` caps the
    host-resident staging ring, the decoder's scratch in its slots
    included: it shrinks to fit (never below 2 slots; below that the
    pipeline cannot overlap, and the spec is refused with the sizing
    math).
    ``read_retries`` bounds how many times one chunk's decode is retried
    after a transient ``OSError`` before the error ends the stream; retries
    back off ``retry_backoff_s * 2**attempt`` and are counted in
    ``IngestStats`` and ``ingest.read_retries``.
    """

    workers: int = 0
    prefetch_depth: int = 2
    chunk_rows: int = 65536
    nnz_per_row_hint: int = 32
    ring_slots: int = 0
    resident_budget_mb: Optional[float] = None
    stall_timeout_s: float = 600.0
    read_retries: int = 2
    retry_backoff_s: float = 0.05

    def __post_init__(self):
        if self.workers < 0:
            raise IngestConfigError("ingest workers must be >= 0")
        if self.read_retries < 0:
            raise IngestConfigError("read_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise IngestConfigError("retry_backoff_s must be >= 0")
        if self.prefetch_depth < 1:
            raise IngestConfigError("prefetch_depth must be >= 1")
        if self.chunk_rows < 1:
            raise IngestConfigError("chunk_rows must be >= 1")
        if self.nnz_per_row_hint < 1:
            raise IngestConfigError("nnz_per_row_hint must be >= 1")
        if self.ring_slots < 0:
            raise IngestConfigError("ring_slots must be >= 0")
        if self.stall_timeout_s <= 0:
            raise IngestConfigError("stall_timeout_s must be > 0")
        if self.resident_budget_mb is not None and self.resident_budget_mb <= 0:
            raise IngestConfigError("resident_budget_mb must be > 0")

    def resolved_workers(self) -> int:
        return self.workers or max(os.cpu_count() or 1, 1)

    @staticmethod
    def from_config(obj) -> "IngestSpec":
        """Config value -> spec: ``true`` means defaults, an object overrides
        fields; unknown keys are a typed error (a silently ignored knob is
        worse than a refusal)."""
        if obj is True:
            return IngestSpec()
        if not isinstance(obj, Mapping):
            raise IngestConfigError(f"ingest config must be true or an object, got {obj!r}")
        fields = {f.name for f in dataclasses.fields(IngestSpec)}
        unknown = set(obj) - fields
        if unknown:
            raise IngestConfigError(f"unknown ingest config keys: {sorted(unknown)} "
                                    f"(known: {sorted(fields)})")
        return IngestSpec(**obj)


class ChunkCSR(NamedTuple):
    """One feature shard of a chunk on the device: a CSR over the chunk's
    rows (row pointer i32[rows + 1] from 0, columns i32, values f32)."""

    row_ptr: Tensor
    cols: Tensor
    vals: Tensor
    num_features: int

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]


@dataclasses.dataclass
class DeviceChunk:
    """One device-ready chunk, in stream order: ``shards`` on the device
    (unpadded: PyTorch runs eagerly), ``labels``/``offsets``/``weights``
    exact float64 host copies of its rows, ``id_codes`` stream-global
    interned entity codes."""

    index: int
    row_start: int
    rows: int
    shards: dict[str, ChunkCSR]
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    id_codes: dict[str, np.ndarray]
    ready: Optional["torch.cuda.Event"] = None  # the upload's completion, on a CUDA device

    @property
    def batch(self) -> ChunkCSR:
        """The single-shard view (GLM flows)."""
        if len(self.shards) != 1:
            raise ValueError(f"chunk has {len(self.shards)} shards; name one explicitly")
        return next(iter(self.shards.values()))


@dataclasses.dataclass
class IngestStats:
    rows: int = 0
    chunks: int = 0
    stalls: int = 0
    solve_waits: int = 0
    solve_wait_s: float = 0.0
    buffer_growths: int = 0
    #: the staging ring's largest size in bytes, the slots' scratch
    #: included (the budget bounds it)
    staging_bytes: int = 0
    rows_per_sec: float = 0.0
    #: transient read failures absorbed by a retry
    read_retries: int = 0


class ChunkStream:
    """Iterator of ``DeviceChunk`` on ``device`` (default cuda), fed by the
    threaded pipeline. Use as an iterator or a context manager; ``close()``
    tears the threads down early (abandoning a stream is legal: resume later
    with ``start_chunk``)."""

    def __init__(
        self,
        paths: Sequence[str],
        feature_shards: Optional[Mapping[str, Sequence[str]]] = None,
        index_maps: Optional[Mapping] = None,
        id_columns: Sequence[str] = (),
        add_intercept: bool = True,
        is_response_required: bool = True,
        spec: Optional[IngestSpec] = None,
        start_chunk: int = 0,
        id_vocabularies: Optional[Mapping[str, Sequence]] = None,
        device: torch.device | str | None = None,
    ):
        from photon_ml_tpu_torch.data.avro import _as_paths

        self.device = resolve_device(device)
        if index_maps is None:
            raise IngestConfigError(
                "the ingest pipeline needs index_maps up front (build or load them first — "
                "data.avro.build_index_maps_from_avro does a cheap vocab-only scan); an "
                "out-of-core stream cannot discover the feature space as it goes")
        self.spec = spec or IngestSpec()
        feature_shards = dict(feature_shards or {"features": ("features",)})
        file_list = _as_paths(list(paths))
        self.metas, all_plans = plan_chunks(file_list, self.spec.chunk_rows)
        if start_chunk < 0 or start_chunk > len(all_plans):
            raise IngestConfigError(f"start_chunk={start_chunk} out of range for "
                                    f"{len(all_plans)} planned chunks")
        self.plans = all_plans  # the full deterministic plan (for resume math)
        self._todo = all_plans[start_chunk:]
        self.total_rows = sum(p.n_rows for p in all_plans)
        self._ctx: DecodeContext = build_decode_context(
            self.metas, feature_shards, index_maps, id_columns, add_intercept,
            is_response_required)
        self.shard_names = self._ctx.shard_names
        self.num_features = {s: len(index_maps[s]) for s in self.shard_names}
        self.rows_cap = max((p.n_rows for p in all_plans), default=1)
        self._intercept = any(c >= 0 for c in self._ctx.intercept_cols)
        cuda = self.device.type == "cuda"
        self._upload_stream = torch.cuda.Stream(self.device) if cuda else None

        n_workers = min(self.spec.resolved_workers(), max(len(self._todo), 1))
        self._ring = self._build_ring(n_workers, len(feature_shards), len(id_columns), cuda)
        n_workers = min(n_workers, self._ring.capacity)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._work_i = 0
        self._pending: dict[int, StagingBuffer] = {}
        self._out: "queue.Queue" = queue.Queue(maxsize=self.spec.prefetch_depth)
        # stream-global id interning, first seen in stream order: a stream
        # started at chunk K assigns other codes than the full stream unless
        # it is seeded with the original run's vocabularies
        # (``id_vocabularies``, from ``id_vocabulary()``)
        self._interns: list[dict] = []
        for col in id_columns:
            seed = (id_vocabularies or {}).get(col, ())
            self._interns.append({v: i for i, v in enumerate(seed)})
        self._stats = IngestStats(staging_bytes=self._ring.peak_bytes)
        self._t0 = time.monotonic()
        self._got_first = False
        self._done = False
        self._threads = [
            threading.Thread(target=self._decode_loop, name=f"ingest-decode-{i}", daemon=True)
            for i in range(n_workers)
        ]
        self._threads.append(threading.Thread(target=self._upload_loop, name="ingest-upload",
                                              daemon=True))
        for t in self._threads:
            t.start()

    # -- sizing --------------------------------------------------------------

    def _build_ring(self, n_workers: int, n_shards: int, n_ids: int, pin: bool) -> BufferRing:
        spec = self.spec
        raw_cap = max(self.rows_cap * spec.nnz_per_row_hint, 1)
        slot = (self.rows_cap, raw_cap, n_shards, n_ids, self._intercept,
                scratch_count(self._ctx), pin)
        probe = StagingBuffer(*slot)
        slot_bytes = probe.nbytes
        want = spec.ring_slots or (n_workers + spec.prefetch_depth + 1)
        if spec.resident_budget_mb is not None:
            budget = int(spec.resident_budget_mb * 2**20)
            fit = max(budget // max(slot_bytes, 1), 0)
            if fit < 2:
                raise IngestConfigError(
                    f"resident_budget_mb={spec.resident_budget_mb:g} fits {fit} staging "
                    f"slot(s) of {slot_bytes / 2**20:.1f} MB (rows_cap={self.rows_cap}, "
                    f"nnz_per_row_hint={spec.nnz_per_row_hint}); the pipeline needs >= 2 — "
                    "raise the budget or lower chunk_rows/nnz_per_row_hint")
            want = min(want, fit)
        slots = [probe] + [StagingBuffer(*slot) for _ in range(want - 1)]
        return BufferRing(slots, spec.stall_timeout_s)

    # -- worker side ---------------------------------------------------------

    def _grew(self) -> None:
        """A slot's scratch or shard stage grew: count it and resize the
        ring's gauge."""
        telemetry.counter("ingest.buffer_growths").inc()
        self._ring.note_size()
        with self._lock:
            self._stats.buffer_growths += 1
            self._stats.staging_bytes = self._ring.peak_bytes

    def _decode_with_retry(self, plan: ChunkPlan, buf: StagingBuffer) -> None:
        """One chunk's decode, retried past transient ``OSError``s: up to
        ``spec.read_retries`` re-reads with exponential backoff, each
        starting the chunk over. A ``ChunkDecodeError`` (corrupt bytes, a
        schema violation) propagates at once: re-reading corrupt data gives
        the same corrupt data."""
        for attempt in range(self.spec.read_retries + 1):
            try:
                decode_chunk(self._ctx, plan, buf, self._grew)
                return
            except ChunkDecodeError:
                raise
            except OSError as e:
                if attempt >= self.spec.read_retries:
                    raise
                telemetry.counter("ingest.read_retries").inc()
                with self._lock:
                    self._stats.read_retries += 1
                delay = self.spec.retry_backoff_s * (2 ** attempt)
                logging.getLogger("photon_ml_tpu_torch.ingest").warning(
                    "transient read failure on chunk %d of %s (attempt %d/%d, retrying in "
                    "%.2fs): %s", plan.index, plan.path, attempt + 1,
                    self.spec.read_retries + 1, delay, e)
                if self._stop.wait(delay):
                    raise PipelineClosed("stream closed during a read-retry backoff") from None

    def _next_plan(self) -> Optional[ChunkPlan]:
        with self._lock:
            if self._work_i >= len(self._todo):
                return None
            plan = self._todo[self._work_i]
            self._work_i += 1
            return plan

    def _decode_loop(self) -> None:
        try:
            while not self._stop.is_set():
                # the slot before the plan: plans then go out in order to
                # workers that hold a slot, so a chunk never waits for a slot
                # that later chunks hold (taken the other way round, as the
                # reference does, a ring of fewer slots than workers can fill
                # with later chunks and stall)
                buf = self._ring.acquire()
                plan = self._next_plan()
                if plan is None:
                    self._ring.release(buf)
                    return
                with telemetry.span("ingest_decode", chunk=plan.index, rows=plan.n_rows,
                                    bytes=plan.nbytes):
                    self._decode_with_retry(plan, buf)
                with self._cv:
                    self._pending[plan.index] = buf
                    self._cv.notify_all()
        except PipelineClosed:
            pass
        except BaseException as e:  # surface worker deaths to the consumer
            self._fail(e)

    # -- uploader ------------------------------------------------------------

    def _put_out(self, item) -> None:
        deadline = time.monotonic() + self.spec.stall_timeout_s
        while True:
            if self._stop.is_set():
                raise PipelineClosed("stream closed while uploading")
            try:
                self._out.put(item, timeout=0.25)
                telemetry.gauge("ingest.queue_depth").set(self._out.qsize())
                return
            except queue.Full:
                if time.monotonic() > deadline:
                    telemetry.counter("ingest.stalls").inc()
                    with self._lock:
                        self._stats.stalls += 1
                    raise IngestStall("upload", self.spec.stall_timeout_s,
                                      "output queue stayed full (consumer stopped?)") from None

    def _upload_one(self, plan: ChunkPlan, buf: StagingBuffer) -> DeviceChunk:
        n = plan.n_rows
        shards: dict[str, ChunkCSR] = {}
        ready = None

        def views(st):
            return st.row_ptr[:n + 1], st.cols[:st.nnz_used], st.values[:st.nnz_used]

        if self._upload_stream is not None:
            # this thread's copies go on the upload stream; the event after
            # them is what the slot's release and the consumer wait on
            with torch.cuda.stream(self._upload_stream):
                for si, name in enumerate(self.shard_names):
                    shards[name] = ChunkCSR(*(t.to(self.device, non_blocking=True)
                                              for t in views(buf.shards[si])),
                                            self.num_features[name])
                ready = torch.cuda.Event()
                ready.record(self._upload_stream)
        else:
            for si, name in enumerate(self.shard_names):
                shards[name] = ChunkCSR(*(t.clone() for t in views(buf.shards[si])),
                                        self.num_features[name])
        labels = buf.labels[:n].copy()
        offsets = buf.offsets[:n].copy()
        weights = buf.weights[:n].copy()
        id_codes: dict[str, np.ndarray] = {}
        for ci, col in enumerate(self._ctx.id_columns):
            table = self._interns[ci]
            vocab = buf.id_vocabs[ci]
            remap = np.empty(len(vocab), np.int64)
            for i, key in enumerate(vocab):
                code = table.get(key)
                if code is None:
                    code = len(table)
                    table[key] = code
                remap[i] = code
            local = buf.id_codes[ci][:n]
            id_codes[col] = remap[local] if len(local) else local.copy()
        if ready is not None:
            # the slot goes back to the decode workers only once its bytes
            # are on the device
            ready.synchronize()
        return DeviceChunk(index=plan.index, row_start=plan.row_start, rows=n, shards=shards,
                           labels=labels, offsets=offsets, weights=weights, id_codes=id_codes,
                           ready=ready)

    def _upload_loop(self) -> None:
        try:
            for plan in self._todo:
                with self._cv:
                    ok = self._cv.wait_for(
                        lambda: plan.index in self._pending or self._stop.is_set(),
                        timeout=self.spec.stall_timeout_s)
                    if self._stop.is_set():
                        return
                    if not ok:
                        telemetry.counter("ingest.stalls").inc()
                        self._stats.stalls += 1
                        raise IngestStall("upload", self.spec.stall_timeout_s,
                                          f"chunk {plan.index} never arrived from decode")
                    buf = self._pending.pop(plan.index)
                with telemetry.span("ingest_upload", chunk=plan.index, rows=plan.n_rows):
                    chunk = self._upload_one(plan, buf)
                self._ring.release(buf)
                telemetry.counter("ingest.rows").inc(chunk.rows)
                telemetry.counter("ingest.chunks").inc()
                with self._lock:
                    self._stats.rows += chunk.rows
                    self._stats.chunks += 1
                self._put_out(chunk)
            self._put_out(_END)
        except PipelineClosed:
            pass
        except BaseException as e:
            self._fail(e)

    # -- failure / shutdown --------------------------------------------------

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
        self._stop.set()
        self._ring.close()
        with self._cv:
            self._cv.notify_all()

    def close(self) -> None:
        """Tear the pipeline down (idempotent)."""
        self._stop.set()
        self._ring.close()
        with self._cv:
            self._cv.notify_all()
        while True:  # unblock a put-blocked uploader
            try:
                self._out.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "ChunkStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> "ChunkStream":
        return self

    def __next__(self) -> DeviceChunk:
        if self._done:
            raise StopIteration
        t0 = time.monotonic()
        while True:
            with self._lock:
                if self._error is not None:
                    self._done = True
                    raise self._error
            try:
                item = self._out.get(timeout=0.25)
                break
            except queue.Empty:
                if time.monotonic() - t0 > self.spec.stall_timeout_s:
                    self._done = True
                    telemetry.counter("ingest.stalls").inc()
                    with self._lock:
                        self._stats.stalls += 1
                    raise IngestStall("consume", self.spec.stall_timeout_s,
                                      "no chunk arrived (decode starved or a worker died "
                                      "silently)") from None
        telemetry.gauge("ingest.queue_depth").set(self._out.qsize())
        if item is _END:
            self._done = True
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            with self._lock:
                self._stats.rows_per_sec = self._stats.rows / elapsed
            if self._stats.rows:
                telemetry.gauge("ingest.rows_per_sec").set(self._stats.rows_per_sec)
            raise StopIteration
        waited = time.monotonic() - t0
        if self._got_first:
            # the first chunk always waits for the pipeline to fill; later
            # waits mean the consumer is ingest-bound
            if waited > 0.002:
                telemetry.counter("ingest.solve_waits").inc()
                with self._lock:
                    self._stats.solve_waits += 1
                    self._stats.solve_wait_s += waited
        self._got_first = True
        if item.ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(item.ready)
            for csr in item.shards.values():
                for t in csr[:3]:
                    t.record_stream(current)
        return item

    @property
    def using_native_decoder(self) -> bool:
        """Whether chunks decode through the native C++ interpreter (False:
        the pure-Python workers, the same arrays)."""
        return self._ctx.use_native

    def stats(self) -> IngestStats:
        with self._lock:
            return dataclasses.replace(self._stats)

    def id_vocabulary(self, column: str) -> np.ndarray:
        """The stream-global first-seen vocabulary of an id column (complete
        once the stream is exhausted)."""
        ci = self._ctx.id_columns.index(column)
        return np.asarray(list(self._interns[ci]))
