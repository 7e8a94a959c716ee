"""Request-scoped tracing: one request followed from the router into each
member it fanned out to, a per-process ring of recent requests, and the
flight recorder.

Counterpart of ``photon_ml_tpu/telemetry/requests.py``, with its header,
record formats, span names and metric names, on the port's own ``faults``,
``identity``, ``metrics`` and ``trace``:

- **context**: the router mints a :class:`TraceContext` per request and
  sends it on every fan-out call in the ``X-Photon-Trace`` header; a member
  parses it and tags its record with the inbound ids, so one request's spans
  join across the ``trace.proc-<i>.jsonl`` streams by ``trace_id``
  (``FleetReport.request_traces``).
- **ring**: every request leaves a compact :class:`RequestRecord` (phase
  durations and serving attributes) in a bounded in-memory ring. Overflow
  evicts the oldest and is counted (``telemetry.trace_dropped``).
- **tail sampling**: a request's full trace is persisted (as ``request:*``
  spans through the process tracer's ``emit``, so they land in the span
  JSONL) only when it is slow (at or above the rolling p99 of recent
  latencies), degraded, failed, or explicitly sampled; the rest stay in the
  ring.
- **flight recorder**: the ring's last seconds dump atomically (a temporary
  file, then a rename: :func:`flight_dump`) on the drain path, and a
  supervisor that finds a member hard-killed makes the same document from
  the bounded tail of the member's span JSONL (:func:`harvest_flight`; a
  torn last line never fails the read). ``cli report --fleet`` renders it
  as a lost member's "last words".

This module runs on the serving request path after the engine's one
``telemetry.sync_fetch``: it is pure stdlib (no torch, no numpy) and never
touches a tensor, so it adds no device-to-host copy. The ring's lock is
taken around the ring alone, never while another lock is held; metrics and
spans are emitted outside it.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import json
import os
import threading
import time
import uuid
from typing import Any, Optional

from photon_ml_tpu_torch import faults
from photon_ml_tpu_torch.telemetry import identity, metrics, trace

__all__ = [
    "TRACE_HEADER",
    "TraceContext",
    "RequestRecord",
    "RequestTracer",
    "REQUESTS",
    "make_context",
    "parse_header",
    "begin",
    "finish",
    "configure",
    "records",
    "trace_time",
    "flight_path",
    "flight_dump",
    "harvest_flight",
    "read_flight",
    "tail_records",
    "reset",
]

#: the propagation header: ``<trace_id>/<request_id>[;s=1]``
TRACE_HEADER = "X-Photon-Trace"

DEFAULT_RING_LIMIT = 4096
#: the rolling latency window the slow threshold (p99) is taken over
_LATENCY_WINDOW = 512
#: below this many latencies nothing counts as slow (an empty p99 would
#: persist every early request)
_MIN_SAMPLES = 100
#: the p99 is recomputed every this many finishes (sorting the window on
#: every request would cost more than the tracing it bounds)
_THRESHOLD_EVERY = 32
#: tells "leave as it is" from an explicit None
_UNSET = object()

_FP_FLIGHT_DUMP = faults.register_point(
    "telemetry.flight_dump",
    description=(
        "the crash-safe flight-recorder dump (tmp-then-rename) fired on "
        "SIGTERM/drain — an exit rule is the process dying mid-dump; the "
        "fleet report must never adopt the torn .tmp it leaves behind"
    ),
)

# process-unique ids: one uuid a process and a counter (a uuid a request
# would cost more on the request path)
_ID_BASE = uuid.uuid4().hex[:12]
_ID_SEQ = itertools.count(1)


class TraceContext:
    """One request's propagated identity: ``trace_id`` names the whole
    fan-out tree, ``request_id`` the hop that minted it, ``sampled`` forces
    the full trace to be persisted on every process that sees it."""

    __slots__ = ("trace_id", "request_id", "sampled")

    def __init__(self, trace_id: str, request_id: str, sampled: bool = False):
        self.trace_id = trace_id
        self.request_id = request_id
        self.sampled = bool(sampled)

    def to_header(self) -> str:
        value = f"{self.trace_id}/{self.request_id}"
        return value + ";s=1" if self.sampled else value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.to_header()!r})"


def make_context(sampled: bool = False) -> TraceContext:
    """A fresh context (the router mints one a request)."""
    seq = next(_ID_SEQ)
    return TraceContext(trace_id=f"{_ID_BASE}{seq:08x}", request_id=f"{seq:06x}",
                        sampled=sampled)


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """An inbound ``X-Photon-Trace`` value as a context; None when it is
    absent or malformed (a bad header never fails its request)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split(";")
    ids = parts[0].split("/")
    if len(ids) != 2 or not ids[0] or not ids[1]:
        return None
    sampled = any(p.strip() == "s=1" for p in parts[1:])
    return TraceContext(ids[0], ids[1], sampled=sampled)


def trace_time(t_monotonic: Optional[float] = None) -> float:
    """A ``time.monotonic()`` stamp on the process tracer's timebase, so the
    batcher's enqueue stamps and the spans line up."""
    now_mono = time.monotonic()
    if t_monotonic is None:
        t_monotonic = now_mono
    return trace.TRACER.now() - (now_mono - t_monotonic)


class RequestRecord:
    """One request's ring entry: its start and duration, named phase
    durations, serving attributes and final status."""

    __slots__ = ("ctx", "name", "role", "t_start", "t_end", "dur_ms", "attrs", "phases",
                 "status", "error")

    def __init__(self, ctx: TraceContext, name: str, role: str, t_start: float,
                 attrs: dict[str, Any]):
        self.ctx = ctx
        self.name = name
        self.role = role
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.dur_ms: Optional[float] = None
        self.attrs = attrs
        #: (phase name, start on the tracer's timebase, duration ms)
        self.phases: list[tuple[str, float, float]] = []
        self.status = "ok"
        self.error: Optional[str] = None

    def phase(self, name: str, ms: float, ts: Optional[float] = None) -> None:
        """Record one named phase; ``ts`` (the tracer's timebase) defaults
        to "it just ended". Appended from the router's pool threads too: a
        list append is atomic under the GIL."""
        if ts is None:
            ts = trace.TRACER.now() - ms / 1000.0
        self.phases.append((str(name), float(ts), float(ms)))

    def set_attr(self, **attrs: Any) -> "RequestRecord":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "type": "request",
            "trace_id": self.ctx.trace_id,
            "request_id": self.ctx.request_id,
            "name": self.name,
            "role": self.role,
            "ts": round(self.t_start, 6),
            "dur_ms": None if self.dur_ms is None else round(self.dur_ms, 3),
            "status": self.status,
            "attrs": self.attrs,
            "phases": [{"name": n, "ts": round(ts, 6), "ms": round(ms, 3)}
                       for n, ts, ms in self.phases],
        }
        if self.error:
            out["error"] = self.error
        return out


class RequestTracer:
    """The per-process request ring, tail sampler and flight recorder. The
    ring and the latency window change only under ``_lock``; metrics and
    spans are emitted outside it (they take their own locks)."""

    def __init__(self, ring_limit: int = DEFAULT_RING_LIMIT):
        self._lock = threading.Lock()
        self._default_ring_limit = int(ring_limit)
        self._ring_limit = int(ring_limit)
        self._ring: collections.deque[RequestRecord] = collections.deque()
        self.dropped = 0
        self.enabled = True
        self._latencies: collections.deque[float] = collections.deque(maxlen=_LATENCY_WINDOW)
        self._since_threshold = 0
        #: an explicit threshold; None derives the rolling p99
        self._fixed_threshold_ms: Optional[float] = None
        self._rolling_threshold_ms: Optional[float] = None

    # -- configuration -------------------------------------------------------

    def configure(self, ring_limit: Optional[int] = None, enabled: Optional[bool] = None,
                  slow_threshold_ms: Any = _UNSET) -> None:
        """Set the ring's cap, turn recording on or off (an untraced run),
        or pin the slow threshold (``None`` restores the rolling p99)."""
        with self._lock:
            if ring_limit is not None:
                self._ring_limit = int(ring_limit)
            if slow_threshold_ms is not _UNSET:
                self._fixed_threshold_ms = (None if slow_threshold_ms is None
                                            else float(slow_threshold_ms))
        if enabled is not None:
            self.enabled = bool(enabled)

    @property
    def slow_threshold_ms(self) -> Optional[float]:
        """The slow threshold in force: the pinned one, else the rolling
        p99 (None while the window fills)."""
        if self._fixed_threshold_ms is not None:
            return self._fixed_threshold_ms
        return self._rolling_threshold_ms

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._latencies.clear()
            self.dropped = 0
            self._ring_limit = self._default_ring_limit
            self._since_threshold = 0
            self._fixed_threshold_ms = None
            self._rolling_threshold_ms = None
        self.enabled = True

    # -- a record's life -----------------------------------------------------

    def begin(self, name: str, ctx: Optional[TraceContext] = None, role: str = "member",
              t_start: Optional[float] = None, **attrs: Any) -> Optional[RequestRecord]:
        """Open a record (None when recording is off: callers check
        ``if rec is not None``). ``ctx=None`` mints a local, unsampled
        context."""
        if not self.enabled:
            return None
        if ctx is None:
            ctx = make_context()
        if t_start is None:
            t_start = trace.TRACER.now()
        return RequestRecord(ctx, str(name), str(role), t_start, dict(attrs))

    def finish(self, rec: Optional[RequestRecord], status: str = "ok",
               error: Optional[str] = None) -> Optional[RequestRecord]:
        """Close a record into the ring, account for drops and latency, and
        persist its full trace when tail sampling says so."""
        if rec is None or not self.enabled:
            return rec
        rec.t_end = trace.TRACER.now()
        rec.dur_ms = max(0.0, (rec.t_end - rec.t_start) * 1000.0)
        rec.status = str(status)
        rec.error = error
        dropped = 0
        with self._lock:
            self._ring.append(rec)
            while len(self._ring) > self._ring_limit:
                self._ring.popleft()  # the oldest goes
                dropped += 1
            self.dropped += dropped
            self._latencies.append(rec.dur_ms)
            self._since_threshold += 1
            if (self._since_threshold >= _THRESHOLD_EVERY
                    and len(self._latencies) >= _MIN_SAMPLES):
                self._since_threshold = 0
                window = sorted(self._latencies)
                self._rolling_threshold_ms = window[int(0.99 * (len(window) - 1))]
            threshold = self.slow_threshold_ms
        if dropped:
            metrics.counter("telemetry.trace_dropped").inc(dropped)
        metrics.counter("request.records").inc()
        metrics.histogram("request.total_ms").observe(rec.dur_ms)
        for pname, _ts, pms in rec.phases:
            metrics.histogram(f"request.phase.{pname}_ms").observe(pms)
        reason = None
        if rec.status != "ok":
            reason = "error"
        elif rec.attrs.get("degraded"):
            reason = "degraded"
        elif rec.ctx.sampled:
            reason = "sampled"
        elif threshold is not None and rec.dur_ms >= threshold:
            reason = "slow"
        if reason is not None:
            self._persist(rec, reason)
        return rec

    def _persist(self, rec: RequestRecord, reason: str) -> None:
        """The record as ``request:*`` spans through the process tracer (to
        the span JSONL sink), joinable by ``trace_id``."""
        attrs = dict(rec.attrs)
        attrs.update(trace_id=rec.ctx.trace_id, request_id=rec.ctx.request_id, role=rec.role,
                     status=rec.status, sampled_reason=reason,
                     dur_ms=round(rec.dur_ms or 0.0, 3),
                     phases={n: round(ms, 3) for n, _ts, ms in rec.phases})
        if rec.error:
            attrs["error"] = rec.error
        parent = trace.TRACER.emit(f"request:{rec.name}", ts=rec.t_start,
                                   dur=max(0.0, (rec.t_end or rec.t_start) - rec.t_start),
                                   **attrs)
        for pname, pts, pms in rec.phases:
            trace.TRACER.emit(f"request:{rec.name}:{pname}", ts=pts, dur=pms / 1000.0,
                              parent=parent, trace_id=rec.ctx.trace_id, phase=pname)
        metrics.counter("request.persisted").inc()

    # -- inspection ----------------------------------------------------------

    def records(self) -> list[dict[str, Any]]:
        """The ring, oldest first, as JSON-safe dicts."""
        with self._lock:
            return [r.to_dict() for r in self._ring]

    # -- the flight recorder -------------------------------------------------

    def flight_dump(self, path: str, last_s: float = 30.0) -> Optional[int]:
        """Dump the ring's records of the last ``last_s`` seconds to
        ``path`` atomically (a temporary file, then a rename). Returns the
        record count, or None when the dump failed (counted as
        ``telemetry.flight_dump_failures``): a dump never fails the drain
        path it rides on."""
        now = trace.TRACER.now()
        wall = datetime.datetime.now(datetime.timezone.utc)
        with self._lock:
            kept = [r.to_dict() for r in self._ring
                    if r.t_end is not None and now - r.t_end <= last_s]
            dropped = self.dropped
        doc: dict[str, Any] = {
            "type": "flight_record",
            "written": wall.isoformat(),
            # the trace header's anchor pair, so the fleet report aligns
            # flight records too
            "anchor_unix_s": round(wall.timestamp(), 6),
            "monotonic_anchor": round(now, 6),
            "hostname": identity.hostname(),
            "window_s": last_s,
            "dropped": dropped,
            "records": kept,
        }
        proc = identity.fleet_process_index()
        if proc is not None:
            doc["process_index"] = proc
        from photon_ml_tpu_torch.utils.atomic import atomic_write_json

        try:
            faults.fault_point(_FP_FLIGHT_DUMP)
            atomic_write_json(path, doc)
        except (faults.InjectedFault, faults.InjectedIOError, OSError):
            metrics.counter("telemetry.flight_dump_failures").inc()
            return None
        return len(kept)


#: the process-global request tracer; the module-level helpers delegate to it
REQUESTS = RequestTracer()

begin = REQUESTS.begin
finish = REQUESTS.finish
configure = REQUESTS.configure
records = REQUESTS.records
flight_dump = REQUESTS.flight_dump
reset = REQUESTS.reset


# -- flight-record files -----------------------------------------------------


def flight_path(directory: str, proc: Optional[int] = None) -> str:
    """``flight-proc-<i>.json`` under ``directory``, the name ``cli report
    --fleet`` adopts (its ``.tmp`` shadow never matches, so a kill in the
    middle of a dump leaves nothing to adopt)."""
    if proc is None:
        proc = identity.fleet_process_index() or 0
    return os.path.join(directory, f"flight-proc-{int(proc)}.json")


def read_flight(path: str) -> Optional[dict]:
    """One flight record, or None when it is absent, torn or not one."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("type") != "flight_record":
        return None
    return doc


def tail_records(path: str,
                 max_tail_bytes: int = 256 * 1024) -> tuple[Optional[dict], list[dict]]:
    """``(trace_header or None, records)`` from a bounded read of the end of
    a span JSONL stream: at most ``max_tail_bytes``, the torn first line of
    the window skipped, a torn last line (a writer killed mid-line) skipped;
    never a parse failure. The header comes from the file's first line."""
    start = 0
    try:
        with open(path, "rb") as fh:
            first = fh.readline(64 * 1024)
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            start = max(0, size - int(max_tail_bytes))
            fh.seek(start)
            blob = fh.read()
    except OSError:
        return None, []
    header: Optional[dict] = None
    try:
        rec = json.loads(first.decode("utf-8", "replace"))
        if isinstance(rec, dict) and rec.get("type") == "trace_header":
            header = rec
    except ValueError:
        pass
    lines = blob.decode("utf-8", "replace").splitlines()
    if start > 0 and lines:
        lines = lines[1:]  # the seek landed inside a line
    out: list[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # the torn last line of a killed writer
        if isinstance(rec, dict):
            out.append(rec)
    return header, out


def harvest_flight(trace_jsonl_path: str, out_path: str, last_s: float = 30.0,
                   max_tail_bytes: int = 256 * 1024) -> Optional[int]:
    """A supervisor's flight record for a hard-killed member (which never
    ran its own :func:`flight_dump`): the spans of the tail of the member's
    span JSONL that end within ``last_s`` of its latest timestamp, written
    atomically as a ``flight_record`` marked ``harvested``. Returns the span
    count, or None when the stream is missing or holds no span."""
    header, recs = tail_records(trace_jsonl_path, max_tail_bytes)
    spans = [r for r in recs
             if r.get("type") == "span" and isinstance(r.get("ts"), (int, float))]
    if not spans:
        return None

    def _end(r: dict) -> float:
        dur = r.get("dur")
        return r["ts"] + (dur if isinstance(dur, (int, float)) else 0.0)

    t_last = max(_end(r) for r in spans)
    kept = [r for r in spans if _end(r) >= t_last - last_s]
    doc: dict[str, Any] = {
        "type": "flight_record",
        "harvested": True,
        "source": trace_jsonl_path,
        "window_s": float(last_s),
        "records": kept,
    }
    for key in ("anchor_unix_s", "monotonic_anchor", "hostname", "process_index"):
        if header is not None and key in header:
            doc[key] = header[key]
    from photon_ml_tpu_torch.utils.atomic import atomic_write_json

    try:
        atomic_write_json(out_path, doc)
    except OSError:
        return None
    return len(kept)
