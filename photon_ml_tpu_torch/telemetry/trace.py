"""Hierarchical tracing spans with a JSONL sink and a Chrome-trace exporter.

Counterpart of ``photon_ml_tpu/telemetry/trace.py``, with its record
formats. ``with trace.span("fit"):`` opens a node of a thread-safe tree: it
nests under whatever span is open on the current thread (each thread roots
its own spans), records its host wall time, attributes, and point-in-time
events (device fetches). Completed spans go to a bounded in-memory buffer
(spans pushed out of it are counted in ``trace.dropped_spans``), optionally
stream to a JSONL file, and convert to the Chrome trace-event format that
Perfetto (https://ui.perfetto.dev) opens as a flame chart.

Spans time the host clock only: no span waits for the device. Durations use
``time.monotonic()``; the one wall-clock anchor, written in the sink's
header, comes from ``datetime``.

Span JSONL schema (one line per completed span)::

    {"type": "span", "id": 7, "parent": 3, "name": "coordinate:fixed",
     "ts": 1.042, "dur": 0.381, "thread": "MainThread",
     "attrs": {"iteration": 0},
     "events": [{"name": "device_fetch", "ts": 1.401,
                 "attrs": {"bytes": 4, "seconds": 0.1}}]}

``ts`` is seconds since the tracer's monotonic anchor; ``events[].ts`` shares
the timebase. Besides the buffer, the tracer keeps each span name's total
seconds (``span_seconds``), which no buffer limit drops. ``emit`` records a
span after the fact (the request tracer's tail sampler decides only once a
request has finished whether it keeps its phases as spans).

The Chrome export also takes a fleet telemetry directory: every member's
``trace.proc-<i>.jsonl`` stream merges into one file with a Perfetto track
per process, on the fleet report's absolute (anchor + skew) timebase.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterable, Iterator, Optional

from photon_ml_tpu_torch.telemetry import identity

__all__ = [
    "Span",
    "Tracer",
    "TRACER",
    "span",
    "current_span",
    "add_event",
    "active_span_path",
    "configure",
    "reset",
    "set_annotation_factory",
    "finished_spans",
    "span_seconds",
    "to_chrome_trace",
    "export_chrome_trace",
    "perfetto_path",
]

DEFAULT_BUFFER_LIMIT = 50_000


class Span:
    """One timed phase: a node of the per-thread span tree."""

    __slots__ = ("name", "span_id", "parent_id", "ts", "dur", "attrs", "events", "thread")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int], ts: float,
                 thread: str, attrs: dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = ts
        self.dur: Optional[float] = None  # set when the span closes
        self.attrs = attrs
        self.events: list[dict[str, Any]] = []
        self.thread = thread

    def set_attr(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, ts: float, **attrs: Any) -> None:
        self.events.append({"name": name, "ts": ts, "attrs": attrs})

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": "span",
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "ts": round(self.ts, 6),
            "dur": None if self.dur is None else round(self.dur, 6),
            "thread": self.thread,
            "attrs": self.attrs,
            "events": self.events,
        }


class Tracer:
    """Thread-safe span collector: per-thread open-span stacks, a shared
    bounded buffer of completed spans, per-name totals, and an optional
    JSONL sink. Tracing never fails its caller: a sink write error closes
    the sink, and attribute values JSON cannot encode are stringified."""

    def __init__(self, buffer_limit: int = DEFAULT_BUFFER_LIMIT):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._anchor = time.monotonic()
        self._finished: list[Span] = []
        self._totals: dict[str, float] = {}
        # every thread's open-span stack, so reset() can clear them all
        # (a threading.local is visible from its own thread only)
        self._all_stacks: list[list[Span]] = []
        self._default_buffer_limit = buffer_limit
        self._buffer_limit = buffer_limit
        self.dropped_spans = 0
        self._sink_path: Optional[str] = None
        self._sink_fh = None
        # optional per-span mirror: a context-manager factory
        # (torch.profiler.record_function) entered and exited with every
        # span, so the span tree shows in a profiler capture (cli profile)
        self._annotation_factory = None

    # -- configuration -------------------------------------------------------

    def configure(self, jsonl_path: Optional[str] = None,
                  buffer_limit: Optional[int] = None) -> None:
        """Set (or replace) the JSONL sink and/or the buffer's cap. A new
        sink truncates its file: one session per file, one timebase."""
        with self._lock:
            if buffer_limit is not None:
                self._buffer_limit = int(buffer_limit)
            if jsonl_path is not None and jsonl_path != self._sink_path:
                self._close_sink_locked()
                self._sink_path = jsonl_path
                self._sink_fh = open(jsonl_path, "w", encoding="utf-8")
                wall = datetime.datetime.now(datetime.timezone.utc)
                header = {
                    "type": "trace_header",
                    "wall_time": wall.isoformat(),
                    "monotonic_anchor": round(time.monotonic() - self._anchor, 6),
                    # a span at tracer time `ts` happened at epoch second
                    # anchor_unix_s + (ts - monotonic_anchor)
                    "anchor_unix_s": round(wall.timestamp(), 6),
                    "hostname": identity.hostname(),
                }
                proc = identity.fleet_process_index()
                if proc is not None:
                    header["process_index"] = proc
                    nproc = identity.fleet_process_count()
                    if nproc is not None:
                        header["num_processes"] = nproc
                self._sink_fh.write(json.dumps(header) + "\n")
                self._sink_fh.flush()

    def close_sink(self) -> None:
        """Close the JSONL sink (the spans stay in the buffer)."""
        with self._lock:
            self._close_sink_locked()

    def _close_sink_locked(self) -> None:
        if self._sink_fh is not None:
            try:
                self._sink_fh.close()
            except OSError:
                pass
        self._sink_fh = None
        self._sink_path = None

    def set_annotation_factory(self, factory) -> None:
        """Mirror every span into ``factory(name)`` context managers:
        ``torch.profiler.record_function`` makes the span tree show in a
        ``cli profile`` capture beside the kernels. ``None`` disables.
        An annotation that fails never fails its span."""
        self._annotation_factory = factory

    def reset(self) -> None:
        """Drop the finished spans and the totals, close the sink, clear
        every thread's open-span stack (a span left open on a worker thread
        must not parent later spans), and restore the default buffer limit,
        the drop count and the span annotation mirror."""
        with self._lock:
            self._finished.clear()
            self._totals.clear()
            self._close_sink_locked()
            for stack in self._all_stacks:
                stack.clear()
            self._buffer_limit = self._default_buffer_limit
            self.dropped_spans = 0
            self._annotation_factory = None

    # -- span lifecycle ------------------------------------------------------

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            with self._lock:
                self._all_stacks.append(stack)
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def open_spans(self) -> list[Span]:
        """The open span path, outermost first, of the thread whose
        innermost span started last; safe to call from another thread."""
        with self._lock:
            stacks = [list(s) for s in self._all_stacks]
        stacks = [s for s in stacks if s]
        if not stacks:
            return []
        return max(stacks, key=lambda s: s[-1].ts)

    def active_span_path(self, sep: str = " > ") -> str:
        """``"fit > cd_iteration > coordinate:fixed"`` for the deepest open
        span path, or ``""`` when nothing is open."""
        return sep.join(s.name for s in self.open_spans())

    def now(self) -> float:
        """Seconds on the tracer's monotonic timebase."""
        return time.monotonic() - self._anchor

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(name=name, span_id=next(self._ids),
                 parent_id=None if parent is None else parent.span_id, ts=self.now(),
                 thread=threading.current_thread().name, attrs=dict(attrs))
        stack.append(s)
        annotation = None
        factory = self._annotation_factory
        if factory is not None:
            try:
                annotation = factory(name)
                annotation.__enter__()
            except Exception:  # noqa: BLE001 — mirroring must never fail
                annotation = None
        try:
            yield s
        finally:
            if annotation is not None:
                try:
                    annotation.__exit__(None, None, None)
                except Exception:  # noqa: BLE001
                    pass
            s.dur = self.now() - s.ts
            # close even if exits arrive out of order (a leaked child span)
            while stack and stack[-1] is not s:
                stack.pop()
            if stack:
                stack.pop()
            self._finish(s)

    def add_event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time event to the current span (a no-op when
        no span is open)."""
        cur = self.current()
        if cur is not None:
            cur.add_event(name, ts=self.now(), **attrs)

    def emit(self, name: str, ts: float, dur: float, parent: Optional[int] = None,
             **attrs: Any) -> int:
        """Record an already-measured span (no context manager); returns its
        id, so children can be parented under it."""
        s = Span(name=name, span_id=next(self._ids), parent_id=parent, ts=float(ts),
                 thread=threading.current_thread().name, attrs=dict(attrs))
        s.dur = max(0.0, float(dur))
        self._finish(s)
        return s.span_id

    def _finish(self, s: Span) -> None:
        dropped = 0
        with self._lock:
            self._totals[s.name] = self._totals.get(s.name, 0.0) + s.dur
            self._finished.append(s)
            if len(self._finished) > self._buffer_limit:
                dropped = len(self._finished) - self._buffer_limit
                del self._finished[:dropped]
                self.dropped_spans += dropped
            if self._sink_fh is not None:
                try:
                    self._sink_fh.write(json.dumps(s.to_dict(), default=str) + "\n")
                    self._sink_fh.flush()
                except (OSError, ValueError):
                    self._close_sink_locked()  # never fail the caller
        if dropped:
            # local import: metrics stays importable without trace
            from photon_ml_tpu_torch.telemetry import metrics

            metrics.counter("trace.dropped_spans").inc(dropped)

    # -- inspection ----------------------------------------------------------

    def finished_spans(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def span_seconds(self) -> dict[str, float]:
        """Total seconds per span name since the last reset."""
        with self._lock:
            return dict(self._totals)


#: Process-global tracer; the module-level helpers delegate to it.
TRACER = Tracer()

span = TRACER.span
current_span = TRACER.current
add_event = TRACER.add_event
active_span_path = TRACER.active_span_path
configure = TRACER.configure
reset = TRACER.reset
set_annotation_factory = TRACER.set_annotation_factory
finished_spans = TRACER.finished_spans
span_seconds = TRACER.span_seconds


# -- Chrome trace (Perfetto) export ------------------------------------------


def to_chrome_trace(records: Iterable[dict] | str) -> dict:
    """Span dicts (``Span.to_dict()`` / JSONL lines) as the Chrome
    trace-event object Perfetto loads: spans become ``ph: "X"`` duration
    events, span events ``ph: "i"`` thread-scoped instants, one thread lane
    (``tid`` + ``thread_name`` metadata) per thread, microseconds on the
    tracer's timebase. A fleet telemetry directory's path instead merges
    its members' streams (:func:`_fleet_chrome_trace`)."""
    if isinstance(records, str):
        return _fleet_chrome_trace(records)
    tids: dict[str, int] = {}
    events: list[dict] = []
    meta: list[dict] = []

    def tid(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tids[thread],
                         "args": {"name": thread}})
        return tids[thread]

    for rec in records:
        if rec.get("type") != "span":
            continue
        t = tid(rec.get("thread", "main"))
        events.append({"name": rec["name"], "cat": "span", "ph": "X",
                       "ts": round(rec["ts"] * 1e6, 3),
                       "dur": round((rec.get("dur") or 0.0) * 1e6, 3),
                       "pid": 1, "tid": t, "args": rec.get("attrs", {})})
        for ev in rec.get("events", ()):
            events.append({"name": ev["name"], "cat": "event", "ph": "i", "s": "t",
                           "ts": round(ev["ts"] * 1e6, 3), "pid": 1, "tid": t,
                           "args": ev.get("attrs", {})})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _fleet_chrome_trace(fleet_dir: str) -> dict:
    """One Chrome trace of a fleet directory: a Perfetto process per member
    (``proc-<i> (<hostname>)``), each member's spans shifted onto
    ``FleetReport``'s absolute (anchor + skew) timebase, origin at the
    earliest anchored span. A stream without an anchor keeps its own
    timebase (better skewed than dropped)."""
    # local import: fleet_report imports report, which imports this module
    from photon_ml_tpu_torch.telemetry.fleet_report import FleetReport

    fleet = FleetReport.load(fleet_dir)
    merged = fleet.merged_spans()
    anchored = [r["abs_ts"] for r in merged if isinstance(r.get("abs_ts"), (int, float))]
    t0 = min(anchored) if anchored else 0.0
    hosts = {m.process_index: m.hostname for m in fleet.members}
    events: list[dict] = []
    meta: list[dict] = []
    pids: set[int] = set()
    tids: dict[tuple[int, str], int] = {}

    def pid_of(proc: int) -> int:
        pid = int(proc) + 1  # Perfetto hides pid 0
        if pid not in pids:
            pids.add(pid)
            label = f"proc-{proc}"
            if hosts.get(proc):
                label += f" ({hosts[proc]})"
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": label}})
        return pid

    def tid_of(pid: int, thread: str) -> int:
        key = (pid, thread)
        if key not in tids:
            tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            meta.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tids[key],
                         "args": {"name": thread}})
        return tids[key]

    for rec in merged:
        if rec.get("type") != "span":
            continue
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        pid = pid_of(int(rec.get("process_index") or 0))
        t = tid_of(pid, rec.get("thread", "main"))
        abs_ts = rec.get("abs_ts")
        shift = (abs_ts - t0 - ts) if isinstance(abs_ts, (int, float)) else 0.0
        events.append({"name": rec["name"], "cat": "span", "ph": "X",
                       "ts": round((ts + shift) * 1e6, 3),
                       "dur": round((rec.get("dur") or 0.0) * 1e6, 3),
                       "pid": pid, "tid": t, "args": rec.get("attrs", {})})
        for ev in rec.get("events", ()):
            if not isinstance(ev.get("ts"), (int, float)):
                continue
            events.append({"name": ev["name"], "cat": "event", "ph": "i", "s": "t",
                           "ts": round((ev["ts"] + shift) * 1e6, 3), "pid": pid, "tid": t,
                           "args": ev.get("attrs", {})})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def perfetto_path(trace_out: str) -> str:
    """The sibling ``.perfetto.json`` path of a span JSONL path."""
    base = trace_out[:-6] if trace_out.endswith(".jsonl") else trace_out
    return base + ".perfetto.json"


def export_chrome_trace(jsonl_path: str, out_path: str) -> int:
    """Convert a span JSONL file, or a fleet telemetry directory of
    ``trace.proc-<i>.jsonl`` streams, to one Chrome/Perfetto trace file,
    written atomically; returns the number of trace events. Unparseable
    lines are skipped (a crashed run leaves a truncated last line)."""
    from photon_ml_tpu_torch.utils.atomic import atomic_write_json

    if os.path.isdir(jsonl_path):
        doc = to_chrome_trace(jsonl_path)
        atomic_write_json(out_path, doc)
        return len(doc["traceEvents"])
    records = []
    with open(jsonl_path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    doc = to_chrome_trace(records)
    atomic_write_json(out_path, doc)
    return len(doc["traceEvents"])
