"""Live progress heartbeat: long fits are never silent.

Counterpart of ``photon_ml_tpu/telemetry/progress.py``. A
:class:`Heartbeat` is a daemon thread that every ``interval`` seconds emits
one structured line to the ``photon_ml_tpu_torch.telemetry.progress``
logger and, optionally, a JSONL sink:

    {"type": "heartbeat", "seq": 3, "uptime_s": 90.1,
     "span": "fit > cd_iteration > coordinate:per-user",
     "rows_per_s": 812345.0, "coeffs_per_s": 104321.0,
     "rows_total": 2.4e7, "coeffs_total": 3.1e6, "dropped_spans": 0,
     "hbm_bytes_in_use": 7516192768, "hbm_bytes_limit": 85045182464,
     "checkpoint_age_s": 41.0, "checkpoint_last_step": 7,
     "mfu": 0.0123, "comms_fraction": 0.02, "hot_exec": "csc_scatter",
     "guard": {"diverged": 0, "retried": 0, "rolled_back": 0, "frozen": 0}}

Rates are deltas of the ``progress.rows`` / ``progress.coeffs`` counters
over the beat window; each beat also refreshes the
``progress.rows_per_sec`` / ``progress.coeffs_per_sec`` gauges. ``span`` is
the deepest open span path across threads. The first beat fires one full
interval after start, so a run shorter than ``interval`` emits nothing.

A beat reads the registry and the caching allocator's host counters only:
it never synchronizes with the device, and it never initializes CUDA (the
memory fields are left out until the process has initialized it, and on
the CPU). Fields with no data behind them are left out, never zero:
``mfu`` needs modelled FLOPs in the window and known peaks,
``comms_fraction`` a collective estimate and modelled bytes, and
``hot_exec`` (the executable whose estimated exclusive seconds grew most in
the window) resolved profiler samples; the profiler read here waits for no
pending sample.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Optional

from photon_ml_tpu_torch.telemetry import (
    executables,
    identity,
    memory,
    metrics,
    profile,
    trace,
)

__all__ = ["Heartbeat", "DEFAULT_INTERVAL_S", "tail_heartbeat_fields"]

logger = logging.getLogger("photon_ml_tpu_torch.telemetry.progress")

#: Default beat interval: long enough that sub-30 s fits stay silent.
DEFAULT_INTERVAL_S = 30.0

_GUARD_COUNTERS = ("diverged", "retried", "rolled_back", "frozen")


class Heartbeat:
    """Periodic liveness/progress emitter (daemon thread): a context
    manager around a fit, or ``start()``/``stop()``; ``beat()`` is callable
    directly. The sampling cursors are written under ``self._lock``, since
    the daemon thread and a direct caller may beat at once."""

    def __init__(self, interval: float = DEFAULT_INTERVAL_S, jsonl_path: Optional[str] = None):
        if interval <= 0:
            raise ValueError("heartbeat interval must be > 0 seconds")
        self.interval = float(interval)
        self.jsonl_path = jsonl_path
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._last_rows = 0.0
        self._last_coeffs = 0.0
        self._last_flops = 0.0
        self._last_xla_bytes = 0.0
        self._last_comms = 0.0
        self._last_ingest_rows = 0.0
        self._last_profile_excl: dict[str, float] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self  # idempotent
        self._stop.clear()
        with self._lock:
            self._t0 = time.monotonic()
            self._last_t = self._t0
            self._last_rows = metrics.counter("progress.rows").value
            self._last_coeffs = metrics.counter("progress.coeffs").value
            # peek, don't create: a counter registered at 0 would turn the
            # report's "unknown" into a fabricated 0
            self._last_flops = metrics.peek_counter("xla.flops_total") or 0.0
            self._last_xla_bytes = metrics.peek_counter("xla.bytes_total") or 0.0
            self._last_comms = metrics.peek_counter("comms.bytes_total") or 0.0
            self._last_ingest_rows = metrics.peek_counter("ingest.rows") or 0.0
            self._last_profile_excl = profile.exclusive_seconds_by_name()
        self._thread = threading.Thread(target=self._run, name="photon-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(5.0, self.interval))
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        # the first beat one full interval in: short runs emit nothing
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except Exception:  # noqa: BLE001 — never fail training
                logger.debug("heartbeat probe failed", exc_info=True)

    # -- one beat ------------------------------------------------------------

    def beat(self) -> dict[str, Any]:
        """Sample progress, emit one line, and return it (the sink write
        stays outside the lock, so slow I/O never blocks another beat)."""
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._last_t, 1e-9)
            rows = metrics.counter("progress.rows").value
            coeffs = metrics.counter("progress.coeffs").value
            rows_per_s = (rows - self._last_rows) / dt
            coeffs_per_s = (coeffs - self._last_coeffs) / dt
            self._last_t, self._last_rows, self._last_coeffs = now, rows, coeffs
            if rows_per_s > 0:
                metrics.gauge("progress.rows_per_sec").set(rows_per_s)
            if coeffs_per_s > 0:
                metrics.gauge("progress.coeffs_per_sec").set(coeffs_per_s)
            self._seq += 1
            line: dict[str, Any] = {
                "type": "heartbeat",
                "seq": self._seq,
                "uptime_s": round(now - self._t0, 3),
                "span": trace.active_span_path(),
                "rows_per_s": round(rows_per_s, 1),
                "coeffs_per_s": round(coeffs_per_s, 1),
                "rows_total": rows,
                "coeffs_total": coeffs,
                "dropped_spans": metrics.counter("trace.dropped_spans").value,
            }
            # in a fleet the line says whose it is
            proc = identity.fleet_process_index()
            if proc is not None:
                line["proc"] = proc
            # device utilization over the window (peek: an absent counter
            # stays unknown)
            flops = metrics.peek_counter("xla.flops_total") or 0.0
            xla_bytes = metrics.peek_counter("xla.bytes_total") or 0.0
            comms = metrics.peek_counter("comms.bytes_total") or 0.0
            d_flops = flops - self._last_flops
            d_bytes = xla_bytes - self._last_xla_bytes
            d_comms = comms - self._last_comms
            self._last_flops, self._last_xla_bytes = flops, xla_bytes
            self._last_comms = comms
            ingest_rows = metrics.peek_counter("ingest.rows")
            d_ingest = None if ingest_rows is None else ingest_rows - self._last_ingest_rows
            if ingest_rows is not None:
                self._last_ingest_rows = ingest_rows
            # the hottest executable of this window: the largest growth of
            # the profiler's estimated exclusive seconds; none this window
            # leaves the field out (never a stale winner)
            excl = profile.exclusive_seconds_by_name()
            hot_exec, hot_delta = None, 0.0
            for name, secs in excl.items():
                d = secs - self._last_profile_excl.get(name, 0.0)
                if d > hot_delta:
                    hot_delta, hot_exec = d, name
            self._last_profile_excl = excl
            if hot_exec is not None:
                line["hot_exec"] = hot_exec
            sink = self.jsonl_path

        if d_flops > 0:
            peak_flops, _peak_bw = executables.device_peaks()
            if peak_flops:
                line["mfu"] = round(d_flops / (dt * peak_flops), 6)
        if d_comms > 0 and d_bytes > 0:
            # both sides known this window; without modelled bytes the
            # fraction is unknowable, so it is left out
            line["comms_fraction"] = round(d_comms / (d_comms + d_bytes), 6)

        stats = memory.hbm_stats()
        if stats and "bytes_in_use" in stats:
            line["hbm_bytes_in_use"] = int(stats["bytes_in_use"])
            if "bytes_limit" in stats:
                line["hbm_bytes_limit"] = int(stats["bytes_limit"])
        if d_ingest is not None:
            # how fast data enters the device, and how often the solve had
            # to wait for it (the live form of the report's Ingestion)
            line["ingest_rows_per_s"] = round(d_ingest / dt, 1)
            depth = metrics.peek_gauge("ingest.queue_depth")
            if depth is not None:
                line["ingest_queue_depth"] = int(depth)
            stalls = metrics.peek_counter("ingest.stalls")
            if stalls:
                line["ingest_stalls"] = int(stalls)
            waits = metrics.peek_counter("ingest.solve_waits")
            if waits:
                line["ingest_solve_waits"] = int(waits)
        spread = memory.device_spread_bytes()
        if spread is not None:
            line["hbm_device_spread_bytes"] = spread
        sweep_total = metrics.gauge("sweep.configs_total").value
        if sweep_total:
            line["sweep_configs_total"] = int(sweep_total)
            line["sweep_configs_done"] = int(metrics.gauge("sweep.configs_done").value or 0)
        last_save = metrics.gauge("checkpoint.last_save_ts").value
        if last_save is not None:
            line["checkpoint_age_s"] = round(max(trace.TRACER.now() - last_save, 0.0), 3)
            step = metrics.gauge("checkpoint.last_step").value
            if step is not None:
                line["checkpoint_last_step"] = int(step)
        guard = {name: metrics.counter(f"solves.{name}").value for name in _GUARD_COUNTERS}
        if any(guard.values()):
            line["guard"] = guard

        logger.info("heartbeat %s", json.dumps(line, default=str))
        if sink is not None:
            try:
                with open(sink, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(line, default=str) + "\n")
            except OSError:
                logger.warning("heartbeat sink %s unwritable; disabling it", sink)
                with self._lock:
                    self.jsonl_path = None
        return line


def tail_heartbeat_fields(path: str, max_bytes: int = 65536,
                          expect_proc: Optional[int] = None) -> Optional[dict[str, Any]]:
    """The newest parseable ``{"type": "heartbeat", ...}`` line of a
    telemetry JSONL, reading only its last ``max_bytes`` and skipping a
    truncated last line. With ``expect_proc`` a line must carry that
    ``proc``. Pure file I/O; None when no such line exists."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(size - max_bytes, 0))
            tail = fh.read()
    except OSError:
        return None
    for raw in reversed(tail.splitlines()):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw.decode("utf-8", errors="replace"))
        except ValueError:
            continue
        if not isinstance(rec, dict) or rec.get("type") != "heartbeat":
            continue
        if expect_proc is not None and rec.get("proc") != expect_proc:
            continue
        return rec
    return None
