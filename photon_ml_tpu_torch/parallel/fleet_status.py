"""Live fleet status: the JSON snapshot an operator polls while a fleet runs.

Counterpart of ``photon_ml_tpu/parallel/fleet_status.py``. The supervisor
(``tools/fleet.py``) knows the fleet's state (exit codes, deaths, the
relaunch generation); :class:`FleetStatusWriter` publishes it on a cadence:

- ``status_file``: one atomic JSON snapshot (written to a temporary file and
  renamed, so a poller never reads a torn file), refreshed every
  ``interval_s``;
- ``port``: the same snapshot over HTTP (``GET /statusz``), computed fresh
  for each request;
- member liveness comes from the heartbeat files' mtimes
  (``proc-<i>.alive``, ``multihost.HeartbeatWriter``), and, with
  ``telemetry_out``, each member's last progress fields from the tail of
  its telemetry stream (``telemetry.progress.tail_heartbeat_fields``, which
  requires the line's ``proc`` to be the member's, so a stream written by
  another process reads as silence).

A status write is observability, never control: an unwritable status file
(a full disk, a removed workdir, or the ``fleet.status_write`` fault seam's
``io`` rule) logs, counts ``fleet.status_write_errors`` and the supervisor
goes on.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from typing import Any, Optional

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.utils.atomic import atomic_write_json

logger = logging.getLogger("photon_ml_tpu_torch.parallel.fleet_status")

__all__ = ["FleetStatusWriter", "DEFAULT_STATUS_INTERVAL_S"]

DEFAULT_STATUS_INTERVAL_S = 1.0

# one status-snapshot write by the supervisor's thread: an `io` rule is the
# full-disk shape the writer absorbs, `raise` reaches write_once's caller
_FP_STATUS_WRITE = faults.register_point(
    "fleet.status_write",
    description="one supervisor status-snapshot write (file and/or the HTTP cache refresh)",
)


class FleetStatusWriter:
    """Publish the supervisor's view of the fleet on a cadence (a daemon
    thread). ``update(...)`` is the supervisor's side (generation, exit
    codes, deaths, relaunches); liveness is read from the shared filesystem
    at snapshot time, so the status stays true while the supervisor waits.
    Use as a context manager or ``start()``/``stop()``."""

    def __init__(self, fleet_dir: str, num_processes: int, heartbeat_deadline_s: float,
                 status_file: Optional[str] = None, port: Optional[int] = None,
                 telemetry_out: Optional[str] = None,
                 interval_s: float = DEFAULT_STATUS_INTERVAL_S):
        if interval_s <= 0:
            raise ValueError("status interval_s must be > 0")
        self.fleet_dir = fleet_dir
        self.status_file = status_file
        self.telemetry_out = telemetry_out
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._server_thread: Optional[threading.Thread] = None
        self._requested_port = port
        self.port: Optional[int] = None
        # written by the supervisor (update), read by the status thread and
        # the HTTP handlers: every access under the lock
        self._lock = threading.Lock()
        self._state: dict[str, Any] = {
            "generation": 0,
            "num_processes": int(num_processes),
            "heartbeat_deadline_s": float(heartbeat_deadline_s),
            "deaths": [],
            # across relaunches: a recovered run's final status still shows
            # the loss
            "death_history": [],
            "relaunches": 0,
            "rcs": {},
            "outcome": None,
            # the members' telemetry streams' unsuffixed path (a generation
            # of a training fleet has its own)
            "telemetry_out": telemetry_out,
            # per-member facts beyond liveness (a serving fleet's ranges),
            # keyed by process id and merged into the member's entry
            "member_extras": {},
        }

    def update(self, **fields: Any) -> None:
        """Merge supervisor-side facts into the next snapshot."""
        with self._lock:
            self._state.update(fields)

    def snapshot(self) -> dict[str, Any]:
        """One JSON-safe status document: the pushed state plus the live
        filesystem (heartbeat mtimes, the telemetry streams' tails)."""
        from photon_ml_tpu_torch.telemetry import identity
        from photon_ml_tpu_torch.telemetry.progress import tail_heartbeat_fields

        with self._lock:
            state = dict(self._state)
        deadline_s = state["heartbeat_deadline_s"]
        # wall clock by necessity: liveness is measured against file mtimes
        now = time.time()
        members: dict[str, Any] = {}
        for pid in range(int(state["num_processes"])):
            entry: dict[str, Any] = {
                "rc": state["rcs"].get(pid, state["rcs"].get(str(pid))),
                "lost": pid in (state.get("deaths") or []),
            }
            try:
                mtime = os.path.getmtime(multihost.heartbeat_path(self.fleet_dir, pid))
            except OSError:
                entry["alive"] = False
                entry["heartbeat_age_s"] = None
            else:
                age = max(now - mtime, 0.0)
                entry["heartbeat_age_s"] = round(age, 3)
                entry["alive"] = age <= deadline_s and entry["rc"] is None
            telemetry_out = state.get("telemetry_out")
            if telemetry_out is not None:
                fields = tail_heartbeat_fields(identity.member_artifact_path(telemetry_out, pid),
                                               expect_proc=pid)
                if fields is not None:
                    entry["last_heartbeat"] = fields
            extras = state.get("member_extras") or {}
            extra = extras.get(pid, extras.get(str(pid)))
            if extra:
                entry.update(extra)
                if extra.get("degraded"):
                    # the router cannot reach it: its shard is not serving
                    entry["lost"] = True
            members[str(pid)] = entry
        return {
            "type": "fleet_status",
            "wall_time": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "generation": state["generation"],
            "num_processes": state["num_processes"],
            "deaths": state.get("deaths") or [],
            "death_history": state.get("death_history") or [],
            "deaths_total": len(state.get("death_history") or []),
            "relaunches": state.get("relaunches", 0),
            "outcome": state.get("outcome"),
            "alive_members": sorted(int(p) for p, e in members.items() if e.get("alive")),
            "members": members,
        }

    def write_once(self) -> Optional[dict[str, Any]]:
        """One snapshot to the status file (atomically). The snapshot, or
        None when the write failed (logged and counted, never fatal)."""
        snap = self.snapshot()
        if self.status_file is None:
            return snap
        try:
            faults.fault_point(_FP_STATUS_WRITE)
            atomic_write_json(self.status_file, snap, indent=2, sort_keys=True, default=str)
        except OSError as e:
            telemetry.counter("fleet.status_write_errors").inc()
            logger.warning("fleet status write failed: %s", e)
            return None
        telemetry.counter("fleet.status_writes").inc()
        return snap

    def start(self) -> "FleetStatusWriter":
        if self._thread is not None:
            return self
        if self._requested_port is not None:
            self._start_server(self._requested_port)
        if self.status_file is None:
            # HTTP only: each request computes its own snapshot
            return self
        self.write_once()
        self._thread = threading.Thread(target=self._run, name="fleet-status", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_once()
            except Exception:  # noqa: BLE001 - never stop supervision
                logger.debug("fleet status probe failed", exc_info=True)

    def _start_server(self, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        writer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path not in ("/", "/statusz"):
                    self.send_error(404)
                    return
                try:
                    body = json.dumps(writer.snapshot(), indent=2, sort_keys=True,
                                      default=str).encode("utf-8")
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # operators poll this: stay quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(target=self._server.serve_forever,
                                               name="fleet-status-http", daemon=True)
        self._server_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            self._server = None
        if self._server_thread is not None:
            self._server_thread.join(timeout=5.0)
            self._server_thread = None
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.interval_s * 4))
            self._thread = None
        self.write_once()  # the final state lands on disk

    def __enter__(self) -> "FleetStatusWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
