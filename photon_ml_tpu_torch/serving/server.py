"""Serving front ends: a stdlib threading HTTP server and a stdio JSONL
mode (so tests and drivers exercise the full request schema without
sockets).

Counterpart of ``photon_ml_tpu/serving/server.py``. Endpoints:

- ``POST /v1/score`` — body ``{"rows": [<row>, ...]}`` (the row schema of
  :mod:`photon_ml_tpu_torch.serving.engine`); responds ``{"scores": [...],
  "model_version": "v-..."}`` through the batcher, so concurrent callers
  share device batches. Overload -> 503 ``{"error": "overloaded"}``;
  malformed rows -> 400;
- ``POST /v1/margins`` — raw margins with a per-row ``include_fixed`` (the
  fleet-member protocol); ``POST /v1/update`` — nearline feedback events;
  ``POST /v1/admin/stage`` / ``commit`` — answered 400 (no shard-owning
  fleet member in this package);
- ``GET /healthz`` — ``{"status", "model_version", "warm", "buckets", ...}``;
  ``GET /metricsz`` — the telemetry ``snapshot()``.

The stdio mode reads one JSON object per stdin line (``{"rows": [...]}``
scores; ``{"op": "health"}`` / ``{"op": "metrics"}`` introspect) and writes
one JSON response line to stdout; it scores directly on the engine (no
batcher threads), so a driver loop is deterministic. Request-scoped traces
(``X-Photon-Trace``) are not kept.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    Draining,
    MicroBatcher,
    Overloaded,
)
from photon_ml_tpu_torch.serving.engine import BadRequest, ScoringEngine

#: the Retry-After hint (seconds) on draining 503s — long enough for a
#: drain + relaunch, short enough that a router's next probe finds the
#: replacement
DRAIN_RETRY_AFTER_S = 2

logger = logging.getLogger("photon_ml_tpu_torch.serving.server")


def _engine_of(source) -> ScoringEngine:
    """Accept a bare engine or anything with an ``.engine`` property
    (the ModelRegistry), so one front end serves both static and
    hot-swapped deployments."""
    return source.engine if hasattr(source, "engine") else source


def _metrics_payload() -> dict:
    """The ``/metricsz`` body: the telemetry snapshot."""
    return dict(telemetry.snapshot())


def _json_scores(result: Mapping) -> dict:
    """Shape one batcher result for the wire (shared by the threading
    and asyncio front ends)."""
    return {
        # host numpy already: the engine fetched it through sync_fetch
        "scores": [round(float(s), 8) for s in result["scores"]],
        "model_version": result["model_version"],
    }


class ScoringService:
    """Engine-or-registry + batcher glue shared by the threading HTTP,
    asyncio HTTP, and stdio front ends.

    The batcher's scorer resolves the CURRENT engine at dispatch time, so
    a registry swap takes effect on the next batch while the batch already
    in flight finishes on the engine reference it grabbed.

    ``batcher="continuous"`` swaps the fixed-deadline
    :class:`MicroBatcher` for the :class:`ContinuousBatcher` (admit rows
    into the next in-flight bucket as device capacity frees — the async
    front end's default scheduler). :meth:`health` and
    :meth:`metrics` never touch the batcher or its locks: a wedged or
    saturated scoring path must not take the health surface down with it
    (asserted by a responsiveness test)."""

    # a class-level default so hand-assembled instances (tests build
    # wedged services via ``__new__`` to inject custom scorers) admit
    # requests without tripping on an attribute __init__ would have set
    _draining = False

    def __init__(
        self,
        source,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        queue_depth: int = 256,
        request_timeout_s: float = 30.0,
        batcher: str = "deadline",
    ):
        self._source = source
        self.request_timeout_s = request_timeout_s
        if batcher not in ("deadline", "continuous"):
            raise ValueError(
                f"batcher must be 'deadline' or 'continuous', got {batcher!r}"
            )
        batcher_cls = (
            ContinuousBatcher if batcher == "continuous" else MicroBatcher
        )
        self._batcher = batcher_cls(
            self._score,
            max_batch=max_batch,
            max_delay_ms=max_delay_ms,
            queue_depth=queue_depth,
        )
        self._updater = None
        self._draining = False

    def _score(self, rows):
        engine = _engine_of(self._source)
        return engine.score_rows(rows), engine.version

    def start(self) -> "ScoringService":
        self._batcher.start()
        if self._updater is not None:
            self._updater.start()
        return self

    def stop(self) -> None:
        self._batcher.stop()
        if self._updater is not None:
            self._updater.stop()

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """The graceful-stop half of the training ``GracefulStop``
        contract, serving-side: close admission FIRST (new requests get
        :class:`Draining` -> 503 + ``Retry-After``), then drain —
        ``batcher.stop()`` joins the dispatcher only after every
        already-admitted unit has been scored and delivered. Idempotent;
        safe from a signal-handling thread."""
        self._draining = True
        telemetry.counter("serving.drains").inc()
        self._batcher.stop()
        if self._updater is not None:
            self._updater.stop()

    # -- nearline ------------------------------------------------------------

    def attach_nearline(self, updater) -> "ScoringService":
        """Attach a :class:`~photon_ml_tpu_torch.serving.nearline
        .NearlineUpdater`; both front ends then accept ``POST
        /v1/update`` events, and the updater's lifecycle follows the
        service's."""
        self._updater = updater
        return self

    def update_request(self, payload: Mapping) -> dict:
        """Handle one ``/v1/update`` body: ``{"events": [...]}`` (see
        serving/nearline.py for the event schema)."""
        if self._draining:
            raise Draining("server is draining; retry elsewhere")
        if self._updater is None:
            raise BadRequest(
                "nearline updates are not enabled on this server"
            )
        events = (
            payload.get("events") if isinstance(payload, Mapping) else None
        )
        if not isinstance(events, list):
            raise BadRequest('request body must be {"events": [...]}')
        accepted = self._updater.submit(events)
        return {"accepted": accepted}

    # -- scoring -------------------------------------------------------------

    def submit_rows(self, payload: Mapping, ctx=None):
        """Validate one ``/v1/score`` body and enqueue it; the batcher
        Future (resolves to ``{"scores", "model_version"}``). Shared by
        the blocking (:meth:`score_request`) and asyncio front ends.
        ``ctx`` (the reference's trace context) is accepted and not kept."""
        if self._draining:
            raise Draining("server is draining; retry elsewhere")
        rows = payload.get("rows") if isinstance(payload, Mapping) else None
        if not isinstance(rows, list):
            raise BadRequest('request body must be {"rows": [...]}')
        return self._batcher.submit(rows, ctx=ctx)

    # -- the fleet-member endpoints ------------------------------------------

    def margin_request(self, payload: Mapping, ctx=None) -> dict:
        """One ``/v1/margins`` body — a fleet router's fan-out unit:
        ``{"rows": [...], "include_fixed": [bool, ...]?}``. Scores DIRECTLY
        on the current engine and returns full-precision margins (the fold
        is exact, so no wire rounding). ``ctx`` is accepted and not kept."""
        if self._draining:
            raise Draining("server is draining; retry elsewhere")
        if not isinstance(payload, Mapping):
            raise BadRequest('request body must be {"rows": [...]}')
        rows = payload.get("rows")
        if not isinstance(rows, list):
            raise BadRequest('request body must be {"rows": [...]}')
        engine = _engine_of(self._source)
        include_fixed = payload.get("include_fixed")
        if include_fixed is not None and not isinstance(include_fixed, list):
            raise BadRequest("include_fixed must be a list of booleans")
        telemetry.counter("serving.requests").inc()
        margins = engine.margin_rows(rows, include_fixed)
        return {
            "margins": [float(m) for m in margins],
            "model_version": engine.version,
        }

    def admin_request(self, op: str, payload: Mapping) -> dict:
        """``/v1/admin/stage`` / ``/v1/admin/commit`` — the resize and
        hot-swap barrier of a shard-owning fleet member, which this package
        does not have yet (ROADMAP Queue 1 item 14a (ii)): always 400."""
        raise BadRequest("this server is not a shard-owning fleet member")

    def score_request(self, payload: Mapping, ctx=None) -> dict:
        future = self.submit_rows(payload, ctx=ctx)
        try:
            result = future.result(timeout=self.request_timeout_s)
        except FutureTimeout:
            # nobody will read this result: cancel so the dispatcher drops
            # the unit instead of scoring dead work under overload
            future.cancel()
            raise
        return _json_scores(result)

    def metrics(self) -> dict:
        """The ``/metricsz`` body — reads telemetry registries only,
        never the batcher (stays responsive mid-warmup / mid-swap)."""
        return _metrics_payload()

    def health(self) -> dict:
        try:
            engine = _engine_of(self._source)
        except RuntimeError as e:
            return {"status": "loading", "model_version": None,
                    "warm": False, "detail": str(e)}
        state = {
            "status": "draining" if self._draining else "serving",
            "model_version": engine.version,
            "warm": engine.warm,
            "buckets": list(engine.bucket_sizes),
            "task": engine.task,
        }
        if getattr(engine, "entity_axis", None) is not None:
            # entity-sharded deployment: which axis the RE tables span
            state["entity_axis"] = engine.entity_axis
        if getattr(engine, "nearline_seq", 0):
            state["nearline_seq"] = engine.nearline_seq
        if getattr(engine, "lineage", None):
            # training ancestry of the served version (incremental
            # retrains: base checkpoint + delta digest, registry lineage)
            state["lineage"] = engine.lineage
        if engine.warm:
            # per batch-size bucket: the warm-up call's seconds and the
            # calls served
            state["compile"] = engine.compile_summary()
        return state


class _Handler(BaseHTTPRequestHandler):
    server_version = "photon-serve/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: requests go to telemetry
        logger.debug(fmt, *args)

    def _reply(self, code: int, obj, headers: Optional[dict] = None) -> None:
        body = json.dumps(obj, default=float).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        service: ScoringService = self.server.service  # type: ignore[attr-defined]
        if self.path == "/healthz":
            self._reply(200, service.health())
        elif self.path == "/metricsz":
            self._reply(200, _metrics_payload())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    _POST_PATHS = (
        "/v1/score", "/v1/update", "/v1/margins",
        "/v1/admin/stage", "/v1/admin/commit",
    )

    def do_POST(self):  # noqa: N802
        service: ScoringService = self.server.service  # type: ignore[attr-defined]
        if self.path not in self._POST_PATHS:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            self._reply(400, {"error": "bad_request",
                              "detail": "body is not valid JSON"})
            return
        try:
            if self.path == "/v1/update":
                self._reply(200, service.update_request(payload))
            elif self.path == "/v1/margins":
                self._reply(200, service.margin_request(payload))
            elif self.path.startswith("/v1/admin/"):
                op = self.path.rsplit("/", 1)[1]
                self._reply(200, service.admin_request(op, payload))
            else:
                self._reply(200, service.score_request(payload))
        except Draining as e:
            self._reply(
                503, {"error": "draining", "detail": str(e)},
                headers={"Retry-After": str(DRAIN_RETRY_AFTER_S)},
            )
        except Overloaded as e:
            self._reply(503, {"error": "overloaded", "detail": str(e)})
        except BadRequest as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})
        except FutureTimeout:
            self._reply(504, {"error": "timeout"})
        except Exception as e:  # noqa: BLE001 — a request must not kill the server
            logger.exception("score request failed")
            self._reply(500, {"error": "internal", "detail": str(e)})


class ScoringServer:
    """``ThreadingHTTPServer`` wrapper owning the service lifecycle."""

    def __init__(self, service: ScoringService, host: str = "127.0.0.1",
                 port: int = 8080):
        self.service = service
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service = service  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ScoringServer":
        self.service.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="scoring-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.service.stop()


def serve_stdio(source, inp, out) -> int:
    """JSONL request/response loop over text streams (no sockets, no
    batcher threads — deterministic for CI drivers). Returns 0 at EOF."""
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            request = json.loads(line)
        except ValueError as e:
            out.write(json.dumps({"error": f"bad JSON: {e}"}) + "\n")
            out.flush()
            continue
        try:
            op = request.get("op") if isinstance(request, Mapping) else None
            if op == "health":
                engine = _engine_of(source)
                response = {
                    "status": "serving",
                    "model_version": engine.version,
                    "warm": engine.warm,
                    "buckets": list(engine.bucket_sizes),
                }
                if engine.warm:
                    response["compile"] = engine.compile_summary()
            elif op == "metrics":
                response = _metrics_payload()
            else:
                rows = (
                    request.get("rows")
                    if isinstance(request, Mapping) else None
                )
                if not isinstance(rows, list):
                    raise BadRequest(
                        'each line must be {"rows": [...]} or {"op": ...}'
                    )
                engine = _engine_of(source)
                telemetry.counter("serving.requests").inc()
                scores = engine.score_rows(rows)
                response = {
                    "scores": [round(float(s), 8) for s in scores],
                    "model_version": engine.version,
                }
        except (BadRequest, ValueError, RuntimeError) as e:
            response = {"error": str(e)}
        out.write(json.dumps(response) + "\n")
        out.flush()
    return 0
