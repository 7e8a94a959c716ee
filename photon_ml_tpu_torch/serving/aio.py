"""Event-loop serving front end: one asyncio loop instead of one thread
per connection.

Counterpart of ``photon_ml_tpu/serving/aio.py``. :class:`AsyncScoringServer`
serves the endpoints of :mod:`photon_ml_tpu_torch.serving.server` from ONE
event loop on a background thread:

- ``POST /v1/score`` enqueues into the shared batcher and ``await``s the
  wrapped future — the device work stays on the batcher's dispatcher
  thread, the loop is free to accept, parse and answer while batches run;
- ``GET /healthz`` / ``GET /metricsz`` are answered directly on the loop
  from the telemetry registries — they never queue behind scoring, so they
  stay responsive while scoring is wedged or saturated;
- ``POST /v1/update`` feeds nearline events to an attached updater;
  ``POST /v1/margins`` and the admin routes run in the loop's executor.

Error semantics are the threading front end's: Overloaded -> 503,
BadRequest -> 400, timeout -> 504 (the future is cancelled so the
dispatcher drops the dead unit), anything else -> 500 without killing the
server. HTTP/1.1 keep-alive is supported; malformed requests close the
connection. An ``X-Photon-Trace`` header tags the request's record with the
caller's trace ids, as on the threading front end.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import threading
from typing import Optional

from photon_ml_tpu_torch.serving.batcher import Draining, Overloaded
from photon_ml_tpu_torch.serving.engine import BadRequest
from photon_ml_tpu_torch.telemetry import requests as request_trace
from photon_ml_tpu_torch.serving.server import (
    DRAIN_RETRY_AFTER_S,
    ScoringService,
    _json_scores,
)

logger = logging.getLogger("photon_ml_tpu_torch.serving.aio")

_MAX_HEADER_LINES = 128
_MAX_BODY_BYTES = 64 * 1024 * 1024


class AsyncScoringServer:
    """Asyncio HTTP front end with the same lifecycle surface as
    :class:`~photon_ml_tpu_torch.serving.server.ScoringServer` (``start()`` /
    ``stop()`` / ``.port``), so drivers and tests swap front ends with
    one flag. The loop runs on a dedicated background thread; the caller
    keeps a plain blocking API."""

    def __init__(
        self,
        service: ScoringService,
        host: str = "127.0.0.1",
        port: int = 8080,
    ):
        self.service = service
        self._host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._lock = threading.Lock()
        self._startup_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncScoringServer":
        self.service.start()
        self._ready.clear()
        with self._lock:
            self._startup_error = None
        self._thread = threading.Thread(
            target=self._run, name="scoring-aio", daemon=True
        )
        self._thread.start()
        self._ready.wait(timeout=30)
        with self._lock:
            if self._startup_error is not None:
                raise self._startup_error
        if self.port is None:
            raise RuntimeError("async scoring server failed to start")
        return self

    def stop(self) -> None:
        loop, stop_event = self._loop, self._stop_event
        if loop is not None and stop_event is not None:
            loop.call_soon_threadsafe(stop_event.set)
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.service.stop()

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:  # noqa: BLE001 — surfaced to start()
            with self._lock:
                self._startup_error = e
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        server = await asyncio.start_server(
            self._handle, self._host, self._requested_port
        )
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            async with server:
                await self._stop_event.wait()
        finally:
            self._loop = None
            self._stop_event = None

    # -- connection handling -------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                method, path, headers, body = request
                code, obj, extra = await self._route(
                    method, path, body, headers
                )
                await self._reply(writer, code, obj, extra)
                if headers.get("connection", "").lower() == "close":
                    break
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            ValueError,
        ):
            pass  # client went away / sent garbage: drop the connection
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        """Parse one HTTP/1.1 request; None at a clean EOF between
        requests (keep-alive close)."""
        request_line = await reader.readline()
        if not request_line or request_line in (b"\r\n", b"\n"):
            return None
        parts = request_line.decode("latin-1").split()
        if len(parts) < 2:
            raise ValueError("malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers: dict[str, str] = {}
        for _ in range(_MAX_HEADER_LINES):
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, sep, value = line.decode("latin-1").partition(":")
            if sep:
                headers[key.strip().lower()] = value.strip()
        else:
            raise ValueError("too many header lines")
        length = int(headers.get("content-length") or 0)
        if length < 0 or length > _MAX_BODY_BYTES:
            raise ValueError(f"bad content-length {length}")
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _reply(
        self,
        writer: asyncio.StreamWriter,
        code: int,
        obj,
        extra_headers: Optional[dict] = None,
    ) -> None:
        body = json.dumps(obj, default=float).encode("utf-8")
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  409: "Conflict", 503: "Service Unavailable",
                  504: "Gateway Timeout",
                  500: "Internal Server Error"}.get(code, "OK")
        extras = "".join(
            f"{name}: {value}\r\n"
            for name, value in (extra_headers or {}).items()
        )
        writer.write(
            (
                f"HTTP/1.1 {code} {reason}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extras}"
                "\r\n"
            ).encode("latin-1")
            + body
        )
        await writer.drain()

    # -- routing -------------------------------------------------------------

    _POST_PATHS = (
        "/v1/score",
        "/v1/update",
        "/v1/margins",
        "/v1/admin/stage",
        "/v1/admin/commit",
    )

    async def _route(
        self,
        method: str,
        path: str,
        body: bytes,
        headers: Optional[dict] = None,
    ):
        """Returns ``(code, obj, extra_headers_or_None)``."""
        if method == "GET":
            # answered inline on the loop — NEVER behind the batcher, so
            # health/metrics stay responsive however loaded scoring is
            if path == "/healthz":
                return 200, self.service.health(), None
            if path == "/metricsz":
                return 200, self.service.metrics(), None
            return 404, {"error": f"unknown path {path}"}, None
        if method != "POST" or path not in self._POST_PATHS:
            return 404, {"error": f"unknown path {path}"}, None
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            return 400, {"error": "bad_request",
                         "detail": "body is not valid JSON"}, None
        # _read_request lowercases the header names; a malformed trace
        # header parses to None and the request goes on untraced
        ctx = request_trace.parse_header((headers or {}).get(request_trace.TRACE_HEADER.lower()))
        loop = asyncio.get_running_loop()
        try:
            if path == "/v1/update":
                return 200, self.service.update_request(payload), None
            if path == "/v1/margins":
                # device work runs off-loop: the margin fold is a blocking
                # engine call, and the loop must keep accepting traffic
                result = await loop.run_in_executor(
                    None,
                    functools.partial(self.service.margin_request, payload, ctx=ctx),
                )
                return 200, result, None
            if path.startswith("/v1/admin/"):
                op = path.rsplit("/", 1)[1]
                # stage loads+warms a whole shard engine — seconds of
                # blocking work that must not stall the event loop
                result = await loop.run_in_executor(
                    None, self.service.admin_request, op, payload
                )
                return 200, result, None
            return 200, await self._score(payload, ctx), None
        except Draining as e:
            return (
                503,
                {"error": "draining", "detail": str(e)},
                {"Retry-After": str(DRAIN_RETRY_AFTER_S)},
            )
        except Overloaded as e:
            return 503, {"error": "overloaded", "detail": str(e)}, None
        except BadRequest as e:
            return 400, {"error": "bad_request", "detail": str(e)}, None
        except KeyError as e:
            # a version pin the member cannot honor (mid-swap window): the
            # router sheds this member for the request, never blends
            return 409, {"error": "version_unavailable", "detail": str(e)}, None
        except asyncio.TimeoutError:
            return 504, {"error": "timeout"}, None
        except Exception as e:  # noqa: BLE001 — a request must not kill the loop
            logger.exception("async score request failed")
            return 500, {"error": "internal", "detail": str(e)}, None

    async def _score(self, payload, ctx=None) -> dict:
        """Submit to the shared batcher and await the wrapped future —
        the loop stays free while the batch runs on the device."""
        future = self.service.submit_rows(payload, ctx=ctx)
        try:
            result = await asyncio.wait_for(
                asyncio.wrap_future(future),
                timeout=self.service.request_timeout_s,
            )
        except asyncio.TimeoutError:
            # same contract as the blocking path: cancel so the
            # dispatcher drops the unit instead of scoring dead work
            future.cancel()
            raise
        return _json_scores(result)
