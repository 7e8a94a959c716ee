"""Adaptive micro-batching: coalesce concurrent score requests into padded
device batches under a latency deadline (the Clipper recipe, NSDI 2017).

Counterpart of ``photon_ml_tpu/serving/batcher.py``: pure host threads. One
dispatcher thread makes every device call of a scorer: requests enqueue
from any number of server threads, the dispatcher blocks for the first
unit, then coalesces whatever arrives within ``max_delay_ms`` (or until
``max_batch`` rows), scores the whole batch in one engine call, and slices
results back to each caller's Future. Admission control is by queue depth
in ROWS: a request that would overflow ``queue_depth`` is shed at once with
a typed :class:`Overloaded` error (counted as ``serving.shed``).

Request-scoped traces (the reference's ``X-Photon-Trace`` records) are not
kept here; ``ctx`` is accepted and ignored.

Telemetry: ``serving.requests`` / ``serving.shed`` counters;
``serving.queue_ms`` (enqueue -> dispatch), ``serving.total_ms`` (enqueue
-> result) and ``serving.batch_size`` (rows per device dispatch)
histograms. Fault seams: ``serving.dispatch`` and
``serving.async_dispatch``.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Callable, Mapping, Sequence, Tuple

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.serving.engine import BadRequest

#: scorer contract: flat request rows -> (scores aligned to rows, version)
Scorer = Callable[[Sequence[Mapping]], Tuple[Sequence[float], str]]

# Injection seam on the batched device dispatch: a `raise` rule here is
# delivered to every rider of the batch as a scoring failure (callers see
# the typed error, the dispatcher survives); an `exit` rule is the serving
# process dying mid-request.
_FP_DISPATCH = faults.register_point(
    "serving.dispatch",
    description="micro-batched scoring dispatch (one engine call)",
)
# The continuous-batching dispatch (the async front end's scheduler): same
# delivery semantics as serving.dispatch, distinct seam so chaos runs can
# target the event-loop request path specifically.
_FP_ASYNC_DISPATCH = faults.register_point(
    "serving.async_dispatch",
    description="continuous-batching scoring dispatch (one engine call)",
)


class Overloaded(RuntimeError):
    """Admission control shed this request: the pending queue is at
    capacity. Callers should back off and retry; servers map this to
    HTTP 503."""


class Draining(RuntimeError):
    """The server is draining (SIGTERM graceful stop): admission is
    closed while in-flight batches finish. Servers map this to HTTP 503
    WITH a ``Retry-After`` header — callers should re-resolve and retry
    against a peer, the replacement process, or later."""


class _Unit:
    __slots__ = ("rows", "future", "t_enqueue")

    def __init__(self, rows):
        self.rows = rows
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


class MicroBatcher:
    """Deadline-bounded request coalescing in front of a scorer."""

    #: injection seam this batcher's dispatch fires (subclasses override)
    _fault_seam = _FP_DISPATCH

    def __init__(
        self,
        scorer: Scorer,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        queue_depth: int = 256,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._scorer = scorer
        self.max_batch = int(max_batch)
        self.max_delay_ms = max_delay_ms
        self.queue_depth = int(queue_depth)
        self._cv = threading.Condition()
        self._queue: collections.deque[_Unit] = collections.deque()
        self._pending_rows = 0
        self._running = False
        self._thread = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._cv:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="micro-batcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting work and DRAIN: queued units are still scored
        before the dispatcher exits (in-flight requests finish)."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- producer side -------------------------------------------------------

    def submit(self, rows: Sequence[Mapping], ctx=None) -> Future:
        """Enqueue one request unit; resolves to
        ``{"scores": <aligned array>, "model_version": <str>}``. ``ctx``
        (the reference's trace context) is accepted and not kept."""
        unit = _Unit(list(rows))
        if len(unit.rows) > self.queue_depth:
            # shedding this as Overloaded would invite a retry that can
            # NEVER succeed — it is a malformed request, not back-pressure
            raise BadRequest(
                f"request of {len(unit.rows)} rows exceeds the server's "
                f"queue depth ({self.queue_depth}); split it into smaller "
                f"requests"
            )
        with self._cv:
            if not self._running:
                raise RuntimeError("MicroBatcher is not running")
            if self._pending_rows + len(unit.rows) > self.queue_depth:
                telemetry.counter("serving.shed").inc()
                raise Overloaded(
                    f"queue at capacity: {self._pending_rows} rows pending, "
                    f"depth {self.queue_depth}"
                )
            self._queue.append(unit)
            self._pending_rows += len(unit.rows)
            telemetry.counter("serving.requests").inc()
            self._cv.notify_all()
        return unit.future

    # -- dispatcher side -----------------------------------------------------

    def _collect(self) -> list[_Unit]:
        """Block for the first unit, then coalesce until ``max_batch``
        rows are gathered or the delay deadline passes. A single unit
        larger than ``max_batch`` dispatches alone (the engine chunks
        internally)."""
        with self._cv:
            # untimed wait: submit() and stop() both notify under the lock,
            # so an idle dispatcher sleeps instead of polling
            while self._running and not self._queue:
                self._cv.wait()
            if not self._queue:
                return []
            units = [self._queue.popleft()]
            total = len(units[0].rows)
            deadline = time.monotonic() + self.max_delay_ms / 1000.0
            while total < self.max_batch:
                if self._queue:
                    if total + len(self._queue[0].rows) > self.max_batch:
                        break
                    nxt = self._queue.popleft()
                    units.append(nxt)
                    total += len(nxt.rows)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._running:
                    break
                self._cv.wait(timeout=remaining)
            self._pending_rows -= total
            return units

    @staticmethod
    def _deliver(unit: _Unit, result=None, error=None) -> None:
        """set_result/set_exception tolerant of a caller that gave up:
        a timed-out request cancels its future, and InvalidStateError
        must not kill the dispatcher."""
        try:
            if error is not None:
                unit.future.set_exception(error)
            else:
                unit.future.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled/abandoned future
            pass

    def _dispatch(self, units: list[_Unit]) -> None:
        # drop units whose callers timed out and cancelled: scoring work
        # nobody will read amplifies overload instead of shedding it
        units = [u for u in units if not u.future.cancelled()]
        if not units:
            return
        t0 = time.monotonic()
        queue_ms = telemetry.histogram("serving.queue_ms")
        for u in units:
            queue_ms.observe((t0 - u.t_enqueue) * 1000.0)
        flat = [r for u in units for r in u.rows]
        telemetry.histogram("serving.batch_size").observe(len(flat))
        try:
            faults.fault_point(self._fault_seam)
            scores, version = self._scorer(flat)
        except Exception as e:  # noqa: BLE001 — failure belongs to callers
            if len(units) == 1:
                self._deliver(units[0], error=e)
            else:
                # isolate the offender: one malformed co-batched request
                # must not fail the valid ones riding the same batch
                for u in units:
                    try:
                        s, v = self._scorer(u.rows)
                        self._deliver(u, result={"scores": s, "model_version": v})
                    except Exception as unit_err:  # noqa: BLE001
                        self._deliver(u, error=unit_err)
            return
        t1 = time.monotonic()
        total_ms = telemetry.histogram("serving.total_ms")
        offset = 0
        for u in units:
            k = len(u.rows)
            self._deliver(u, result={"scores": scores[offset:offset + k],
                                     "model_version": version})
            total_ms.observe((t1 - u.t_enqueue) * 1000.0)
            offset += k

    def _loop(self) -> None:
        while True:
            units = self._collect()
            if units:
                self._dispatch(units)
                continue
            with self._cv:
                if not self._running and not self._queue:
                    return


class ContinuousBatcher(MicroBatcher):
    """Continuous batching: the device is never idle while work is queued.

    :class:`MicroBatcher` holds the first request of every batch hostage
    to the ``max_delay_ms`` deadline hoping co-riders arrive — the right
    trade for a mostly-idle server, the wrong one under sustained load,
    where the deadline only ADDS latency: while one batch runs on the
    device, the next has already formed in the queue. This scheduler
    instead dispatches IMMEDIATELY with whatever is queued (up to
    ``max_batch`` rows): requests arriving while a batch is in flight are
    admitted into the next bucket the moment device capacity frees —
    batch size grows naturally with offered load (1 at idle, ``max_batch``
    at saturation), and no request ever waits on a timer.

    ``max_delay_ms`` is accepted for signature compatibility and ignored.
    Admission control (queue depth in rows -> typed :class:`Overloaded`),
    oversized-request rejection (:class:`BadRequest`), cancelled-future
    dropping, and co-rider error isolation are all inherited unchanged —
    one semantics, two scheduling policies.
    """

    _fault_seam = _FP_ASYNC_DISPATCH

    def _collect(self) -> list[_Unit]:
        """Block until at least one unit is queued, then take as many
        whole units as fit in ``max_batch`` rows WITHOUT waiting for
        more. A single unit larger than ``max_batch`` dispatches alone
        (the engine chunks internally)."""
        with self._cv:
            while self._running and not self._queue:
                self._cv.wait()
            if not self._queue:
                return []
            units = [self._queue.popleft()]
            total = len(units[0].rows)
            while (
                self._queue
                and total + len(self._queue[0].rows) <= self.max_batch
            ):
                nxt = self._queue.popleft()
                units.append(nxt)
                total += len(nxt.rows)
            self._pending_rows -= total
            return units
