"""``double_buffered``: the generic bounded background feeder.

Counterpart of ``photon_ml_tpu/ingest/prefetch.py``, copied. The chunk
feeding of ``game/streaming.py`` (upload chunk i+1, then solve chunk i) is
a pipeline pattern, not a trainer concern: this is its one home. A worker
thread runs ``feed(item)`` up to ``depth`` items ahead of the consumer
behind a bounded queue; the consumer iterates ``(item, fed)`` pairs in
order. Feeding in a real thread (instead of relying purely on async
dispatch) also overlaps HOST-side feed work — decode, pinning, retry
sleeps — with the solve, which CUDA's asynchronous launches alone never
could.

Stall protocol matches the ingest pipeline: a consumer wait beyond
``stall_timeout_s`` raises :class:`IngestStall` (counter
``ingest.stalls``); feeder exceptions surface on the consumer thread at
the position they occurred, preserving error semantics of the old
inline loop.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.ingest.errors import IngestStall

T = TypeVar("T")
R = TypeVar("R")

_END = object()


def double_buffered(
    items: Iterable[T],
    feed: Callable[[T], R],
    depth: int = 1,
    stall_timeout_s: float = 600.0,
    name: str = "prefetch",
) -> Iterator[Tuple[T, R]]:
    """Yield ``(item, feed(item))`` in order, feeding up to ``depth``
    items ahead in a background thread.

    ``depth=1`` is classic double buffering: the feeder prepares item
    i+1 while the consumer works on item i. Abandoning the generator
    (break / GeneratorExit) tears the feeder down promptly.
    """
    if depth < 1:
        raise ValueError("double_buffered depth must be >= 1")
    out: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    state_lock = threading.Lock()
    state: dict = {"error": None, "at": None}

    def _run() -> None:
        try:
            for item in items:
                if stop.is_set():
                    return
                with telemetry.span(f"{name}_feed"):
                    fed = feed(item)
                while not stop.is_set():
                    try:
                        out.put((item, fed), timeout=0.25)
                        break
                    except queue.Full:
                        continue
            while not stop.is_set():
                try:
                    out.put(_END, timeout=0.25)
                    return
                except queue.Full:
                    continue
        except BaseException as e:  # surface on the consumer thread
            with state_lock:
                state["error"] = e

    worker = threading.Thread(
        target=_run, name=f"{name}-feeder", daemon=True
    )
    worker.start()
    try:
        while True:
            t0 = time.monotonic()
            while True:
                # drain queued (successfully fed) items BEFORE surfacing
                # a feeder error: the old inline loop solved every chunk
                # fed ahead of the failure, and so must this one —
                # errors surface at the position they occurred
                try:
                    got = out.get_nowait()
                    break
                except queue.Empty:
                    pass
                with state_lock:
                    err = state["error"]
                if err is not None:
                    raise err
                try:
                    got = out.get(timeout=0.25)
                    break
                except queue.Empty:
                    if time.monotonic() - t0 > stall_timeout_s:
                        telemetry.counter("ingest.stalls").inc()
                        raise IngestStall(
                            "consume", stall_timeout_s,
                            f"{name} feeder produced nothing",
                        ) from None
            if got is _END:
                return
            yield got
    finally:
        stop.set()
        # unblock a put-blocked feeder so the join cannot hang
        while True:
            try:
                out.get_nowait()
            except queue.Empty:
                break
        worker.join(timeout=5.0)
