"""A minimal telemetry shim: named spans and counters.

Counterpart of the call sites of ``photon_ml_tpu/telemetry`` (``span``,
``counter``) so later slices keep the reference's instrumentation points.
There is no jit accounting and no sink: spans add their wall time to a
per-name total, counters count. ``snapshot()`` reads both, ``reset()``
clears them.
"""

from __future__ import annotations

import contextlib
import threading
import time

_lock = threading.Lock()
_counters: dict[str, int] = {}
_span_seconds: dict[str, float] = {}


class _Counter:
    def __init__(self, name: str):
        self.name = name

    def inc(self, n: int = 1) -> None:
        with _lock:
            _counters[self.name] = _counters.get(self.name, 0) + n


def counter(name: str) -> _Counter:
    return _Counter(name)


@contextlib.contextmanager
def span(name: str, **_attrs):
    """Time the enclosed block on the host clock (no device sync). The
    attributes of the reference's call sites are accepted and not kept."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _span_seconds[name] = _span_seconds.get(name, 0.0) + dt


def snapshot() -> dict:
    with _lock:
        return {"counters": dict(_counters), "span_seconds": dict(_span_seconds)}


def reset() -> None:
    with _lock:
        _counters.clear()
        _span_seconds.clear()
