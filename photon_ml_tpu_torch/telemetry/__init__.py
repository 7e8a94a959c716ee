"""Telemetry: named spans, and the metrics registry's counters, gauges and
histograms.

Counterpart of the call sites of ``photon_ml_tpu/telemetry`` (``span``,
``counter``, ``gauge``, ``histogram``, ``sync_fetch``) so the port keeps the
reference's instrumentation points. There is no jit accounting and no trace
sink: spans add their wall time to a per-name total, and the metrics live in
``telemetry.metrics`` (the reference's registry, copied). ``snapshot()``
reads all of them (plus the sections of ``register_snapshot_provider``, such
as the quality layer's drift rows), ``peek_gauge`` one gauge, ``reset()``
clears them.

``sync_fetch(t, label)`` is the one sanctioned device-to-host copy of a
request path (the counterpart of ``telemetry/device.py:47``): it copies once
and counts ``host_syncs``.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from photon_ml_tpu_torch.telemetry import metrics
from photon_ml_tpu_torch.telemetry.metrics import (  # noqa: F401
    counter,
    gauge,
    histogram,
    peek_counter,
    peek_gauge,
    register_snapshot_provider,
)

_lock = threading.Lock()
_span_seconds: dict[str, float] = {}


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


def sync_fetch(t, label: str | None = None) -> np.ndarray:
    """Copy ``t`` to the host as numpy (one device-to-host copy, which waits
    for the work that produced it) and count it in ``host_syncs`` and
    ``host_sync_bytes``. ``label`` names the crossing in the reference's
    call sites and is not kept."""
    out = t.detach().cpu().numpy()
    metrics.counter("host_syncs").inc()
    metrics.counter("host_sync_bytes").inc(int(out.nbytes))
    return out


def snapshot() -> dict:
    """``counters``, ``gauges`` and ``histograms`` of the registry, the
    ``span_seconds`` totals, and every provider's section."""
    snap = metrics.snapshot()
    with _lock:
        snap["span_seconds"] = dict(_span_seconds)
    return snap


def reset() -> None:
    """Clear the spans and the registry's metrics (providers stay)."""
    with _lock:
        _span_seconds.clear()
    metrics.reset()
