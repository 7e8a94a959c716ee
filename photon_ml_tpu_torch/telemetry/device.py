"""Device accounting: the sanctioned device-to-host copy and the compile
counters.

Counterpart of ``photon_ml_tpu/telemetry/device.py``, with its metric names:

- :func:`sync_fetch` is the one place a solve or request path copies from
  the device to the host. It counts ``host_syncs`` / ``host_sync_bytes`` and
  the reference's ``device_fetches`` / ``device_fetch_bytes`` /
  ``device_fetch_seconds`` (counter and histogram), and stamps a
  ``device_fetch`` event on the open span.
- the compile counters: the port's one real compile is the ``nvcc`` build
  of the kernels (``kernels/build.py`` ``build()``); every build that runs
  ``nvcc`` (not a cached library) reports itself through
  :func:`record_compile`, which counts
  ``jit_compiles``, the ``jit_compile_seconds`` counter and histogram, and
  stamps a ``compile`` event on the open span. PyTorch's eager mode has no
  per-shape compile, so there is no recompile counter here.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.telemetry import metrics, trace

__all__ = ["sync_fetch", "install_compile_hooks", "record_compile"]


def sync_fetch(t, label: Optional[str] = None) -> np.ndarray:
    """Copy ``t`` to the host as numpy (one device-to-host copy, which waits
    for the work that produced it) and account for it: ``host_syncs`` and
    ``host_sync_bytes``, the reference's ``device_fetches`` /
    ``device_fetch_bytes`` / ``device_fetch_seconds``, and a
    ``device_fetch`` event on the open span."""
    t0 = time.monotonic()
    out = t.detach().cpu().numpy()
    dt = time.monotonic() - t0
    nbytes = int(out.nbytes)
    metrics.counter("host_syncs").inc()
    metrics.counter("host_sync_bytes").inc(nbytes)
    metrics.counter("device_fetches").inc()
    metrics.counter("device_fetch_bytes").inc(nbytes)
    metrics.counter("device_fetch_seconds").inc(dt)
    metrics.histogram("device_fetch_seconds").observe(dt)
    trace.add_event("device_fetch", label=label, bytes=nbytes, seconds=round(dt, 6))
    return out


def install_compile_hooks() -> bool:
    """The reference's hook installer: here the kernels' build reports each
    ``nvcc`` run itself (:func:`record_compile`), so the counters are always
    armed. Returns True."""
    return True


def record_compile(seconds: float) -> None:
    """Account one compile of ``seconds`` (the kernels' ``nvcc`` build):
    ``jit_compiles``, ``jit_compile_seconds`` (counter and histogram) and a
    ``compile`` event on the open span. Never raises into the build."""
    try:
        metrics.counter("jit_compiles").inc()
        metrics.counter("jit_compile_seconds").inc(seconds)
        metrics.histogram("jit_compile_seconds").observe(seconds)
        trace.add_event("compile", seconds=round(seconds, 6))
    except Exception:  # noqa: BLE001 — accounting never fails a build
        pass
