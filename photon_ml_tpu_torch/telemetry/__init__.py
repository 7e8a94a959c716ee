"""Telemetry: the span tree, the metrics registry, device-memory accounting,
the progress heartbeat and run reports.

Counterpart of ``photon_ml_tpu/telemetry``, with its record formats and
metric names, so both packages' artifacts read alike:

- :mod:`.trace`: ``span(name, **attrs)`` opens a node of a thread-safe span
  tree (host clock, no device sync) with a JSONL sink and a Chrome/Perfetto
  exporter; ``utils.timed()`` is a span too. ``snapshot()["span_seconds"]``
  keeps each span name's total seconds.
- :mod:`.metrics`: process-global counters, gauges and histograms (the
  reference's registry, copied) with a ``snapshot()`` and a JSONL flush.
- :mod:`.memory`: device-memory gauges from the caching allocator's host
  counters, per-phase peaks, table-size estimates and a headroom check.
- :mod:`.progress` / :mod:`.report`: the heartbeat daemon, and
  :class:`~.report.RunReport`, which merges trace, metrics and checkpoint
  manifests into one markdown/JSON report with a regression ``compare()``
  (``cli report``).
- :mod:`.identity`: per-member artifact suffixing in a fleet.
- :mod:`.requests`: request-scoped traces (``X-Photon-Trace``), the
  per-process ring with tail sampling, and the flight recorder
  (``flight_dump``, ``harvest_flight``).
- :mod:`.fleet_report`: :class:`~.fleet_report.FleetReport`, which merges a
  fleet directory of per-member streams into one report with per-member
  rows, the straggler, the clock skew, lost members' last words and the
  request traces joined across processes (``cli report --fleet``).

- :mod:`.device`: ``sync_fetch(t, label)``, the one sanctioned
  device-to-host copy of a solve or request path (it copies once, counts
  ``host_syncs`` and the reference's ``device_fetch*`` metrics, and stamps a
  ``device_fetch`` event on the open span), and the compile counters of the
  kernels' ``nvcc`` build (``jit_compiles``, ``jit_compile_seconds``).
- :mod:`.executables`: the executable accounting (the counterpart of the
  reference's ``telemetry/xla.py``): ``instrumented`` functions counted per
  shape signature, the kernels' modelled FLOPs and bytes
  (``kernels/cost.py``) on the open span, roofline peaks and ``comms.*``
  collective estimates (the report's "Device utilization").
- :mod:`.profile`: the sampled profiler: every instrumented call is counted
  and every Nth timed on the stream by CUDA events read once they have
  completed (no host sync), giving per-executable exclusive seconds, MFU,
  intensity and a bound class (the report's "Hot executables", the
  heartbeat's ``hot_exec``). Armed at import.

Typical use::

    from photon_ml_tpu_torch import telemetry

    telemetry.configure(trace_out="run.trace.jsonl")
    with telemetry.Heartbeat(interval=30, jsonl_path="run.metrics.jsonl"):
        with telemetry.span("fit", task="logistic"):
            ...
    telemetry.flush_metrics("run.metrics.jsonl")
    telemetry.export_chrome_trace("run.trace.jsonl", "run.perfetto.json")
"""

from __future__ import annotations

import os
from typing import Optional

from photon_ml_tpu_torch.telemetry import identity, memory, metrics, trace  # noqa: F401
from photon_ml_tpu_torch.telemetry import device, executables, profile  # noqa: F401
from photon_ml_tpu_torch.telemetry import requests  # noqa: F401  (needs trace)
from photon_ml_tpu_torch.telemetry.device import install_compile_hooks, sync_fetch  # noqa: F401
from photon_ml_tpu_torch.telemetry.executables import (  # noqa: F401
    EXECUTABLE_REGISTRY,
    account,
    instrumented,
    record_collective,
)
from photon_ml_tpu_torch.telemetry.identity import member_artifact_path  # noqa: F401
from photon_ml_tpu_torch.telemetry.metrics import (  # noqa: F401
    counter,
    gauge,
    histogram,
    peek_counter,
    peek_gauge,
    register_snapshot_provider,
)
from photon_ml_tpu_torch.telemetry.progress import Heartbeat  # noqa: F401
from photon_ml_tpu_torch.telemetry.trace import (  # noqa: F401
    active_span_path,
    add_event,
    current_span,
    export_chrome_trace,
    finished_spans,
    perfetto_path,
    span,
    to_chrome_trace,
)

# configure_from_env's side effects, remembered so reset() can undo them
_env_state: dict[str, object] = {"atexit_flush": None}


def configure(trace_out: Optional[str] = None, buffer_limit: Optional[int] = None) -> None:
    """Point the span JSONL sink at ``trace_out`` (None leaves it as is)."""
    trace.configure(jsonl_path=trace_out, buffer_limit=buffer_limit)


def flush_metrics(path: str) -> dict:
    """Append the metrics snapshot to ``path`` as one ``metrics`` line,
    after publishing the profiler's derived gauges (MFU, bound class), so a
    report loaded from the file alone renders the Hot-executables table."""
    profile.publish_metrics()
    return metrics.flush_jsonl(path)


def configure_from_env() -> None:
    """Honour ``PHOTON_TRACE_OUT`` (the span sink opens at once) and
    ``PHOTON_TELEMETRY_OUT`` (the metrics snapshot flushes at process
    exit), each suffixed per fleet member. ``reset()`` undoes both."""
    trace_out = os.environ.get("PHOTON_TRACE_OUT")
    if trace_out:
        configure(trace_out=identity.member_artifact_path(trace_out))
    metrics_out = os.environ.get("PHOTON_TELEMETRY_OUT")
    if metrics_out:
        import atexit
        import functools

        metrics_out = identity.member_artifact_path(metrics_out)
        old = _env_state["atexit_flush"]
        if old is not None:
            atexit.unregister(old)
        flush = functools.partial(flush_metrics, metrics_out)
        atexit.register(flush)
        _env_state["atexit_flush"] = flush


def snapshot() -> dict:
    """``counters``, ``gauges`` and ``histograms`` of the registry, every
    provider's section, and the ``span_seconds`` totals."""
    snap = metrics.snapshot()
    snap["span_seconds"] = trace.span_seconds()
    return snap


def reset() -> None:
    """Restore import-time defaults: clear the spans, the request ring and
    the registry's metrics (providers stay), close the trace sink, restore
    the default buffer limit, drop an injected memory-stats provider, and
    unregister the ``configure_from_env`` exit flush; clear the executable
    and profile registries and arm the sampler again."""
    trace.reset()
    metrics.reset()
    memory.reset()
    executables.reset()
    profile.reset()
    requests.reset()
    flush = _env_state["atexit_flush"]
    if flush is not None:
        import atexit

        atexit.unregister(flush)
        _env_state["atexit_flush"] = None


# arm the sampler on every instrumented call (profile.reset() arms it again)
profile.install()
