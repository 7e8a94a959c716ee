"""Process-global metrics registry: counters, gauges, histograms.

Counterpart of ``photon_ml_tpu/telemetry/metrics.py``, copied. Any layer
increments a named counter (``metrics.counter("host_syncs").inc()``), sets a
gauge, or feeds a histogram, and ``snapshot()`` returns one JSON-safe dict;
named sections (the quality layer's drift rows) join it through
``register_snapshot_provider``.

Thread-safe (one registry lock; metric mutation is a few ns under it) and
allocation-light so hot paths can afford it. Histograms keep a bounded
uniform reservoir for percentiles plus exact count/sum/min/max.

Metric names use dotted lowercase (``events.OptimizationLogEvent`` counts
keep the event class name verbatim).
"""

from __future__ import annotations

import datetime
import json
import threading
from typing import Any, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "peek_counter",
    "gauge",
    "histogram",
    "snapshot",
    "register_snapshot_provider",
    "flush_jsonl",
    "reset",
]

_PERCENTILES = (5, 25, 50, 75, 95, 99)


class Counter:
    """Monotonically increasing count (int or float increments)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value: float = 0
        self._lock = lock

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value: Optional[float] = None
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    uniform reservoir (deterministic LCG, no global RNG state) for
    percentiles."""

    __slots__ = (
        "name", "count", "total", "min", "max", "_sample", "_cap",
        "_lcg", "_lock",
    )

    def __init__(self, name: str, lock: threading.Lock, cap: int = 4096):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._sample: list[float] = []
        self._cap = cap
        self._lcg = 0x9E3779B9
        self._lock = lock

    def _observe_locked(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self._sample) < self._cap:
            self._sample.append(v)
        else:
            # Vitter reservoir sampling with a private LCG stream
            self._lcg = (self._lcg * 1103515245 + 12345) & 0x7FFFFFFF
            j = self._lcg % self.count
            if j < self._cap:
                self._sample[j] = v

    def observe(self, v: float) -> None:
        with self._lock:
            self._observe_locked(float(v))

    def observe_many(self, values) -> None:
        """Vectorized bulk observe: per-entity tracker vectors arrive here
        once per coordinate update, so the per-element Python loop (and the
        registry lock hold) must not scale with entity count."""
        import numpy as np

        arr = np.asarray(
            values if hasattr(values, "__len__") else list(values), dtype=float
        ).ravel()
        if arr.size == 0:
            return
        if arr.size < 64:  # small batches: the scalar path is cheaper
            with self._lock:
                for v in arr:
                    self._observe_locked(float(v))
            return
        with self._lock:
            prior = self.count
            self.count += int(arr.size)
            self.total += float(arr.sum())
            mn, mx = float(arr.min()), float(arr.max())
            self.min = mn if self.min is None else min(self.min, mn)
            self.max = mx if self.max is None else max(self.max, mx)
            room = self._cap - len(self._sample)
            if room > 0:
                take = arr[:room]
                self._sample.extend(take.tolist())
                prior += int(take.size)
                arr = arr[room:]
            if arr.size:
                # batch reservoir: element with global index g replaces slot
                # j ~ U[0, g) when j < cap (later duplicates win, matching
                # the sequential algorithm); seeded from the LCG state so
                # the stream stays deterministic
                rng = np.random.default_rng(self._lcg)
                g = np.arange(prior + 1, prior + arr.size + 1)
                j = (rng.random(arr.size) * g).astype(np.int64)
                hit = j < self._cap
                if hit.any():
                    sample = np.asarray(self._sample)
                    sample[j[hit]] = arr[hit]
                    self._sample = sample.tolist()
                self._lcg = int(rng.integers(1, 2**31))

    def summary(self) -> dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            out = {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
            }
            sample = sorted(self._sample)
            n = len(sample)
            for p in _PERCENTILES:
                idx = min(n - 1, max(0, round(p / 100 * (n - 1))))
                out[f"p{p}"] = sample[idx]
            return out


class MetricsRegistry:
    """Named metric store; get-or-create accessors, one snapshot dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._providers: dict[str, Any] = {}

    def register_snapshot_provider(self, name: str, fn) -> None:
        """Attach a named section to every :meth:`snapshot`: ``fn()``
        must return a JSON-safe value, published under ``name`` beside
        ``counters``/``gauges``/``histograms``. Layers with structured
        state the scalar registries cannot carry (the quality layer's
        per-version drift sketches) ride the same snapshot/flush/report
        surface this way instead of growing unbounded per-version gauge
        names. Providers survive :meth:`reset` (they are wiring, not
        run state) and a provider that raises is skipped — a broken
        section must never take ``/metricsz`` down."""
        reserved = ("counters", "gauges", "histograms")
        if name in reserved:
            raise ValueError(f"snapshot section name {name!r} is reserved")
        with self._lock:
            self._providers[name] = fn

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
            return c

    def peek_counter(self, name: str) -> Optional[float]:
        """A counter's value WITHOUT registering it: monitors (the
        heartbeat) must not force absent counters into the snapshot as
        zeros — downstream consumers read absence as "unknown"."""
        with self._lock:
            c = self._counters.get(name)
            return None if c is None else c.value

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
            return g

    def peek_gauge(self, name: str) -> Optional[float]:
        """A gauge's value WITHOUT registering it (same "absence stays
        unknown" contract as :meth:`peek_counter`)."""
        with self._lock:
            g = self._gauges.get(name)
            return None if g is None else g.value

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self._lock)
            return h

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe state of every metric: ``{"counters": {name: value},
        "gauges": {name: value}, "histograms": {name: summary}}``."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            providers = dict(self._providers)
        out: dict[str, Any] = {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {
                n: h.summary() for n, h in sorted(histograms.items())
            },
        }
        for name, fn in sorted(providers.items()):
            try:
                section = fn()
            except Exception:  # noqa: BLE001 — observability, never control
                continue
            if section is not None:
                out[name] = section
        return out

    def flush_jsonl(self, path: str) -> dict[str, Any]:
        """Append one ``{"type": "metrics", ...}`` line to ``path`` and
        return the snapshot that was written. In a fleet the line carries
        ``process_index``/``hostname``."""
        from photon_ml_tpu_torch.telemetry import identity

        snap = self.snapshot()
        line = {
            "type": "metrics",
            "wall_time": datetime.datetime.now(
                datetime.timezone.utc
            ).isoformat(),
            "snapshot": snap,
        }
        proc = identity.fleet_process_index()
        if proc is not None:
            line["process_index"] = proc
            line["hostname"] = identity.hostname()
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(line, default=str) + "\n")
        return snap

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: Process-global registry; module-level helpers delegate to it.
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
peek_counter = REGISTRY.peek_counter
gauge = REGISTRY.gauge
peek_gauge = REGISTRY.peek_gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
register_snapshot_provider = REGISTRY.register_snapshot_provider
flush_jsonl = REGISTRY.flush_jsonl
reset = REGISTRY.reset
