"""Online quality drift telemetry: per-version score-distribution and
calibration-bin sketches.

Counterpart of ``photon_ml_tpu/quality/drift.py``, copied: host numpy only.

- :func:`observe_scores` — every ``ScoringEngine.score_rows`` chunk feeds
  its (already fetched) mean predictions into a bounded per-version
  :class:`ScoreSketch` (count/sum/sumsq/min/max + a fixed 10-bin histogram
  over [0, 1]);
- :func:`observe_labeled` — the nearline updater feeds (predicted, label)
  pairs from feedback events into per-version calibration bins;
- the ``"quality"`` snapshot section — registered once at import through
  ``telemetry.register_snapshot_provider`` — publishes one drift row per
  retained version into every ``telemetry.snapshot()`` (``/metricsz``),
  with a PSI (population stability index) against the oldest retained
  version with enough samples.

At most :data:`MAX_VERSIONS` versions are retained, ring-evicted
oldest-first (``quality.versions_evicted``).

Fault seam: ``quality.drift_flush`` fires inside the snapshot provider; an
injected raise drops the section from one snapshot and nothing else (the
registry's provider-skip contract).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from photon_ml_tpu_torch import faults
from photon_ml_tpu_torch.telemetry import metrics as _metrics

__all__ = [
    "MAX_VERSIONS",
    "NUM_BINS",
    "FP_DRIFT_FLUSH",
    "ScoreSketch",
    "CalibrationSketch",
    "DriftMonitor",
    "MONITOR",
    "observe_scores",
    "observe_labeled",
    "population_stability_index",
    "reset",
]

#: Ring capacity: drift rows for at most this many versions are retained;
#: publishing version N+9 evicts the oldest — same boundedness contract
#: as the request tracer's flight ring.
MAX_VERSIONS = 8

#: Fixed histogram bins over [0, 1] (mean predictions post-link; values
#: outside clamp into the edge bins so linear-task margins still sketch).
NUM_BINS = 10

#: A version needs this many observed scores before it can anchor a PSI
#: baseline — PSI against a near-empty histogram is noise, not drift.
MIN_BASELINE_SAMPLES = 50

FP_DRIFT_FLUSH = faults.register_point(
    "quality.drift_flush",
    description="quality drift snapshot assembly (the /metricsz and "
    "telemetry-flush provider) — observability, never control: a raise "
    "here drops the section from one snapshot and nothing else",
)


def population_stability_index(
    expected: np.ndarray, actual: np.ndarray
) -> float:
    """PSI between two histograms (counts). The standard drift score:
    < 0.1 stable, 0.1-0.25 moderate shift, > 0.25 investigate. Zero
    bins are floored so an empty bin contributes a finite term."""
    e = np.asarray(expected, np.float64)
    a = np.asarray(actual, np.float64)
    if e.sum() <= 0 or a.sum() <= 0:
        return 0.0
    ep = np.maximum(e / e.sum(), 1e-6)
    ap = np.maximum(a / a.sum(), 1e-6)
    return ((ap - ep) * np.log(ap / ep)).sum().item()


class ScoreSketch:
    """Streaming moments + fixed histogram of one version's scores."""

    __slots__ = ("count", "total", "total_sq", "min", "max", "bins")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.bins = np.zeros((NUM_BINS,), np.int64)

    def update(self, scores: np.ndarray) -> None:
        if scores.size == 0:
            return
        s = scores.ravel()
        self.count += int(s.size)
        self.total += s.sum().item()
        self.total_sq += (s * s).sum().item()
        mn, mx = s.min().item(), s.max().item()
        self.min = mn if self.min is None else min(self.min, mn)
        self.max = mx if self.max is None else max(self.max, mx)
        idx = np.clip((s * NUM_BINS).astype(np.int64), 0, NUM_BINS - 1)
        self.bins += np.bincount(idx, minlength=NUM_BINS)

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        mean = self.total / self.count
        var = max(self.total_sq / self.count - mean * mean, 0.0)
        return {
            "count": self.count,
            "mean": round(mean, 6),
            "std": round(var ** 0.5, 6),
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "histogram": self.bins.tolist(),
        }


class CalibrationSketch:
    """Per-bin (predicted sum, label sum, count) from labeled feedback:
    the online calibration view — observed rate vs mean prediction per
    score bin, and the worst per-bin gap as one scalar."""

    __slots__ = ("count", "bin_count", "bin_pred", "bin_label")

    def __init__(self):
        self.count = 0
        self.bin_count = np.zeros((NUM_BINS,), np.int64)
        self.bin_pred = np.zeros((NUM_BINS,), np.float64)
        self.bin_label = np.zeros((NUM_BINS,), np.float64)

    def update(self, predicted: np.ndarray, labels: np.ndarray) -> None:
        p = predicted.ravel()
        y = labels.ravel()
        if p.size == 0 or p.size != y.size:
            return
        self.count += int(p.size)
        idx = np.clip((p * NUM_BINS).astype(np.int64), 0, NUM_BINS - 1)
        self.bin_count += np.bincount(idx, minlength=NUM_BINS)
        self.bin_pred += np.bincount(idx, weights=p, minlength=NUM_BINS)
        self.bin_label += np.bincount(idx, weights=y, minlength=NUM_BINS)

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        live = self.bin_count > 0
        n = np.maximum(self.bin_count, 1)
        pred_mean = self.bin_pred / n
        obs_rate = self.bin_label / n
        gaps = np.where(live, np.abs(pred_mean - obs_rate), 0.0)
        return {
            "count": self.count,
            "bin_count": self.bin_count.tolist(),
            "predicted_mean": np.round(pred_mean, 6).tolist(),
            "observed_rate": np.round(obs_rate, 6).tolist(),
            "max_gap": round(gaps.max().item(), 6),
        }


class DriftMonitor:
    """Bounded per-version drift state behind one lock; the module-level
    :data:`MONITOR` instance is what the serving engine and nearline
    updater feed and what the ``"quality"`` snapshot section reads."""

    def __init__(self, max_versions: int = MAX_VERSIONS):
        self.max_versions = max_versions
        self._lock = threading.Lock()
        # insertion-ordered: eviction pops the oldest-inserted version
        self._scores: dict[str, ScoreSketch] = {}
        self._calibration: dict[str, CalibrationSketch] = {}

    def _sketch_locked(self, table: dict, version: str, factory):
        got = table.get(version)
        if got is None:
            got = table[version] = factory()
            self._evict_locked()
        return got

    def _evict_locked(self) -> None:
        versions = list(
            dict.fromkeys(list(self._scores) + list(self._calibration))
        )
        while len(versions) > self.max_versions:
            oldest = versions.pop(0)
            self._scores.pop(oldest, None)
            self._calibration.pop(oldest, None)
            _metrics.counter("quality.versions_evicted").inc()

    def observe_scores(self, version: str, scores: np.ndarray) -> None:
        with self._lock:
            sketch = self._sketch_locked(
                self._scores, version, ScoreSketch
            )
            sketch.update(scores)
        _metrics.counter("quality.scores_observed").inc(int(scores.size))

    def observe_labeled(
        self, version: str, predicted: np.ndarray, labels: np.ndarray
    ) -> None:
        with self._lock:
            sketch = self._sketch_locked(
                self._calibration, version, CalibrationSketch
            )
            sketch.update(predicted, labels)
        _metrics.counter("quality.labeled_observed").inc(
            int(np.size(labels))
        )

    def snapshot_rows(self) -> dict:
        """The ``"quality"`` snapshot section: one row per retained
        version (insertion order = publish order), PSI against the
        oldest version with enough samples."""
        faults.fault_point(FP_DRIFT_FLUSH)
        with self._lock:
            versions = list(
                dict.fromkeys(list(self._scores) + list(self._calibration))
            )
            score_summaries = {
                v: s.summary() for v, s in self._scores.items()
            }
            cal_summaries = {
                v: c.summary() for v, c in self._calibration.items()
            }
        baseline = None
        for v in versions:
            s = score_summaries.get(v)
            if s and s.get("count", 0) >= MIN_BASELINE_SAMPLES:
                baseline = v
                break
        rows = {}
        for v in versions:
            row: dict = {}
            s = score_summaries.get(v)
            if s is not None:
                row["scores"] = s
                if (
                    baseline is not None
                    and v != baseline
                    and s.get("count", 0) > 0
                ):
                    row["psi_vs_baseline"] = round(
                        population_stability_index(
                            np.array(
                                score_summaries[baseline]["histogram"]
                            ),
                            np.array(s["histogram"]),
                        ),
                        6,
                    )
            c = cal_summaries.get(v)
            if c is not None:
                row["calibration"] = c
            rows[v] = row
        return {"versions": rows, "baseline_version": baseline}


#: Process-global monitor; module-level helpers delegate to it.
MONITOR = DriftMonitor()


def observe_scores(version: Optional[str], scores: np.ndarray) -> None:
    """Feed one chunk of HOST-side mean predictions (post
    ``telemetry.sync_fetch``) into ``version``'s drift sketch. A None
    version (an engine constructed without one) sketches under
    ``"unversioned"`` so ad-hoc engines still drift-track."""
    MONITOR.observe_scores(version or "unversioned", scores)


def observe_labeled(
    version: Optional[str], predicted: np.ndarray, labels: np.ndarray
) -> None:
    """Feed labeled feedback (host arrays) into ``version``'s
    calibration bins — the nearline updater's flush-path hook."""
    MONITOR.observe_labeled(version or "unversioned", predicted, labels)


def reset() -> None:
    """Drop all drift state (test isolation). The snapshot provider
    registration survives — it is wiring, not run state."""
    global MONITOR
    MONITOR = DriftMonitor()


def _provider() -> dict:
    return MONITOR.snapshot_rows()


_metrics.register_snapshot_provider("quality", _provider)
