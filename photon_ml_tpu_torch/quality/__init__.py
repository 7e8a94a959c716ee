"""Quality observability: the champion/challenger publish gate and the
online drift sketches.

Counterpart of ``photon_ml_tpu/quality``:

- :mod:`photon_ml_tpu_torch.quality.gate` — candidate AUC/H-L stats with
  bootstrap error bars (:func:`game_quality_stats`) and the no-regression
  decision (:func:`decide_gate`), enforced inside ``serving.registry
  .publish_version`` and recorded in version metadata and lineage;
- :mod:`photon_ml_tpu_torch.quality.drift` — score-distribution and
  calibration sketches fed by ``ScoringEngine.score_rows`` and the nearline
  updater, published as the ``"quality"`` section of every
  ``telemetry.snapshot()``.

Importing the package registers both fault seams (``quality.publish_gate``,
``quality.drift_flush``) and the drift snapshot provider.
"""

from __future__ import annotations

from photon_ml_tpu_torch.quality import drift  # noqa: F401
from photon_ml_tpu_torch.quality.drift import (  # noqa: F401
    FP_DRIFT_FLUSH,
    DriftMonitor,
    observe_labeled,
    observe_scores,
    population_stability_index,
)
from photon_ml_tpu_torch.quality.gate import (  # noqa: F401
    FP_PUBLISH_GATE,
    GateDecision,
    QualityGateRefused,
    QualityStats,
    decide_gate,
    game_quality_stats,
    weighted_auc,
)

__all__ = [
    "drift",
    "FP_DRIFT_FLUSH",
    "DriftMonitor",
    "observe_labeled",
    "observe_scores",
    "population_stability_index",
    "FP_PUBLISH_GATE",
    "GateDecision",
    "QualityGateRefused",
    "QualityStats",
    "decide_gate",
    "game_quality_stats",
    "weighted_auc",
]
