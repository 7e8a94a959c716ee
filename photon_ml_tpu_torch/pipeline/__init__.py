"""The freshness tier's conductor: a supervised daemon (``cli pipeline``)
that tails a delta directory, runs masked incremental retrains on a cadence,
reconciles nearline updates, escalates to full retrains, and hot-swaps the
serving registry, with event-to-served staleness p99 as its gauge.

Counterpart of ``photon_ml_tpu/pipeline``: :mod:`.conductor` holds the loop,
:mod:`.reconcile` the nearline-vs-delta rule.
"""

from photon_ml_tpu_torch.pipeline.conductor import (
    FP_CYCLE_START,
    FP_ESCALATE,
    FP_RECONCILE,
    FreshnessPipeline,
    PipelineSpec,
)
from photon_ml_tpu_torch.pipeline.reconcile import (
    RECONCILE_RULE,
    newest_version_metadata,
    reconcile_nearline,
)

__all__ = [
    "FP_CYCLE_START",
    "FP_ESCALATE",
    "FP_RECONCILE",
    "FreshnessPipeline",
    "PipelineSpec",
    "RECONCILE_RULE",
    "newest_version_metadata",
    "reconcile_nearline",
]
