"""The freshness loop: delta-aware incremental warm-start retrains.

Counterpart of ``photon_ml_tpu/incremental``. A day's delta solves again
only the random-effect entities it touched; the untouched majority keeps
its coefficients bit for bit, a bucket with no touched entity is not solved
at all, and the fixed effect refreshes over the combined data.

- :mod:`.warmstart`: :func:`load_warm_start` (step checkpoints, saved model
  directories and streamed-table checkpoints, the last placed straight onto
  the training mesh), :func:`grow_entity_rows` (vocabulary growth: new rows
  zero, old rows bit for bit) and :class:`BaseLineage`.
- :mod:`.delta`: the touched entities of a delta, in core
  (:func:`scan_delta`) or streamed (:func:`scan_delta_stream`).
- :mod:`.refit`: the selective re-solve (:func:`run_incremental_fit`,
  public as ``GameEstimator.fit_incremental``), with an optional local λ
  sweep selected by ``sweep.select``.
- :mod:`.publish`: :func:`publish_incremental`, a registry version with
  its lineage (base checkpoint, delta digest) in the metadata, through the
  quality gate.

Surfaces: ``cli train --warm-start <dir> [--delta <paths>]``, ``cli
refresh`` and ``GameEstimator.fit_incremental``.
"""

from photon_ml_tpu_torch.incremental.warmstart import (  # noqa: F401
    BaseLineage,
    WarmStart,
    WarmStartError,
    detect_warm_start_kind,
    grow_entity_rows,
    load_warm_start,
)
from photon_ml_tpu_torch.incremental.delta import (  # noqa: F401
    CoordinateDelta,
    DeltaScan,
    delta_digest,
    scan_delta,
    scan_delta_stream,
)
from photon_ml_tpu_torch.incremental.refit import (  # noqa: F401
    IncrementalFitResult,
    MaskedFactoredRandomEffectCoordinate,
    MaskedRandomEffectCoordinate,
    local_lambda_factors,
    run_incremental_fit,
    transplant_factored_random_effect,
    transplant_fixed_effect,
    transplant_random_effect,
)
from photon_ml_tpu_torch.incremental.publish import (  # noqa: F401
    StaleDeltaError,
    check_delta_freshness,
    lineage_record,
    publish_incremental,
)

__all__ = [
    "BaseLineage",
    "CoordinateDelta",
    "DeltaScan",
    "IncrementalFitResult",
    "MaskedFactoredRandomEffectCoordinate",
    "MaskedRandomEffectCoordinate",
    "StaleDeltaError",
    "WarmStart",
    "WarmStartError",
    "check_delta_freshness",
    "delta_digest",
    "detect_warm_start_kind",
    "grow_entity_rows",
    "lineage_record",
    "load_warm_start",
    "local_lambda_factors",
    "publish_incremental",
    "run_incremental_fit",
    "scan_delta",
    "scan_delta_stream",
    "transplant_factored_random_effect",
    "transplant_fixed_effect",
    "transplant_random_effect",
]
