"""Hyperparameter sweeps: multi-λ training as lanes, the warm-started
regularization path, and best-model selection.

Counterpart of ``photon_ml_tpu/sweep``:

- ``sweep.grid``: the ``lambda=1e-4:1e2:log16`` spec grammar with
  per-coordinate overrides, descending path order and typed parse errors;
- ``sweep.runner``: G configs solved as G lanes (the config axis composes
  with the per-entity lanes of a random-effect bucket), unconverged lanes
  warm-started from their more-regularized neighbour;
- ``sweep.select``: every lane scored against the validation split, one
  host fetch, and NaN-safe selection policies. Publishing the winner to the
  serving registry is not ported (ROADMAP.md Queue 1 item 14).
"""

from photon_ml_tpu_torch.sweep.grid import (  # noqa: F401
    SweepGrid,
    SweepSpecError,
    parse_sweep_spec,
)
from photon_ml_tpu_torch.sweep.runner import (  # noqa: F401
    GameSweepResult,
    GlmSweepResult,
    SweepUnsupportedError,
    path_warm_start,
    sweep_game,
    sweep_glm,
)
from photon_ml_tpu_torch.sweep.select import (  # noqa: F401
    SweepSelection,
    SweepSelectionError,
    default_metric,
    evaluate_sweep,
    export_winner,
    run_selection,
    select_best,
)
