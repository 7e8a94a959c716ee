"""Best-model selection over a finished sweep.

Counterpart of ``photon_ml_tpu/sweep/select.py``. Reference analog:
photon-client ModelSelection (AUC for classifiers, RMSE for linear
regression, Poisson loss for Poisson). Every config lane is scored on the
device against the validation split: one ``[G, n]`` score matrix, the
evaluator once per lane, and one host fetch of the ``[G]`` metrics; a
host-side policy then picks the winner.

Degenerate metrics: lanes whose metric is not finite are excluded from
selection with a warning and the ``sweep.nan_configs`` counter; if every
lane is, selection raises ``SweepSelectionError``. Single-class AUC is the
evaluators' 0.5 and stays selectable.

``export_winner`` publishes the winner as the next version of a serving
registry (``serving.registry.publish_version``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.evaluation.evaluators import EVALUATORS, better_than
from photon_ml_tpu_torch.game.coordinate_descent import validation_arrays
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.ops.losses import get_loss

logger = logging.getLogger("photon_ml_tpu_torch.sweep")

__all__ = [
    "SweepSelectionError",
    "SweepSelection",
    "default_metric",
    "evaluate_sweep",
    "select_best",
    "run_selection",
    "export_winner",
]


class SweepSelectionError(ValueError):
    """No config lane produced a usable validation metric (or the metric
    spec itself is unusable for sweeps); the message names the metric and
    the lane count."""


@dataclasses.dataclass
class SweepSelection:
    """The outcome of scoring and selecting over G config lanes."""

    index: int  # winning lane (lanes ordered by descending λ)
    metric: str
    metrics: np.ndarray  # f64[G]; NaN = lane excluded
    policy: str

    @property
    def best_value(self) -> float:
        return float(self.metrics[self.index])

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "metric": self.metric,
            "policy": self.policy,
            "best_value": self.best_value,
            "values": [None if np.isnan(v) else float(v) for v in self.metrics],
        }


def default_metric(task: str) -> str:
    """ModelSelection.scala parity: AUC for binary classifiers, RMSE for
    linear regression, data log-likelihood (poisson loss) for Poisson."""
    task = get_loss(task).name
    if task in ("logistic", "smoothed_hinge"):
        return "auc"
    if task == "squared":
        return "rmse"
    return "poisson_loss"


def evaluate_sweep(result, validation_data: GameDataset,
                   metric: Optional[str] = None) -> tuple[str, np.ndarray]:
    """Score every config lane against the validation split on the device.

    ``result`` is a ``GameSweepResult``. Returns ``(metric_name,
    values[G])``: the ``[G, n]`` score matrix, the evaluator per lane, and
    one host fetch. Sharded (grouped) evaluator specs raise
    ``SweepSelectionError`` naming the spec."""
    metric = metric or default_metric(result.task)
    if metric not in EVALUATORS:
        raise SweepSelectionError(
            f"metric '{metric}' is not sweep-scorable (sharded/grouped "
            f"evaluators need per-group state); pick one of {sorted(EVALUATORS)}")
    scores = result.validation_scores(validation_data)  # [G, n]
    labels, weights, offsets = validation_arrays(validation_data)
    fn = EVALUATORS[metric]
    full = scores + offsets.unsqueeze(0)
    values = torch.stack([torch.as_tensor(fn(full[g], labels, weights), dtype=torch.float64)
                          for g in range(full.shape[0])])
    telemetry.counter("host_syncs").inc()
    return metric, values.cpu().numpy().astype(np.float64)


def select_best(metrics: np.ndarray, metric_name: str, policy: str = "best",
                rel_tol: float = 0.01) -> int:
    """Pick the winning lane index from per-lane metric values.

    Policies (lanes are ordered by descending λ, so a lower index is more
    regularized):

    - ``"best"``: the best metric value; ties break toward the lower index
      (the more regularized, simpler model).
    - ``"parsimonious"``: the lowest-index lane within ``rel_tol``
      (relative) of the best value.

    Non-finite lanes are excluded (``sweep.nan_configs`` counter and a
    warning); all of them non-finite raises ``SweepSelectionError``."""
    metrics = np.asarray(metrics, np.float64)
    valid = np.isfinite(metrics)
    n_bad = int(np.sum(~valid))
    if n_bad:
        telemetry.counter("sweep.nan_configs").inc(n_bad)
        logger.warning("sweep: %d of %d configs produced non-finite '%s' metrics; "
                       "excluded from selection", n_bad, len(metrics), metric_name)
    if not valid.any():
        raise SweepSelectionError(
            f"all {len(metrics)} sweep configs produced non-finite "
            f"'{metric_name}' validation metrics — nothing to select "
            "(check the validation split for empty/NaN columns)")
    maximize = better_than(metric_name, 1.0, 0.0)
    masked = np.where(valid, metrics, -np.inf if maximize else np.inf)
    best_value = masked.max() if maximize else masked.min()
    if policy == "best":
        # argmax/argmin return the first best index: the most regularized
        return int(masked.argmax() if maximize else masked.argmin())
    if policy == "parsimonious":
        span = abs(best_value) * rel_tol
        ok = valid & ((metrics >= best_value - span) if maximize
                      else (metrics <= best_value + span))
        return int(np.nonzero(ok)[0][0])
    raise SweepSelectionError(f"unknown selection policy '{policy}' (best|parsimonious)")


def run_selection(result, validation_data: GameDataset, metric: Optional[str] = None,
                  policy: str = "best", rel_tol: float = 0.01) -> SweepSelection:
    """``evaluate_sweep`` then ``select_best``."""
    metric_name, values = evaluate_sweep(result, validation_data, metric)
    index = select_best(values, metric_name, policy=policy, rel_tol=rel_tol)
    return SweepSelection(index=index, metric=metric_name, metrics=values, policy=policy)


def export_winner(model, index_maps, registry_dir: str,
                  selection: Optional[SweepSelection] = None,
                  extra_metadata: Optional[dict] = None) -> str:
    """Publish the winning model as the next registry version — the
    ``publish_version`` layout ``serving/registry.py`` hot-swaps from
    (feature indexes first, metadata last, atomic rename). Returns the
    published version path."""
    from photon_ml_tpu_torch.serving.registry import publish_version

    meta = dict(extra_metadata or {})
    if selection is not None:
        meta["sweep_selection"] = selection.to_json()
    path = publish_version(registry_dir, model, index_maps, extra_metadata=meta)
    telemetry.counter("sweep.published_versions").inc()
    return path
