"""Block coordinate descent over named GAME coordinates.

Counterpart of ``run_coordinate_descent`` (``photon_ml_tpu/game/
coordinate_descent.py:205-396``). Per iteration, per coordinate in order:
the coordinate's offsets become the base offsets plus the other
coordinates' scores (the residual trick), its sub-model is retrained
warm-started, its scores are recomputed, and with validation data the full
model is evaluated; the best model by the first evaluator is tracked.
Scores are ``[num_rows]`` device tensors keyed by coordinate name. Each
history entry records the update's wall seconds, its host syncs (telemetry
counter ``host_syncs``) and its kernel launches (``kernels.LAUNCHES``).

The reference's checkpoint, guard, ``should_stop`` and fault points are not
ported: passing any of the first three raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import torch

from photon_ml_tpu_torch import kernels, telemetry
from photon_ml_tpu_torch.evaluation.evaluators import (
    EVALUATORS,
    better_than,
    parse_evaluator,
    sharded_auc,
    sharded_precision_at_k,
)
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import GameModel

_NOT_PORTED = "{} of run_coordinate_descent is not ported yet (ROADMAP.md Queue 1 item 10)"


@dataclasses.dataclass
class ValidationSpec:
    data: GameDataset
    evaluators: Sequence[str]  # the first one selects the best model


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    best_model: GameModel
    best_metric: Optional[float]
    history: list[dict]  # one entry per (iteration, coordinate)


def _evaluate(model: GameModel, spec: ValidationSpec) -> dict[str, float]:
    """Each evaluator of ``spec`` on the model's validation scores, keyed by
    its spec string; a sharded one ('auc:<col>', 'precision@k:<col>') groups
    by the id column named, matched case-insensitively."""
    data = spec.data
    scores = model.score(data) + data.per_row(data.offset)
    labels, weights = data.per_row(data.response), data.per_row(data.weight)
    out = {}
    for spec_str in spec.evaluators:
        kind, group_col, k = parse_evaluator(spec_str)
        if kind in EVALUATORS:
            out[spec_str] = float(EVALUATORS[kind](scores, labels, weights))
            continue
        col = next((c for c in data.id_columns if c.lower() == group_col), None)
        if col is None:
            raise KeyError(f"evaluator '{spec_str}' needs id column '{group_col}'; "
                           f"have {sorted(data.id_columns)}")
        idc = data.id_columns[col]
        gids = torch.from_numpy(idc.codes).to(scores.device)
        if kind == "sharded_auc":
            value = sharded_auc(scores, labels, weights, gids, idc.num_entities)
        else:
            value = sharded_precision_at_k(scores, labels, weights, gids, idc.num_entities, k)
        out[spec_str] = float(value)
    return out


def run_coordinate_descent(
    coordinates: Mapping[str, object],
    task: str,
    num_iterations: int,
    validation: Optional[ValidationSpec] = None,
    initial_models: Optional[Mapping[str, object]] = None,
    guard=None,
    checkpoint=None,
    should_stop=None,
) -> CoordinateDescentResult:
    """Train all coordinates for ``num_iterations`` outer sweeps, in the
    order of ``coordinates``; ``initial_models`` warm-starts coordinates."""
    for arg, value in (("checkpoint", checkpoint), ("guard", guard),
                       ("should_stop", should_stop)):
        if value is not None:
            raise NotImplementedError(_NOT_PORTED.format(arg))
    names = list(coordinates)
    models = {
        name: (initial_models[name] if initial_models and name in initial_models
               else coordinates[name].initialize_model())
        for name in names
    }
    scores = {name: coordinates[name].score(models[name]) for name in names}
    best_model: Optional[GameModel] = None
    best_metric: Optional[float] = None
    history: list[dict] = []

    for it in range(num_iterations):
        with telemetry.span("cd_iteration", iteration=it):
            for name in names:
                coord = coordinates[name]
                syncs = telemetry.snapshot()["counters"].get("host_syncs", 0)
                launched = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                with telemetry.span(f"coordinate:{name}", iteration=it):
                    residual = None
                    if len(names) > 1:
                        residual = sum((scores[o] for o in names if o != name),
                                       start=torch.zeros_like(scores[name]))
                    models[name] = coord.update_model(models[name], residual)
                    scores[name] = coord.score(models[name])
                    if scores[name].is_cuda:
                        torch.cuda.synchronize(scores[name].device)
                # the update's solve results stay on the device (one per
                # random-effect bucket): nothing per entity is fetched here
                entry = {"iteration": it, "coordinate": name,
                         "seconds": time.perf_counter() - t0,
                         "host_syncs": telemetry.snapshot()["counters"].get("host_syncs", 0)
                         - syncs,
                         "launches": {k: n - launched[k] for k, n in kernels.LAUNCHES.items()},
                         "results": list(coord.last_results)}
                if validation is not None:
                    game_model = GameModel(task=task, models=dict(models))
                    metrics = _evaluate(game_model, validation)
                    entry["metrics"] = metrics
                    primary = validation.evaluators[0]
                    if best_metric is None or better_than(primary, metrics[primary],
                                                          best_metric):
                        best_metric, best_model = metrics[primary], game_model
                history.append(entry)

    final = GameModel(task=task, models=dict(models))
    return CoordinateDescentResult(model=final, best_model=best_model or final,
                                   best_metric=best_metric, history=history)
