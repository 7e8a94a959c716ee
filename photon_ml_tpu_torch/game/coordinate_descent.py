"""Block coordinate descent over named GAME coordinates.

Counterpart of ``run_coordinate_descent`` (``photon_ml_tpu/game/
coordinate_descent.py:205-396``). Per iteration, per coordinate in order:
the coordinate's offsets become the base offsets plus the other
coordinates' scores (the residual trick), its sub-model is retrained
warm-started, its scores are recomputed, and with validation data the full
model is evaluated; the best model by the first evaluator is tracked.
Scores are ``[num_rows]`` device tensors keyed by coordinate name. Each
history entry records the update's wall seconds, its host syncs (telemetry
counter ``host_syncs``) and its kernel launches (``kernels.LAUNCHES``);
``on_step(entry)`` fires after each update (the estimator's event hook).
Each update also feeds the heartbeat and the run report
(``_record_step_progress``, the reference's :124-160): the
``progress.rows``/``progress.coeffs`` counters and ``progress.*_per_sec``
gauges, counted from shapes, and the coordinate's device-memory phase gauge
from the allocator's counters; neither fetches from the device.

With a ``GuardSpec`` every update is guarded (``_guarded_update``, the
reference's :162-207 and its bookkeeping at :269-365): the coordinate's
solve health, one device boolean, is fetched once per solve; a diverged
solve is retried with escalating extra L2 through the coordinate's
``extra_l2``, then rolled back, and a coordinate rolled back
``freeze_after`` consecutive times is frozen. Under a guard the residual is
cleaned of NaN and infinities, so a rolled-back coordinate cannot poison
its neighbours. The entry of a retried or rolled-back update records
``solve_retries`` and ``rolled_back``.

With a ``CheckpointManager`` (the reference's :251-290 and :372-389) the
newest valid checkpoint is restored on entry (one written by a fit with
other coordinates is refused), its completed steps are skipped and the
scores are recomputed from the restored models; under a guard its frozen
coordinates and rollback counts come back too. After each step the state is
saved when ``should_save(step)`` or when ``should_stop()`` turns true, which
then raises ``TrainingInterrupted``. A checkpoint's history holds each entry
without its ``results`` (tensors). An update whose coordinate leaves a
``last_tracker`` records its summary string as ``tracker`` unless it was
rolled back. Two fault points: ``guard.solve_health`` (a ``nan`` rule
marks a solve diverged, through ``faults.corrupt_health`` on the fetched
health) and ``cd.step.boundary`` (after a step, before its checkpoint and
stop handling).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, kernels, telemetry
from photon_ml_tpu_torch.evaluation.evaluators import (
    EVALUATORS,
    better_than,
    parse_evaluator,
    sharded_auc,
    sharded_precision_at_k,
)
from photon_ml_tpu_torch.game.checkpoint import (
    CheckpointError,
    CheckpointManager,
    CheckpointState,
    TrainingInterrupted,
)
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.optim.guard import FP_SOLVE_HEALTH, GuardSpec, model_is_finite

# between a completed (iteration, coordinate) step and its checkpoint and
# stop handling: an injected raise here leaves the last step's checkpoint
# intact and resumable
_FP_STEP_BOUNDARY = faults.register_point(
    "cd.step.boundary",
    description="after a CD step completes, before checkpoint/stop logic",
)

logger = logging.getLogger("photon_ml_tpu_torch.game")


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


def validation_arrays(data: GameDataset) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels, weights, offsets) of a validation dataset as ``[n]`` float32
    tensors on its device: the evaluators' inputs, shared by the CD
    validation below and the sweep's selection (``sweep/select.py``), as the
    reference's ``padded_validation_arrays`` (:70-83; the port pads
    nothing)."""
    return data.per_row(data.response), data.per_row(data.weight), data.per_row(data.offset)


def _evaluate(model: GameModel, spec: ValidationSpec) -> dict[str, float]:
    """Each evaluator of ``spec`` on the model's validation scores, keyed by
    its spec string; a sharded one ('auc:<col>', 'precision@k:<col>') groups
    by the id column named, matched case-insensitively."""
    data = spec.data
    labels, weights, offsets = validation_arrays(data)
    scores = model.score(data) + offsets
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


def _guarded_update(coord, model, residual, guard: GuardSpec, name: str):
    """One guarded coordinate update: solve, fetch its health, retry with
    damping, roll back. Returns ``(model', attempts_used, rolled_back)``. A
    coordinate without ``extra_l2`` would repeat its solve bit for bit, so
    it rolls back after the first divergence."""
    supports_damping = hasattr(coord, "extra_l2")
    if hasattr(coord, "health_check"):
        coord.health_check = True
    max_attempts = (guard.max_retries if supports_damping else 0) + 1
    for attempt in range(max_attempts):
        if attempt:
            telemetry.counter("solves.retried").inc()
            logger.warning("coordinate %s diverged; retrying with extra L2 damping %g",
                           name, guard.damping_for(attempt))
        if supports_damping:
            coord.extra_l2 = guard.damping_for(attempt)
        try:
            new_model = coord.update_model(model, residual)
        finally:
            if supports_damping:
                coord.extra_l2 = 0.0
        health = getattr(coord, "last_health", None)
        if health is None:
            health = model_is_finite(new_model)
        # a `nan` rule marks this solve diverged: the damped retries and the
        # rollback run on demand
        health = faults.corrupt_health(FP_SOLVE_HEALTH, health)
        if bool(telemetry.sync_fetch(torch.as_tensor(health), label=f"guard:{name}")):
            return new_model, attempt, False
        telemetry.counter("solves.diverged").inc()
    telemetry.counter("solves.rolled_back").inc()
    logger.warning("coordinate %s still diverging after %d attempt(s); rolling back to the "
                   "pre-solve model", name, max_attempts)
    return model, max_attempts - 1, True


def _num_coefficients(model) -> int:
    """Coefficient count of a coordinate model, from shapes only (no device
    transfer): feeds the ``progress.coeffs`` counter."""
    if model is None:
        return 0
    coeffs = getattr(model, "coefficients", None)
    if coeffs is not None:
        return int(np.prod(tuple(coeffs.shape)))
    buckets = getattr(model, "buckets", None)
    if buckets is not None:
        return sum(_num_coefficients(b) for b in buckets)
    models = getattr(model, "models", None)
    if isinstance(models, Mapping):
        return sum(_num_coefficients(m) for m in models.values())
    if dataclasses.is_dataclass(model):
        return sum(int(v.numel()) for v in (getattr(model, f.name)
                                            for f in dataclasses.fields(model))
                   if isinstance(v, torch.Tensor))
    return 0


def _record_step_progress(coord, model, name: str, seconds: float) -> None:
    """Per-update progress and memory telemetry: the rows/coeffs counters
    (the heartbeat's rate sources), the rows/s and coeffs/s gauges (the run
    report's key metrics), and the coordinate's memory phase peak."""
    data = getattr(coord, "data", None)
    rows = int(getattr(data, "num_rows", 0) or 0)
    coeffs = _num_coefficients(model)
    if rows:
        telemetry.counter("progress.rows").inc(rows)
    if coeffs:
        telemetry.counter("progress.coeffs").inc(coeffs)
    if seconds > 0:
        if rows:
            telemetry.gauge("progress.rows_per_sec").set(rows / seconds)
        if coeffs:
            telemetry.gauge("progress.coeffs_per_sec").set(coeffs / seconds)
    telemetry.memory.record_phase_memory(f"coordinate:{name}",
                                         device=getattr(data, "device", None))


def run_coordinate_descent(
    coordinates: Mapping[str, object],
    task: str,
    num_iterations: int,
    validation: Optional[ValidationSpec] = None,
    initial_models: Optional[Mapping[str, object]] = None,
    on_step=None,
    guard: Optional[GuardSpec] = None,
    checkpoint: Optional[CheckpointManager] = None,
    should_stop=None,
) -> CoordinateDescentResult:
    """Train all coordinates for ``num_iterations`` outer sweeps, in the
    order of ``coordinates``; ``initial_models`` warm-starts coordinates,
    ``guard`` guards every solve, ``checkpoint`` restores and saves the
    state and ``should_stop`` (polled after every step) interrupts."""
    names = list(coordinates)
    models = {
        name: (initial_models[name] if initial_models and name in initial_models
               else coordinates[name].initialize_model())
        for name in names
    }
    best_model: Optional[GameModel] = None
    best_metric: Optional[float] = None
    history: list[dict] = []
    start_step = 0
    restored = checkpoint.restore() if checkpoint is not None else None
    if restored is not None:
        if list(restored.model.models) != names:
            raise CheckpointError(
                f"checkpoint at {checkpoint.spec.directory} was written by a fit with "
                f"coordinates {list(restored.model.models)}, not {names}")
        models = dict(restored.model.models)
        best_model, best_metric = restored.best_model, restored.best_metric
        history = list(restored.history)
        start_step = restored.step + 1
    # scores are derived state: recomputed from the (restored) models
    scores = {name: coordinates[name].score(models[name]) for name in names}
    # the guard's bookkeeping survives a resume only under a guard: resuming
    # without one asks to train every coordinate again
    frozen: set[str] = set()
    consecutive_rollbacks = {name: 0 for name in names}
    if guard is not None and restored is not None:
        frozen = {n for n in restored.frozen if n in consecutive_rollbacks}
        for n, count in (restored.consecutive_rollbacks or {}).items():
            if n in consecutive_rollbacks:
                consecutive_rollbacks[n] = int(count)
    last_ckpt_path: Optional[str] = None

    for it in range(num_iterations):
        with telemetry.span("cd_iteration", iteration=it):
            for idx, name in enumerate(names):
                step = it * len(names) + idx
                if step < start_step:
                    continue  # completed before the restored checkpoint
                if name in frozen:
                    continue  # a divergent coordinate: its last good model stands
                coord = coordinates[name]
                syncs = telemetry.peek_counter("host_syncs") or 0
                launched = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                with telemetry.span(f"coordinate:{name}", iteration=it):
                    residual = None
                    if len(names) > 1:
                        residual = sum((scores[o] for o in names if o != name),
                                       start=torch.zeros_like(scores[name]))
                        if guard is not None:
                            residual = torch.nan_to_num(residual, nan=0.0, posinf=0.0,
                                                        neginf=0.0)
                    rolled_back, attempts = False, 0
                    if guard is None:
                        models[name] = coord.update_model(models[name], residual)
                    else:
                        models[name], attempts, rolled_back = _guarded_update(
                            coord, models[name], residual, guard, name)
                    if not rolled_back:  # a rolled-back model's scores stand
                        scores[name] = coord.score(models[name])
                    if scores[name].is_cuda:
                        torch.cuda.synchronize(scores[name].device)
                # the update's solve results stay on the device (one per
                # random-effect bucket): nothing per entity is fetched here
                entry = {"iteration": it, "coordinate": name,
                         "seconds": time.perf_counter() - t0,
                         "host_syncs": (telemetry.peek_counter("host_syncs") or 0) - syncs,
                         "launches": {k: n - launched[k] for k, n in kernels.LAUNCHES.items()},
                         "results": [] if rolled_back else list(getattr(coord, "last_results",
                                                                        ()))}
                if guard is not None and (attempts or rolled_back):
                    entry["solve_retries"] = attempts
                    entry["rolled_back"] = rolled_back
                tracker = getattr(coord, "last_tracker", None)
                if tracker is not None and not rolled_back:
                    entry["tracker"] = tracker.to_summary_string()
                if validation is not None:
                    game_model = GameModel(task=task, models=dict(models))
                    metrics = _evaluate(game_model, validation)
                    entry["metrics"] = metrics
                    primary = validation.evaluators[0]
                    if best_metric is None or better_than(primary, metrics[primary],
                                                          best_metric):
                        best_metric, best_model = metrics[primary], game_model
                _record_step_progress(coord, models[name], name, entry["seconds"])
                history.append(entry)
                if on_step is not None:
                    on_step(entry)
                if rolled_back:
                    consecutive_rollbacks[name] += 1
                    if consecutive_rollbacks[name] >= guard.freeze_after:
                        frozen.add(name)
                        telemetry.counter("solves.frozen").inc()
                        logger.warning("coordinate %s frozen after %d consecutive rollbacks; "
                                       "its last good model keeps scoring", name,
                                       consecutive_rollbacks[name])
                else:
                    consecutive_rollbacks[name] = 0

                faults.fault_point(_FP_STEP_BOUNDARY)
                stop = should_stop is not None and should_stop()
                if checkpoint is not None and (stop or checkpoint.should_save(step)):
                    last_ckpt_path = checkpoint.save(CheckpointState(
                        step=step, model=GameModel(task=task, models=dict(models)),
                        best_model=best_model, best_metric=best_metric,
                        history=[{k: v for k, v in e.items() if k != "results"}
                                 for e in history],
                        frozen=sorted(frozen),
                        consecutive_rollbacks=dict(consecutive_rollbacks)))
                if stop:
                    raise TrainingInterrupted(step, last_ckpt_path)

    # the models leave the fit joined: a mesh's owner-kept tables gathered
    final = GameModel(task=task, models=dict(models)).gathered()
    best_model = None if best_model is None else best_model.gathered()
    return CoordinateDescentResult(model=final, best_model=best_model or final,
                                   best_metric=best_metric, history=history)
