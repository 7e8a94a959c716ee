"""Multi-λ training: G regularization configs solved as G lanes.

Counterpart of ``photon_ml_tpu/sweep/runner.py``. The reference trains one
coordinate-descent run per regularization weight and keeps the best by an
evaluator (GameEstimator.scala:279-398); the JAX package runs the G configs
as one ``vmap``. Here the config axis is written out:

- a fixed effect's G configs are G lanes over its one CSR design
  (``ops/shared_design.SharedDesign``): each margins and scatter of the
  solve is one launch of a lane kernel, ``csr_margins_lanes`` or
  ``csc_scatter_lanes``, which reads the design once per chunk of lanes;
- a random-effect bucket's G configs x E entities are G*E lanes over the
  bucket's design broadcast across the configs (the reference's outer
  ``vmap``, :119-142): a dense bucket contracts ``[E, R, K]`` against
  ``[G, E, K]``, a COO bucket runs the lane kernels over its block-diagonal
  CSR with ``W [G, E*K]``.

Each solve is ``dispatch_solve`` with a 2-D ``w0``, so the lane solvers run
it (a lane's reason freezes it while the others go on), with the L2 weight
a ``[G]`` (or ``[G*E]``) tensor and the L1 weight one per lane.

Warm-started regularization path: λs are ordered descending
(``sweep/grid.py``), so lane g-1 is lane g's more-regularized neighbour.
From the second round (``sweep_glm``) or CD iteration (``sweep_game``) on,
a lane that did not converge starts from lane g-1's solution
(``path_warm_start``); converged lanes keep their own optimum.

Scores and residual gathers keep the port's fixed-order sums: a bucket's
training scores are written to their rows (each active row sits in one
slot), and validation scores sum each row's terms with
``torch.segment_reduce``, as ``RandomEffectModel.score`` does, never with
``index_add_``.

Telemetry (the reference's): the ``sweep.solves`` counter, the
``sweep.configs_total`` / ``sweep.configs_done`` gauges (the heartbeat's
sweep fields), a ``sweep > sweep_round`` / ``sweep > sweep_iteration >
coordinate:<name>`` span tree, and one ``sweep_config`` span per lane
carrying its λ, iterations, reason, final loss and, after selection, its
validation metric: the run report's sweep table. The spans read what the
result already fetched (``sweep_glm`` packs the lanes' final values into its
one fetch), so they add no device-to-host copy.

``sweep_glm(mesh=...)`` (:297-350) splits the G config lanes over the mesh's
model axis (else its batch axis), padded to a multiple of the axis with
lanes of the smallest λ that are dropped from the result; every owner holds
a replica of the batch and the constraints on its device and runs the lane
kernels over its own lanes. The warm start between rounds reads the joined
lanes on the first device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.normalization import NormalizationType, build_normalization_context
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.device import check_on, resolve_device
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectBucketModel,
    RandomEffectModel,
    map_vocab_codes,
)
from photon_ml_tpu_torch.game.random_effect_data import build_random_effect_dataset
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.ops.shared_design import SharedDesign, bucket_dot_rows, bucket_lanes
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import (
    CONVERGENCE_REASON_NAMES,
    BoxConstraints,
    FUNCTION_VALUES_CONVERGED,
    MAX_ITERATIONS,
    NOT_CONVERGED,
    SolveResult,
)
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, dispatch_solve, split_reg_weights
from photon_ml_tpu_torch.sweep.grid import SweepGrid
from photon_ml_tpu_torch.telemetry.executables import instrumented, record_collective

Tensor = torch.Tensor

__all__ = [
    "GlmSweepResult",
    "GameSweepResult",
    "SweepUnsupportedError",
    "path_warm_start",
    "re_bootstrap_solve",
    "sweep_glm",
    "sweep_game",
]


class SweepUnsupportedError(ValueError):
    """A training feature the sweep path does not batch; the message names
    the coordinate and the single-fit alternative."""


# the batched lane solves and scorers as accounted executables (the
# reference's instrumented sweep programs, by name)
sweep_fe_solve = instrumented(dispatch_solve, name="sweep_fe_solve")
sweep_re_solve = instrumented(dispatch_solve, name="sweep_re_solve")
bootstrap_re_solve = instrumented(dispatch_solve, name="bootstrap_re_solve")


@instrumented(name="sweep_fe_score")
def _fe_sweep_score(design: SharedDesign, w: Tensor) -> Tensor:
    return design.dot_rows(w)


@instrumented(name="sweep_re_score")
def _re_sweep_score(design, table: Tensor) -> Tensor:
    return bucket_dot_rows(design, table)


def _fetch(t: Tensor, label: str) -> np.ndarray:
    """One counted device-to-host fetch."""
    telemetry.counter("host_syncs").inc()
    with telemetry.span(f"fetch:{label}"):
        return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# warm-started path
# ---------------------------------------------------------------------------


def path_warm_start(w: Tensor, reasons: Tensor) -> Tensor:
    """Next-round inits along the regularization path: lane g takes lane
    g-1's solution (its more-regularized neighbour, λs descending), but only
    where lane g did not converge (``reasons`` says MaxIterations or still
    running); converged lanes keep their own optimum."""
    shifted = torch.cat([w[:1], w[:-1]], dim=0)
    keep = ~_unconverged(reasons)
    return torch.where(keep.reshape((-1,) + (1,) * (w.dim() - 1)), w, shifted)


def _unconverged(reasons: Tensor) -> Tensor:
    return (reasons == MAX_ITERATIONS) | (reasons == NOT_CONVERGED)


def _lane_unconverged(reasons: Tensor) -> Tensor:
    """Per-config unconverged mask from a [G] or [G, E] reason tensor."""
    un = _unconverged(reasons)
    return un if un.dim() == 1 else un.reshape(un.shape[0], -1).any(dim=1)


# ---------------------------------------------------------------------------
# plain-GLM sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GlmSweepResult:
    """One finished multi-λ GLM sweep (config axis = descending λ)."""

    lambdas: tuple[float, ...]
    w: Tensor  # [G, d]
    values: Tensor  # [G] final objective values
    iterations: np.ndarray  # i32[G]
    reasons: np.ndarray  # i32[G]
    data_passes: np.ndarray  # i32[G]
    rounds: int

    @property
    def size(self) -> int:
        return len(self.lambdas)

    def reason_names(self) -> list[str]:
        return [CONVERGENCE_REASON_NAMES.get(int(r), str(int(r))) for r in self.reasons]


def sweep_glm(
    batch: CSRBatch,
    task: str,
    lambdas: Sequence[float],
    config: OptimizerConfig,
    *,
    warm_start: bool = True,
    rounds: Optional[int] = None,
    w_start: Optional[Tensor] = None,
    constraints=None,
    mesh=None,
    device: torch.device | str | None = None,
) -> GlmSweepResult:
    """Train one GLM per λ on ``device`` (default cuda; with ``mesh``, its
    first device), all G as lanes over the batch's one design; with
    ``mesh`` the lanes split over its model (else batch) axis.

    ``rounds`` (default 2 with ``warm_start``, else 1) is the number of
    batched solve passes: round 0 is cold (every lane from ``w_start``),
    later rounds re-init unconverged lanes from their more-regularized
    neighbour (``path_warm_start``). ``config.regularization_weight`` is
    ignored: the grid is the sweep axis. Iterations, reasons and data passes
    come back in one host fetch at the end."""
    if mesh is not None and device is None:
        device = mesh.first_device
    dev = resolve_device(device)
    if not lambdas:
        raise ValueError("sweep_glm needs a non-empty lambda grid")
    if not isinstance(batch, CSRBatch):
        raise TypeError(f"sweep_glm runs over a CSRBatch (the lane kernels' layout), got "
                        f"{type(batch).__name__}")
    check_on(dev, batch.labels)
    config.validate(task)
    lams = tuple(sorted((float(v) for v in lambdas), reverse=True))
    G = len(lams)
    if rounds is None:
        rounds = 2 if (warm_start and G > 1) else 1
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    n_feat = int(batch.num_features)
    if w_start is None:
        w_start = torch.zeros(n_feat, dtype=torch.float32, device=dev)
    devices = _lane_devices(mesh, dev)
    # the pad lanes repeat the smallest λ; they are dropped from the result
    lams_p = lams + (lams[-1],) * ((-G) % len(devices))
    per = len(lams_p) // len(devices)
    l2s, l1s = split_reg_weights(config.regularization, lams_p)
    groups = []  # per owner: its device, its adapter, its L1 weights and box
    for o, d in enumerate(devices):
        replica = batch if d == batch.device else _replica(batch, d)
        cons = (config.build_box_constraints(n_feat, d) if constraints is None
                else _box_on(constraints, d))
        groups.append((d, glm_adapter(make_objective(task).with_l2(l2s[o * per:(o + 1) * per]
                                                                    .to(d)),
                                      SharedDesign.of(replica, per)),
                       l1s[o * per:(o + 1) * per].to(d).unsqueeze(-1), cons))
    W = torch.broadcast_to(w_start.to(device=dev, dtype=torch.float32),
                           (len(lams_p), n_feat)).contiguous()
    res = None
    if len(devices) > 1:
        # the lanes are independent: per iteration the only traffic is the
        # one-scalar convergence test
        record_collective("sweep_glm_solve", "psum", len(devices), 4,
                          count=max(int(config.max_iterations), 1) * rounds)
    telemetry.gauge("sweep.configs_total").set(G)
    telemetry.gauge("sweep.configs_done").set(0)
    with telemetry.span("sweep", task=task, configs=G, rounds=rounds):
        for r in range(rounds):
            with telemetry.span("sweep_round", round=r):
                w0 = W if r == 0 else path_warm_start(W, res.reason)
                res = _join_owner_lanes([
                    sweep_fe_solve(adapter, w0[o * per:(o + 1) * per].to(d), config, l1, cons,
                                   device=d)
                    for o, (d, adapter, l1, cons) in enumerate(groups)], per, dev)
                W = res.w
            telemetry.counter("sweep.solves").inc(G)
            telemetry.gauge("sweep.configs_done").set(int(round(G * (r + 1) / rounds)))
    fetched = _fetch(torch.stack([res.iterations[:G].to(torch.float32),
                                  res.reason[:G].to(torch.float32),
                                  res.data_passes[:G].to(torch.float32),
                                  res.value[:G].to(torch.float32)]), "sweep_glm")
    result = GlmSweepResult(lambdas=lams, w=W[:G], values=res.value[:G],
                            iterations=fetched[0].astype(np.int32),
                            reasons=fetched[1].astype(np.int32),
                            data_passes=fetched[2].astype(np.int32), rounds=rounds)
    _emit_config_spans(lams, {"lambda": lams}, result.iterations, result.reasons,
                       values=fetched[3])
    return result


def _emit_config_spans(lambdas: Sequence[float], lambda_by_key: dict, iterations: np.ndarray,
                       reasons: np.ndarray, values: Optional[np.ndarray] = None,
                       metrics: Optional[np.ndarray] = None,
                       metric_name: Optional[str] = None) -> None:
    """One ``sweep_config`` span per lane: the per-config convergence
    record the run report renders as a table, from host arrays."""
    for g in range(len(lambdas)):
        attrs = {"index": g, "iterations": int(iterations[g]),
                 "reason": CONVERGENCE_REASON_NAMES.get(int(reasons[g]), str(int(reasons[g])))}
        for key, lams in lambda_by_key.items():
            attrs[f"lambda.{key}" if key != "lambda" else "lambda"] = float(lams[g])
        if values is not None:
            attrs["final_loss"] = float(values[g])
        if metrics is not None:
            attrs["metric"] = None if np.isnan(metrics[g]) else float(metrics[g])
            attrs["metric_name"] = metric_name
        with telemetry.span("sweep_config", **attrs):
            pass


def _lane_devices(mesh, dev: torch.device) -> tuple[torch.device, ...]:
    """The devices the config lanes split over: the mesh's model axis, else
    its batch axis (a mesh with neither: the one device)."""
    if mesh is None:
        return (dev,)
    from photon_ml_tpu_torch.parallel.sharding import data_axis, model_axis

    axis = model_axis(mesh) or data_axis(mesh)
    return (dev,) if axis is None else tuple(mesh.axis_devices(axis))


def _replica(batch: CSRBatch, d: torch.device) -> CSRBatch:
    """The batch built again on ``d`` (its mirror and tile index there)."""
    return CSRBatch.from_device_csr(batch.row_ptr.to(d), batch.cols.to(d), batch.vals.to(d),
                                    batch.labels.to(d), batch.num_features,
                                    offsets=batch.offsets.to(d), weights=batch.weights.to(d))


def _box_on(box, d: torch.device):
    return None if box is None else BoxConstraints(lower=box.lower.to(d), upper=box.upper.to(d))


def _join_owner_lanes(results: list[SolveResult], per: int, dev: torch.device) -> SolveResult:
    """The owners' lane results joined on ``dev`` in owner order; a
    per-solve count becomes a per-lane one."""
    fields = {}
    for name in SolveResult._fields:
        vals = [getattr(r, name) for r in results]
        if isinstance(vals[0], Tensor) and vals[0].dim() >= 1:
            fields[name] = torch.cat([v.to(dev) for v in vals])
        else:
            fields[name] = torch.cat([torch.as_tensor(v, device=dev).reshape(-1)
                                      .broadcast_to((per,)) for v in vals])
    return SolveResult(**fields)


# ---------------------------------------------------------------------------
# GAME sweep (fixed effect + per-entity random effect; shared config axis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FeState:
    name: str
    shard_name: str
    config: OptimizerConfig
    lambdas: tuple[float, ...]
    batch: CSRBatch  # the shard's device batch with base offsets and weights
    obj: object  # the objective with the per-lane L2 weights [G]
    l1s: Tensor  # [G]
    constraints: object
    normalization: object
    W: Tensor  # [G, d] in solve (normalized) space
    reasons: Optional[Tensor] = None
    iterations: Optional[Tensor] = None
    values: Optional[Tensor] = None

    def original_w(self) -> Tensor:
        if self.normalization is None:
            return self.W
        return torch.stack([self.normalization.transform_model_coefficients(w)
                            for w in self.W])


@dataclasses.dataclass
class _ReState:
    name: str
    config: OptimizerConfig
    lambdas: tuple[float, ...]
    red: object  # RandomEffectDataset
    buckets: tuple  # per bucket: DenseBucket or CooBucket on the device
    projections: tuple  # per bucket: i64 [E, K] on the device
    l2s: Tensor  # [G]
    l1s: Tensor  # [G]
    tables: list  # per bucket [G, E, K]
    vocab: np.ndarray
    reasons: Optional[Tensor] = None  # [G] lane-aggregated
    iterations: Optional[Tensor] = None
    values: Optional[Tensor] = None


class GameSweepResult:
    """A finished multi-config GAME sweep: device coefficient tables per
    coordinate per lane, convergence summaries, and the scoring of every
    lane against a validation dataset."""

    def __init__(self, task, states, history, device):
        self.task = task
        self._states = states  # name -> _FeState | _ReState
        self.history = history
        self.device = device
        self._convergence = None  # fetched once; the sweep is immutable

    @property
    def size(self) -> int:
        return len(next(iter(self._states.values())).lambdas)

    @property
    def coordinate_names(self) -> list[str]:
        return list(self._states)

    @property
    def lambdas(self) -> dict[str, tuple[float, ...]]:
        return {name: s.lambdas for name, s in self._states.items()}

    def convergence(self) -> dict[str, dict[str, np.ndarray]]:
        """Per-coordinate per-lane summary of the last update: iterations
        (RE: max over entities), reason codes (RE: worst over entities),
        final objective values (RE: summed over entities); fetched once per
        coordinate and cached."""
        if self._convergence is not None:
            return self._convergence
        out = {}
        for name, s in self._states.items():
            packed = torch.stack([s.iterations.to(torch.float32), s.reasons.to(torch.float32),
                                  s.values.to(torch.float32)])
            fetched = _fetch(packed, f"sweep:{name}")
            out[name] = {"iterations": fetched[0].astype(np.int32),
                         "reasons": fetched[1].astype(np.int32),
                         "values": fetched[2]}
        self._convergence = out
        return out

    def emit_config_spans(self, metrics: Optional[np.ndarray] = None,
                          metric_name: Optional[str] = None) -> None:
        """One ``sweep_config`` span per lane from ``convergence()``: the
        lane's iterations (max over coordinates), its worst reason (an
        unconverged coordinate first), its summed final values and, given,
        its validation metric."""
        conv = self.convergence()
        iterations = np.max(np.stack([c["iterations"] for c in conv.values()]), axis=0)
        reasons = None
        for c in conv.values():
            r = c["reasons"]
            reasons = r if reasons is None else np.where(
                (reasons == MAX_ITERATIONS) | (reasons == NOT_CONVERGED), reasons, r)
        values = np.sum(np.stack([c["values"] for c in conv.values()]), axis=0)
        lams = self.lambdas
        _emit_config_spans(next(iter(lams.values())), lams, iterations, reasons, values=values,
                           metrics=metrics, metric_name=metric_name)

    # -- scoring -------------------------------------------------------------

    def _fe_scores(self, s: _FeState, data: GameDataset) -> Tensor:
        """x.w of every lane's original-space coefficients on ``data``: one
        lane margins launch."""
        return _fe_sweep_score(SharedDesign.of(data.csr_batch(s.shard_name), self.size),
                               s.original_w())

    def _re_training_scores(self, s: _ReState, n: int) -> Tensor:
        """Every lane's scores on the training rows: each bucket's margins
        written to their rows (each active row sits in one bucket slot)."""
        scores = torch.zeros((self.size, n), dtype=torch.float32, device=self.device)
        for b, table in zip(s.buckets, s.tables):
            design = b.x if hasattr(b, "x") else b.block
            margins = _re_sweep_score(design, table).reshape(self.size, -1)
            scores[:, b.slot_rows] = margins.index_select(1, b.slots)
        return scores

    @instrumented(name="sweep_re_val_score")
    def _re_scores_for(self, s: _ReState, data: GameDataset) -> Tensor:
        """All-lane scores on any dataset: one host pass maps its entity
        values through the training vocabulary to (bucket, position); each
        row's terms are summed in a fixed order (``segment_reduce``), as
        ``RandomEffectModel.score`` does."""
        idc = data.id_columns.get(s.red.id_name)
        if idc is None:
            raise KeyError(f"dataset lacks id column '{s.red.id_name}' needed by "
                           f"coordinate '{s.name}'")
        codes = map_vocab_codes(s.vocab, idc.vocab[idc.codes])
        known = codes >= 0
        safe = np.where(known, codes, 0)
        row_bucket = np.where(known, s.red.entity_bucket[safe], -1)
        row_pos = np.where(known, s.red.entity_pos[safe], -1)
        shard = data.shard(s.red.shard_name)
        dev = self.device
        live = shard.values != 0
        scores = torch.zeros((self.size, data.num_rows), dtype=torch.float32, device=dev)
        for b_idx, (table, proj_all) in enumerate(zip(s.tables, s.projections)):
            sel = np.flatnonzero(live & (row_bucket[shard.rows] == b_idx))
            if not len(sel):
                continue
            rows = shard.rows[sel]
            starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
            lengths = torch.from_numpy(np.diff(np.r_[starts, len(rows)])).to(dev)
            v = torch.from_numpy(shard.values[sel]).to(dev)
            g = torch.from_numpy(shard.cols[sel]).to(dev)
            pos = torch.from_numpy(row_pos[rows].astype(np.int64)).to(dev)
            proj = proj_all.index_select(0, pos)
            k = torch.searchsorted(proj, g.unsqueeze(1)).clamp(max=proj.shape[1] - 1)
            hit = proj.gather(1, k).squeeze(1) == g
            coef = table[:, pos, k.squeeze(1)]  # [G, m]
            terms = (v * torch.where(hit, coef, 0.0)).t().contiguous()  # [m, G]
            scores[:, torch.from_numpy(rows[starts]).to(dev)] = torch.segment_reduce(
                terms, "sum", lengths=lengths).t()
        return scores

    def validation_scores(self, data: GameDataset) -> Tensor:
        """Raw model scores (no offsets) of every config lane on ``data`` as
        one ``[G, n]`` device tensor."""
        total = torch.zeros((self.size, data.num_rows), dtype=torch.float32, device=self.device)
        for s in self._states.values():
            if isinstance(s, _FeState):
                total = total + self._fe_scores(s, data)
            else:
                total = total + self._re_scores_for(s, data)
        return total

    # -- model materialization ------------------------------------------------

    def model_for(self, g: int) -> GameModel:
        """The GAME model of config lane ``g`` (the port's ``GameModel``; used
        once, for the selected winner)."""
        if not 0 <= g < self.size:
            raise IndexError(f"config index {g} out of range [0, {self.size})")
        models: dict = {}
        for name, s in self._states.items():
            if isinstance(s, _FeState):
                models[name] = FixedEffectModel(coefficients=s.original_w()[g].clone(),
                                                shard_name=s.shard_name)
            else:
                buckets = tuple(
                    RandomEffectBucketModel(coefficients=table[g].clone(), projection=proj,
                                            entity_codes=bucket.entity_codes)
                    for table, proj, bucket in zip(s.tables, s.projections, s.red.buckets))
                models[name] = RandomEffectModel(
                    id_name=s.red.id_name, shard_name=s.red.shard_name, buckets=buckets,
                    entity_bucket=s.red.entity_bucket, entity_pos=s.red.entity_pos,
                    vocab=s.vocab)
        return GameModel(task=self.task, models=models)


def _build_fe_state(name, c, data: GameDataset, G: int, lams, task: str) -> _FeState:
    c.optimizer.validate(task)
    dev = data.device
    norm = None
    if NormalizationType(c.normalization) != NormalizationType.NONE:
        summary = summarize(data.csr_batch(c.shard_name))
        norm = build_normalization_context(NormalizationType(c.normalization), summary,
                                           intercept_index=c.intercept_index)
        if c.optimizer.box_constraints:
            raise SweepUnsupportedError(
                f"coordinate '{name}': box constraints under normalization "
                "are not batched by the sweep path; use GameEstimator.fit")
    if c.optimizer.down_sampling_rate < 1.0:
        raise SweepUnsupportedError(
            f"coordinate '{name}': down-sampling re-draws per update and is "
            "not batched by the sweep path; use GameEstimator.fit_grid")
    batch = data.csr_batch(c.shard_name)
    l2s, l1s = (t.to(dev) for t in split_reg_weights(c.optimizer.regularization, lams))
    obj = make_objective(task, factors=None if norm is None else norm.factors,
                         shifts=None if norm is None else norm.shifts).with_l2(l2s)
    return _FeState(
        name=name, shard_name=c.shard_name, config=c.optimizer, lambdas=lams, batch=batch,
        obj=obj, l1s=l1s,
        constraints=c.optimizer.build_box_constraints(batch.num_features, dev),
        normalization=norm,
        W=torch.zeros((G, batch.num_features), dtype=torch.float32, device=dev))


def _build_re_state(name, c, data: GameDataset, G: int, lams, task: str) -> _ReState:
    c.optimizer.validate(task)
    if c.projector != "index_map":
        raise SweepUnsupportedError(
            f"coordinate '{name}': projector '{c.projector}' is not batched "
            "by the sweep path (index_map only); use GameEstimator.fit_grid")
    if c.optimizer.box_constraints:
        raise SweepUnsupportedError(
            f"coordinate '{name}': per-entity box constraints are not "
            "batched by the sweep path; use GameEstimator.fit_grid")
    red = build_random_effect_dataset(
        data, c.id_name, c.shard_name,
        active_rows_per_entity=c.active_rows_per_entity,
        min_rows_per_entity=c.min_rows_per_entity,
        features_to_samples_ratio=c.features_to_samples_ratio)
    if len(red.passive_rows):
        raise SweepUnsupportedError(
            f"coordinate '{name}': active-row caps leave passive rows, "
            "which the sweep scoring path does not batch; drop "
            "active_rows_per_entity or use GameEstimator.fit_grid")
    dev = data.device
    l2s, l1s = (t.to(dev) for t in split_reg_weights(c.optimizer.regularization, lams))
    dense, coo = red.dense_buckets(dev), red.coo_buckets(dev)
    return _ReState(
        name=name, config=c.optimizer, lambdas=lams, red=red,
        buckets=tuple(d if d is not None else k for d, k in zip(dense, coo)),
        projections=tuple(torch.from_numpy(b.projection.astype(np.int64)).to(dev)
                          for b in red.buckets),
        l2s=l2s, l1s=l1s,
        tables=[torch.zeros((G, b.num_entities, b.num_local_features), dtype=torch.float32,
                            device=dev) for b in red.buckets],
        vocab=data.id_columns[c.id_name].vocab)


def sweep_game(
    config,
    data: GameDataset,
    grid: SweepGrid,
    *,
    num_iterations: Optional[int] = None,
    warm_start: bool = True,
    device: torch.device | str | None = None,
) -> GameSweepResult:
    """Run coordinate descent over all G configs at once, on ``device``
    (default cuda), where ``data`` must live.

    ``config`` is a ``GameConfig``; every coordinate must be a fixed effect
    or an index-map random effect (``SweepUnsupportedError`` names anything
    else). The updating sequence and the residual trick follow
    ``run_coordinate_descent``, with every score and residual carrying the
    leading config axis. From the second CD iteration on, unconverged lanes
    warm-start from their more-regularized neighbour (``path_warm_start``).
    """
    from photon_ml_tpu_torch.game.estimator import FixedEffectConfig, RandomEffectConfig

    dev = resolve_device(device)
    if data.device.type != dev.type or (dev.index is not None
                                        and data.device.index != dev.index):
        raise ValueError(f"the dataset lives on {data.device} but the sweep runs on {dev}; "
                         "build it with the same device")
    G = grid.size
    if num_iterations is None:
        num_iterations = config.num_iterations
    states: dict = {}
    for name, c in config.coordinates.items():
        lams = grid.for_coordinate(name)
        if isinstance(c, FixedEffectConfig):
            states[name] = _build_fe_state(name, c, data, G, lams, config.task)
        elif isinstance(c, RandomEffectConfig):
            states[name] = _build_re_state(name, c, data, G, lams, config.task)
        else:
            raise SweepUnsupportedError(
                f"coordinate '{name}': {type(c).__name__} is not batched by "
                "the sweep path; use GameEstimator.fit_grid")

    names = list(states)
    n = data.num_rows
    scores = {name: torch.zeros((G, n), dtype=torch.float32, device=data.device)
              for name in names}
    history: list[dict] = []
    result = GameSweepResult(config.task, states, history, data.device)
    total_steps = max(num_iterations * len(names), 1)
    telemetry.gauge("sweep.configs_total").set(G)
    telemetry.gauge("sweep.configs_done").set(0)
    with telemetry.span("sweep", task=config.task, configs=G, num_coordinates=len(names)):
        for it in range(num_iterations):
            with telemetry.span("sweep_iteration", iteration=it):
                for idx, name in enumerate(names):
                    s = states[name]
                    t0 = time.perf_counter()
                    with telemetry.span(f"coordinate:{name}", iteration=it):
                        residual = None
                        if len(names) > 1:
                            residual = sum((scores[o] for o in names if o != name),
                                           start=torch.zeros_like(scores[name]))
                        if isinstance(s, _FeState):
                            _update_fe(s, config.task, residual, it, warm_start, data.device)
                            scores[name] = result._fe_scores(s, data)
                        else:
                            _update_re(s, config.task, residual, it, warm_start, data.device)
                            scores[name] = result._re_training_scores(s, n)
                        if scores[name].is_cuda:
                            torch.cuda.synchronize(scores[name].device)
                    telemetry.counter("sweep.solves").inc(G)
                    telemetry.gauge("sweep.configs_done").set(
                        int(G * (it * len(names) + idx + 1) / total_steps))
                    history.append({"iteration": it, "coordinate": name,
                                    "seconds": time.perf_counter() - t0, "configs": G})
    return result


def _update_fe(s: _FeState, task: str, residual, it: int, warm_start: bool, dev) -> None:
    G = len(s.lambdas)
    w0 = s.W
    if warm_start and it > 0 and s.reasons is not None:
        w0 = path_warm_start(s.W, s.reasons)
    offsets = s.batch.offsets if residual is None else s.batch.offsets + residual
    design = SharedDesign.of(s.batch, G, offsets=offsets)
    res = sweep_fe_solve(glm_adapter(s.obj, design), w0, s.config, s.l1s.unsqueeze(-1),
                         s.constraints, device=dev)
    s.W, s.reasons, s.iterations, s.values = res.w, res.reason, res.iterations, res.value


@instrumented(name="sweep_re_residual")
def _residual_offsets(base: Tensor, row_index: Tensor, residual: Optional[Tensor]) -> Tensor:
    """A bucket's base offsets [E, R] plus each config's residual scores
    [G, n] gathered through ``row_index`` -> [G, E, R]; padding rows get
    nothing."""
    if residual is None:
        return base
    extra = residual.index_select(1, row_index.clamp(min=0).reshape(-1))
    extra = extra.reshape((residual.shape[0],) + tuple(row_index.shape))
    return base + torch.where(row_index >= 0, extra, 0.0)


def _update_re(s: _ReState, task: str, residual, it: int, warm_start: bool, dev) -> None:
    G = len(s.lambdas)
    lane_un, iters, values = None, [], []
    for i, b in enumerate(s.buckets):
        base = b.batch()
        lanes = bucket_lanes(base, G, offsets=_residual_offsets(base.offsets, b.row_index,
                                                                residual))
        E, K = lanes.num_entities, lanes.num_local_features
        w0 = s.tables[i]
        if warm_start and it > 0 and s.reasons is not None:
            w0 = path_warm_start(w0, s.reasons)
        obj = make_objective(task).with_l2(s.l2s.repeat_interleave(E))
        res = sweep_re_solve(glm_adapter(obj, lanes), w0.reshape(G * E, K), s.config,
                             s.l1s.repeat_interleave(E).unsqueeze(-1), None, device=dev)
        s.tables[i] = res.w.reshape(G, E, K)
        un = _lane_unconverged(res.reason.reshape(G, E))
        lane_un = un if lane_un is None else (lane_un | un)
        iters.append(res.iterations.reshape(G, E).max(dim=1).values)
        values.append(res.value.reshape(G, E).sum(dim=1))
    # lane-level aggregates: worst reason, max iterations, summed values
    s.reasons = torch.where(lane_un, MAX_ITERATIONS, FUNCTION_VALUES_CONVERGED).to(torch.int32)
    s.iterations = torch.stack(iters).max(dim=0).values
    s.values = torch.stack(values).sum(dim=0)


def re_bootstrap_solve(config: OptimizerConfig, obj, ebatch, lane_weights: Tensor, w0: Tensor,
                       l1: float, device=None) -> SolveResult:
    """The bootstrap's B-resample x E-entity bucket solve
    (``re_bootstrap_solver``, :145-173): the same lane composition as a
    random-effect sweep, with the group axis carrying B weight resamples.
    ``lane_weights [B, E, R]`` scale the bucket's base row weights per lane,
    and every lane warm-starts from the point estimate ``w0 [E, K]``; the
    result's fields are per lane, ``[B*E, ...]``."""
    B = lane_weights.shape[0]
    lanes = bucket_lanes(ebatch, B, weights=ebatch.weights.unsqueeze(0) * lane_weights)
    w_start = w0.to(torch.float32).unsqueeze(0).expand(B, *w0.shape)
    return bootstrap_re_solve(glm_adapter(obj, lanes), w_start.reshape(B * w0.shape[0], -1),
                              config, l1, None, device=device)
