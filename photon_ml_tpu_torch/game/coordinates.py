"""GAME coordinates: the per-block training strategies that coordinate
descent drives.

Counterpart of ``photon_ml_tpu/game/coordinates.py``:

- ``FixedEffectCoordinate`` (:86-345): one GLM solve (``factory.solve``)
  over the shard's ``CSRBatch``, built once per dataset. Residual scores
  from the other coordinates enter as offsets (``with_offsets``), never by
  rebuilding the CSR or its CSC mirror, so each LBFGS iteration launches the
  margins and scatter kernels on the resident layout; scoring is the
  batch's ``dot_rows``. Down-sampling re-weights the rows per update. With
  a ``normalization`` context the solve runs in normalized space and the
  model stays in the original space (:133-162, :277-303).
- ``RandomEffectCoordinate`` (:552-754): per geometry bucket, one batched
  solve over every entity of the bucket, one lane per entity, with the
  configured optimizer (the reference's ``vmap``), on the bucket's dense
  design or, for a COO-routed bucket, its block-diagonal batch, whose sweeps
  are the margins, scatter and ``hv_at`` kernels; per-entity boxes and
  variances (:354-372, :586-603).

Both take part in the coordinate-descent guard (``optim/guard.py``) as the
reference's do: ``extra_l2`` damps the next solve's L2 weight, and with
``health_check`` on, ``last_health`` is the solve's health, one boolean on
the device (for a random effect, over every bucket). Each update leaves its
``last_tracker`` (``optim/trackers.py``, :327-329 and :659-729), built with
one host fetch; a random effect's comes from its buckets' lane results.

With a ``mesh`` (``parallel/``): the fixed effect's design is split by rows
over the batch axis once (:168-190), each row block cut from the host shard
and built on its own device (``place_host_rows``; a streamed dataset's
device batch is cut where it lies), and per update only the offsets (the
residual scores) and the down-sampled weights are re-placed into the
shards; its scores are the blocks' margins joined in block order. An
entity-only mesh leaves it unsharded. The random effect pads each bucket's
entities to a multiple of the model axis with all-zero problems and solves
each owner's block of lanes on its device, one owner after another
(:412-450, :668-725). The coefficients and variances stay with their owners
between updates (``OwnerBlocks``: no device holds a bucket's whole table);
the lane telemetry is cut back to the bucket's entities on the first
device, so padding never reaches a tracker, and the owners' margins are
written into the scores row by row (each row has one slot: no float
atomics). ``NOT_PORTED`` is the message of what the port refuses,
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.game.dataset import DeviceShards, GameDataset
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints, SolveResult
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    build_objective,
    dispatch_solve,
    solve,
)
from photon_ml_tpu_torch.optim.guard import damped_objective, solve_health
from photon_ml_tpu_torch.optim.trackers import (
    FixedEffectOptimizationTracker,
    RandomEffectOptimizationTracker,
)
from photon_ml_tpu_torch.parallel.distributed import MESH_SOLVES, record_solve_comms
from photon_ml_tpu_torch.parallel.mesh import Mesh
from photon_ml_tpu_torch.parallel.sharding import (
    OwnerBlocks,
    as_sharded,
    axis_size,
    data_axis,
    model_axis,
    place_host_rows,
)
from photon_ml_tpu_torch.telemetry.executables import instrumented, record_collective

Tensor = torch.Tensor

# the fixed effect's solve without a mesh, as an accounted executable (on a
# mesh it is parallel.distributed's gspmd_solve)
fe_solve = instrumented(solve, name="fe_solve")


@instrumented(name="re_solve")
def re_solve(obj, batch, w0: Tensor, config: OptimizerConfig, l1, box=None,
             device=None) -> SolveResult:
    """One bucket's lanes (or one owner's block of them) solved together by
    the configured optimizer."""
    return dispatch_solve(glm_adapter(obj, batch), w0, config, l1, box, device=device)


@instrumented(name="re_score")
def re_score(batch, w: Tensor) -> Tensor:
    """A COO bucket's per-lane margins x.w (no offsets)."""
    return batch.dot_rows(w)


@instrumented(name="re_score_dense")
def re_score_dense(batch, w: Tensor) -> Tensor:
    """A dense bucket's per-lane margins x.w: one batched contraction."""
    return batch.dot_rows(w)


def record_entity_solve_comms(label: str, mesh: Mesh, axis: str, iterations: int) -> int:
    """The reference's static estimate for one entity-sharded solve: the
    lanes are independent, and the only traffic is the one-scalar
    convergence test (an all-reduce of the active mask) per iteration."""
    return record_collective(label, "psum", axis_size(mesh, axis), 4,
                             count=max(int(iterations), 1))

NOT_PORTED = "{} is not ported to photon_ml_tpu_torch yet (ROADMAP.md Queue 1 item {})"


@dataclasses.dataclass
class FixedEffectCoordinate:
    """The global GLM block. Residual scores arrive as additional offsets;
    the solve warm-starts from the current sub-model. Down-sampling keeps
    every positive of a binary task, samples the negatives at the rate and
    re-weights the kept ones by 1/rate, drawing anew on every update."""

    name: str
    data: GameDataset
    shard_name: str
    loss_name: str
    config: OptimizerConfig
    seed: int = 0
    normalization: Optional[NormalizationContext] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.config.validate(self.loss_name)
        if self.mesh is not None and data_axis(self.mesh) is None:
            self.mesh = None  # an entity-only mesh: the fixed effect runs unsharded
        if self.mesh is not None and not isinstance(self.data.feature_shards, DeviceShards):
            # each row block cut from the host shard and built on its own
            # device: no device holds the whole design
            self._batch = None
            self._solve_batch = place_host_rows(
                self.data.shard(self.shard_name), self.data.response, self.data.offset,
                self.data.weight, self.mesh, data_axis(self.mesh))
            self._base_offsets = self.data.per_row(self.data.offset)
        else:
            self._batch = self.data.csr_batch(self.shard_name)
            # the design split by rows over the batch axis once (one shard
            # without a mesh)
            self._solve_batch = as_sharded(self._batch, self.mesh,
                                           None if self.mesh is None else data_axis(self.mesh))
            self._base_offsets = self._batch.offsets
        self._constraints = self.config.build_box_constraints(self._solve_batch.num_features,
                                                              self.data.device)
        norm = self.normalization
        if self._constraints is not None and norm is not None:
            # the bounds are in the original space and the solve runs in the
            # normalized one, where w = w' * factor; under shifts the
            # intercept absorbs -w.shift afterwards, so its bound cannot hold
            if norm.factors is not None:
                self._constraints = BoxConstraints(lower=self._constraints.lower / norm.factors,
                                                   upper=self._constraints.upper / norm.factors)
            if norm.shifts is not None and norm.intercept_index is not None:
                ii = norm.intercept_index
                if bool(self._constraints.lower[ii].isfinite()
                        | self._constraints.upper[ii].isfinite()):
                    raise ValueError(
                        "a box constraint on the intercept cannot be enforced under shift "
                        "normalization (the intercept absorbs -w.shift at back-transform)")
        self._update_count = 0
        self.last_results: list[SolveResult] = []
        self.last_tracker: Optional[FixedEffectOptimizationTracker] = None
        # the guard's hooks: damping of the next solve, and its health
        self.extra_l2 = 0.0
        self.health_check = False
        self.last_health: Optional[Tensor] = None

    def _downsampled_weights(self, update_index: int) -> Tensor:
        rate = self.config.down_sampling_rate
        rng = np.random.default_rng((self.seed, update_index))
        labels = self.data.response
        weights = self.data.weight.copy()
        if "logistic" in self.loss_name or "hinge" in self.loss_name:
            neg = (labels <= 0.5) & (weights > 0)
            drop = neg & (rng.random(len(labels)) >= rate)
            weights[drop] = 0.0
            weights[neg & ~drop] /= rate
        else:
            keep = rng.random(len(labels)) < rate
            weights[~keep] = 0.0
            weights[keep] /= rate
        return self.data.per_row(weights)

    def initialize_model(self) -> FixedEffectModel:
        return FixedEffectModel(
            coefficients=torch.zeros(self._solve_batch.num_features, dtype=torch.float32,
                                     device=self.data.device),
            shard_name=self.shard_name,
        )

    def update_model(self, model: FixedEffectModel,
                     residual_scores: Optional[Tensor]) -> FixedEffectModel:
        update_index = self._update_count
        self._update_count += 1
        batch = self._solve_batch
        if self.config.down_sampling_rate < 1.0:
            batch = batch.with_weights(self._downsampled_weights(update_index))
        if residual_scores is not None:
            batch = batch.with_offsets(self._base_offsets + residual_scores)
        norm = self.normalization
        w0 = model.coefficients
        if norm is not None:
            # models live in the original space, the solve in the normalized one
            w0 = norm.inverse_transform_model_coefficients(w0)
        solver = fe_solve
        if self.mesh is not None:
            record_solve_comms("gspmd_solve", self.mesh, data_axis(self.mesh), w0, self.config)
            solver = MESH_SOLVES["gspmd_solve"]
        res = solver(self.loss_name, batch, self.config, w0, self._constraints,
                     factors=None if norm is None else norm.factors,
                     shifts=None if norm is None else norm.shifts, device=self.data.device,
                     extra_l2=self.extra_l2)
        self.last_results = [res]
        self.last_tracker = FixedEffectOptimizationTracker.from_result(res)
        w = res.w if norm is None else norm.transform_model_coefficients(res.w)
        self.last_health = solve_health(res, w) if self.health_check else None
        return dataclasses.replace(model, coefficients=w)

    def score(self, model: FixedEffectModel) -> Tensor:
        if self._batch is not None:
            return self._batch.dot_rows(model.coefficients)
        # each row block scored on its device, joined in block order
        sb = self._solve_batch
        parts = sb.each(lambda b, w: b.dot_rows(w), sb.broadcast(model.coefficients))
        return torch.cat([p.to(self.data.device) for p in parts])[:sb.num_rows]


# DistributedOptimizationProblem.computeVariances adds this to the Hessian
# diagonal before inverting (the reference's _VARIANCE_EPS)
_VARIANCE_EPS = 1e-12


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity GLM blocks: each bucket's entities are solved together, one
    lane per entity, by the configured optimizer (LBFGS, OWLQN, TRON or
    NEWTON) on the bucket's dense design or its block-diagonal batch (the
    COO layout). Box constraints on global features gather through each
    entity's projection into per-lane bounds; ``compute_variances`` keeps
    1 / (diag H + 1e-12) at each lane's optimum."""

    name: str
    data: GameDataset
    re_data: RandomEffectDataset
    loss_name: str
    config: OptimizerConfig
    compute_variances: bool = False
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.config.validate(self.loss_name)
        if self.compute_variances and not get_loss(self.loss_name).has_hessian:
            raise ValueError("coefficient variances need a twice-differentiable loss; "
                             f"'{self.loss_name}' is not")
        if self.mesh is not None and model_axis(self.mesh) is None:
            self.mesh = None  # a batch-only mesh: no entity axis to use
        # without a mesh the buckets on the data's device; with one, per owner
        # of the model axis its device and its blocks of the buckets with
        # their boxes, and no device holds a whole bucket
        self._owners = ()
        if self.mesh is None:
            self._buckets, self._constraints = self._placed(self.re_data, self.data.device)
        else:
            devices = self.mesh.axis_devices(model_axis(self.mesh))
            self._owners = tuple((d, *self._placed(sub, d)) for d, sub in
                                 zip(devices, self.re_data.owner_datasets(len(devices))))
            self._splits = self.re_data.owner_splits(len(devices))
        self._obj = build_objective(self.loss_name, self.config)
        self._l1 = self.config.regularization.l1_weight(self.config.regularization_weight)
        self.last_results: list[SolveResult] = []
        self.last_tracker: Optional[RandomEffectOptimizationTracker] = None
        self.extra_l2 = 0.0
        self.health_check = False
        self.last_health: Optional[Tensor] = None

    def _placed(self, red: RandomEffectDataset, dev: torch.device):
        """The buckets of ``red`` on ``dev`` and their boxes: the boxes address
        global features and each entity's local space is its projection, so
        the bounds gather through it into [E, K] per bucket (the padding id
        num_global gathers the unbounded sentinel slot)."""
        dense, coo = red.dense_buckets(dev), red.coo_buckets(dev)
        buckets = tuple(d if d is not None else c for d, c in zip(dense, coo))
        constraints: list[Optional[BoxConstraints]] = [None] * len(buckets)
        bounds = self.config.dense_box_bounds(red.num_global_features, sentinel=True)
        if bounds is not None:
            lower, upper = bounds
            constraints = [BoxConstraints(lower=torch.from_numpy(lower[b.projection]).to(dev),
                                          upper=torch.from_numpy(upper[b.projection]).to(dev))
                           for b in red.buckets]
        return buckets, constraints

    def initialize_model(self) -> RandomEffectModel:
        dev = self.data.device

        def zeros(b):
            if not self._owners:
                return torch.zeros((b.num_entities, b.num_local_features), dtype=torch.float32,
                                   device=dev)
            return OwnerBlocks.split(torch.zeros((b.num_entities, b.num_local_features),
                                                 dtype=torch.float32), self._owner_devices())

        buckets = tuple(
            RandomEffectBucketModel(
                coefficients=zeros(b),
                projection=torch.from_numpy(b.projection.astype(np.int64)).to(dev),
                entity_codes=b.entity_codes,
            )
            for b in self.re_data.buckets
        )
        return RandomEffectModel(
            id_name=self.re_data.id_name,
            shard_name=self.re_data.shard_name,
            buckets=buckets,
            entity_bucket=self.re_data.entity_bucket,
            entity_pos=self.re_data.entity_pos,
            vocab=self.data.id_columns[self.re_data.id_name].vocab,
        )

    def update_model(self, model: RandomEffectModel,
                     residual_scores: Optional[Tensor]) -> RandomEffectModel:
        new_buckets, results, healths = [], [], []
        obj = damped_objective(self._obj, self.extra_l2)
        # the residual scores on each owner's device (no copy on the first one)
        residual_on = {str(d): residual_scores.to(d) for d, _, _ in self._owners
                       if residual_scores is not None}
        for i, bm in enumerate(model.buckets):
            if self._owners:
                res, w, var, health = self._solve_owners(obj, i, bm.coefficients, residual_on)
            else:
                res, var = self._solve(obj, self._buckets[i], bm.coefficients,
                                       self._constraints[i], residual_scores, self.data.device)
                w = res.w
                health = solve_health(res, res.w) if self.health_check else None
            results.append(res)
            if health is not None:
                healths.append(health)
            new_buckets.append(dataclasses.replace(bm, coefficients=w, variances=var))
        self.last_results = results
        self.last_tracker = RandomEffectOptimizationTracker.from_results(results)
        if self.health_check:
            self.last_health = (torch.stack(healths).all() if healths
                                else torch.tensor(True, device=self.data.device))
        else:
            self.last_health = None
        return dataclasses.replace(model, buckets=tuple(new_buckets))

    def _solve(self, obj, bucket, w0: Tensor, box, residual: Optional[Tensor],
               dev: torch.device) -> tuple[SolveResult, Optional[Tensor]]:
        """One bucket's lanes solved on ``dev``, with their variances."""
        batch = bucket.batch(residual)
        res = re_solve(obj, batch, w0, self.config, self._l1, box, device=dev)
        var = None
        if self.compute_variances:
            var = 1.0 / (obj.hessian_diagonal(res.w, batch) + _VARIANCE_EPS)
        return res, var

    def _owner_devices(self) -> tuple[torch.device, ...]:
        return tuple(d for d, _, _ in self._owners)

    def _owner_w(self, i: int, w) -> tuple[Tensor, ...]:
        """Bucket ``i``'s coefficients as each owner's padded block on its
        device: the owners' own blocks as they are, a joined tensor (a
        restored or warm-started model) cut into them."""
        if not isinstance(w, OwnerBlocks):
            w = OwnerBlocks.split(w, self._owner_devices())
        return w.parts

    def _solve_owners(self, obj, i: int, w0, residual_on: dict):
        """Bucket ``i``'s lanes over the model axis: each owner's block, its
        padding problems included (all-zero, so they pass the health reduce,
        as in the reference), solved on its device in owner order. The
        coefficients and variances stay with their owners (``OwnerBlocks``);
        only the lane telemetry is joined, on the first device, cut back to
        the bucket's entities."""
        dev = self.data.device
        parts, healths = [], []
        record_entity_solve_comms("re_solve", self.mesh, model_axis(self.mesh),
                                  self.config.max_iterations)
        for (d, buckets, cons), w_o, (lo, hi, pad) in zip(self._owners, self._owner_w(i, w0),
                                                         self._splits[i]):
            res, var = self._solve(obj, buckets[i], w_o, cons[i], residual_on.get(str(d)), d)
            parts.append((res, var, hi - lo))
            if self.health_check:
                healths.append(solve_health(res, res.w).to(dev))
        counts = tuple(n for _, _, n in parts)
        w = OwnerBlocks(parts=tuple(r.w for r, _, _ in parts), counts=counts)
        var = (None if not self.compute_variances
               else OwnerBlocks(parts=tuple(v for _, v, _ in parts), counts=counts))
        health = torch.stack(healths).all() if healths else None
        return _join_lanes([(r, n) for r, _, n in parts], dev), w, var, health

    def score(self, model: RandomEffectModel) -> Tensor:
        """Scores on the training data: the bucket margins for active rows,
        the model's projection lookup for passive rows."""
        scores = torch.zeros(self.data.num_rows, dtype=torch.float32, device=self.data.device)
        for i, bm in enumerate(model.buckets):
            if not self._owners:
                _write_scores(scores, self._buckets[i], bm.coefficients)
                continue
            # on a mesh each owner scores its block; only the margins come back
            for (d, buckets, _), w_o in zip(self._owners, self._owner_w(i, bm.coefficients)):
                _write_scores(scores, buckets[i], w_o)
        if len(self.re_data.passive_rows):
            passive = torch.from_numpy(self.re_data.passive_rows).to(self.data.device)
            scores[passive] = model.score(self.data).index_select(0, passive)
        return scores


def _write_scores(scores: Tensor, bucket, w: Tensor) -> None:
    """A bucket's margins at lanes ``w`` written into their example rows of
    ``scores``: each active row sits in exactly one bucket slot (padding
    slots are none), so writing the slots into zeros is exact in any order."""
    batch = bucket.batch()
    scorer = re_score_dense if isinstance(batch, DenseBatch) else re_score
    margins = scorer(batch, w).reshape(-1).index_select(0, bucket.slots)
    scores.index_put_((bucket.slot_rows.to(scores.device),), margins.to(scores.device))


def _join_lanes(parts: list[tuple[SolveResult, int]], device: torch.device) -> SolveResult:
    """One lane result from owners' results: each owner's first ``n`` lanes,
    in owner order, on ``device`` (a number field keeps its largest value)."""
    fields = {}
    for name in SolveResult._fields:
        vals = [getattr(r, name) for r, _ in parts]
        if isinstance(vals[0], Tensor):
            fields[name] = torch.cat([v[:n].to(device) for v, (_, n) in zip(vals, parts)])
        else:
            fields[name] = max(vals)
    return SolveResult(**fields)
