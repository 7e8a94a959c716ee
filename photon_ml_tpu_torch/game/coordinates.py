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

The reference's mesh, guard and tracker hooks are left out. ``NOT_PORTED``
is the message of what the port refuses, naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints, SolveResult
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    build_objective,
    dispatch_solve,
    solve,
)

Tensor = torch.Tensor

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

    def __post_init__(self):
        self.config.validate(self.loss_name)
        self._batch = self.data.csr_batch(self.shard_name)
        self._constraints = self.config.build_box_constraints(self._batch.num_features,
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
            coefficients=torch.zeros(self._batch.num_features, dtype=torch.float32,
                                     device=self.data.device),
            shard_name=self.shard_name,
        )

    def update_model(self, model: FixedEffectModel,
                     residual_scores: Optional[Tensor]) -> FixedEffectModel:
        update_index = self._update_count
        self._update_count += 1
        batch = self._batch
        if self.config.down_sampling_rate < 1.0:
            batch = dataclasses.replace(batch, weights=self._downsampled_weights(update_index))
        if residual_scores is not None:
            batch = batch.with_offsets(self._batch.offsets + residual_scores)
        norm = self.normalization
        w0 = model.coefficients
        if norm is not None:
            # models live in the original space, the solve in the normalized one
            w0 = norm.inverse_transform_model_coefficients(w0)
        res = solve(self.loss_name, batch, self.config, w0, self._constraints,
                    factors=None if norm is None else norm.factors,
                    shifts=None if norm is None else norm.shifts, device=self.data.device)
        self.last_results = [res]
        w = res.w if norm is None else norm.transform_model_coefficients(res.w)
        return dataclasses.replace(model, coefficients=w)

    def score(self, model: FixedEffectModel) -> Tensor:
        return self._batch.dot_rows(model.coefficients)


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

    def __post_init__(self):
        self.config.validate(self.loss_name)
        if self.compute_variances and not get_loss(self.loss_name).has_hessian:
            raise ValueError("coefficient variances need a twice-differentiable loss; "
                             f"'{self.loss_name}' is not")
        dev = self.data.device
        dense = self.re_data.dense_buckets(dev)
        coo = self.re_data.coo_buckets(dev)
        self._buckets = tuple(d if d is not None else c for d, c in zip(dense, coo))
        # the boxes address global features; each entity's local space is its
        # projection, so the bounds gather through it into [E, K] per bucket
        # (the padding id num_global gathers the unbounded sentinel slot)
        self._constraints: list[Optional[BoxConstraints]] = [None] * len(self._buckets)
        bounds = self.config.dense_box_bounds(self.re_data.num_global_features, sentinel=True)
        if bounds is not None:
            lower, upper = bounds
            self._constraints = [
                BoxConstraints(lower=torch.from_numpy(lower[b.projection]).to(dev),
                               upper=torch.from_numpy(upper[b.projection]).to(dev))
                for b in self.re_data.buckets]
        self._obj = build_objective(self.loss_name, self.config)
        self._l1 = self.config.regularization.l1_weight(self.config.regularization_weight)
        self.last_results: list[SolveResult] = []

    def initialize_model(self) -> RandomEffectModel:
        dev = self.data.device
        buckets = tuple(
            RandomEffectBucketModel(
                coefficients=torch.zeros((b.num_entities, b.num_local_features),
                                         dtype=torch.float32, device=dev),
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
        new_buckets, results = [], []
        for b, bm, box in zip(self._buckets, model.buckets, self._constraints):
            batch = b.batch(residual_scores)
            res = dispatch_solve(glm_adapter(self._obj, batch), bm.coefficients, self.config,
                                 self._l1, box, device=self.data.device)
            var = None
            if self.compute_variances:
                var = 1.0 / (self._obj.hessian_diagonal(res.w, batch) + _VARIANCE_EPS)
            results.append(res)
            new_buckets.append(dataclasses.replace(bm, coefficients=res.w, variances=var))
        self.last_results = results
        return dataclasses.replace(model, buckets=tuple(new_buckets))

    def score(self, model: RandomEffectModel) -> Tensor:
        """Scores on the training data: the bucket margins for active rows,
        the model's projection lookup for passive rows."""
        scores = torch.zeros(self.data.num_rows, dtype=torch.float32, device=self.data.device)
        for b, bm in zip(self._buckets, model.buckets):
            margins = b.batch().dot_rows(bm.coefficients).reshape(-1)
            # each active row sits in exactly one bucket slot, so writing the
            # slots into zeros is exact in any order
            scores.index_put_((b.slot_rows,), margins.index_select(0, b.slots))
        if len(self.re_data.passive_rows):
            passive = torch.from_numpy(self.re_data.passive_rows).to(self.data.device)
            scores[passive] = model.score(self.data).index_select(0, passive)
        return scores
