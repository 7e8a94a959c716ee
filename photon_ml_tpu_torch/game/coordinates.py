"""GAME coordinates: the per-block training strategies that coordinate
descent drives.

Counterpart of ``photon_ml_tpu/game/coordinates.py``:

- ``FixedEffectCoordinate`` (:86-345): one GLM solve over the shard's
  ``CSRBatch``, built once per dataset. Residual scores from the other
  coordinates enter as offsets (``with_offsets``), never by rebuilding the
  CSR or its CSC mirror, so each LBFGS iteration launches the margins and
  scatter kernels on the resident layout; scoring is the batch's
  ``dot_rows``. Down-sampling re-weights the rows per update.
- ``RandomEffectCoordinate`` (:552-754): per geometry bucket, one batched
  Newton solve over every entity of the bucket on its dense design.

The reference's mesh, guard and tracker hooks and the fixed effect's
normalization are left out. What else is not ported raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect_data import RandomEffectDataset
from photon_ml_tpu_torch.ops.objective import make_objective
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import SolveResult
from photon_ml_tpu_torch.optim.factory import OptimizerConfig, OptimizerType, dispatch_solve

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

    def __post_init__(self):
        self.config.validate(self.loss_name)
        self._batch = self.data.csr_batch(self.shard_name)
        self._constraints = self.config.build_box_constraints(self._batch.num_features,
                                                              self.data.device)
        reg = self.config.regularization
        self._obj = make_objective(self.loss_name,
                                   l2_weight=reg.l2_weight(self.config.regularization_weight))
        self._l1 = reg.l1_weight(self.config.regularization_weight)
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
        res = dispatch_solve(glm_adapter(self._obj, batch), model.coefficients, self.config,
                             self._l1, self._constraints, device=self.data.device)
        self.last_results = [res]
        return dataclasses.replace(model, coefficients=res.w)

    def score(self, model: FixedEffectModel) -> Tensor:
        return self._batch.dot_rows(model.coefficients)


@dataclasses.dataclass
class RandomEffectCoordinate:
    """Per-entity GLM blocks: each bucket's entities are solved by one
    batched Newton over the bucket's dense design (``optim/newton.py``)."""

    name: str
    data: GameDataset
    re_data: RandomEffectDataset
    loss_name: str
    config: OptimizerConfig
    compute_variances: bool = False

    def __post_init__(self):
        self.config.validate(self.loss_name)
        if self.compute_variances:
            raise NotImplementedError(NOT_PORTED.format("compute_variances of a random effect", 8))
        if self.config.optimizer_type != OptimizerType.NEWTON:
            raise NotImplementedError(NOT_PORTED.format(
                f"a random effect solved with {self.config.optimizer_type.name} (only NEWTON "
                "is)", 8))
        if self.config.box_constraints:
            raise NotImplementedError(NOT_PORTED.format("a box constraint on a random effect", 8))
        self._buckets = self.re_data.dense_buckets(self.data.device)
        coo = [i for i, b in enumerate(self._buckets) if b is None]
        if coo:
            raise NotImplementedError(NOT_PORTED.format(
                f"the COO layout of random-effect buckets {coo} (the dense design is over "
                "the routing rule's budget)", 8))
        reg = self.config.regularization
        self._obj = make_objective(self.loss_name,
                                   l2_weight=reg.l2_weight(self.config.regularization_weight))
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
        for b, bm in zip(self._buckets, model.buckets):
            res = dispatch_solve(glm_adapter(self._obj, b.batch(residual_scores)),
                                 bm.coefficients, self.config, device=self.data.device)
            results.append(res)
            new_buckets.append(dataclasses.replace(bm, coefficients=res.w))
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
