"""GAME model containers: fixed effect, random effect, and the composite
model whose score is the sum of its sub-models' scores.

Counterpart of ``photon_ml_tpu/game/models.py:32-276``. Sub-model scores are
raw margins x.w (no offsets, no link); offsets enter through the training
objectives and the evaluators' inputs. Scores are ``[num_rows]`` tensors on
the dataset's device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor


def map_vocab_codes(vocab: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Codes of raw id values in a sorted vocabulary; -1 for values the
    vocabulary has never seen (entity identity is the id value)."""
    pos = np.searchsorted(vocab, values)
    pos_c = np.minimum(pos, len(vocab) - 1)
    hit = vocab[pos_c] == values
    return np.where(hit, pos_c, -1)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM coefficients over one feature shard (original space)."""

    coefficients: Tensor  # f32[num_features]
    shard_name: str

    def score(self, data: GameDataset) -> Tensor:
        """x.w for every example row, through the shard's CSR margins kernel."""
        return data.csr_batch(self.shard_name).dot_rows(self.coefficients)


@dataclasses.dataclass(frozen=True)
class RandomEffectBucketModel:
    """Per-entity coefficients of one bucket, aligned with its sorted
    projection (local id k <-> global feature projection[e, k])."""

    coefficients: Tensor  # f32[E, K]
    projection: Tensor  # i64[E, K] sorted global ids; sentinel = num_global
    entity_codes: np.ndarray  # i32[E]
    variances: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """All per-entity models of one random-effect coordinate."""

    id_name: str
    shard_name: str
    buckets: tuple[RandomEffectBucketModel, ...]
    entity_bucket: np.ndarray  # host: training entity code -> bucket (-1 none)
    entity_pos: np.ndarray
    vocab: np.ndarray  # training id vocabulary (sorted unique values)

    def _grouping_for(self, data: GameDataset) -> tuple[np.ndarray, np.ndarray]:
        """(row_bucket, row_pos) host arrays for ``data`` (-1 for entities
        without a model), memoized on the dataset per (id column, vocab)
        and checked by table identity."""
        cache = data.__dict__.setdefault("_re_group_cache", {})
        key = (self.id_name, id(self.vocab))
        entry = cache.get(key)
        if (entry is not None and entry["vocab"] is self.vocab
                and entry["entity_bucket"] is self.entity_bucket
                and entry["entity_pos"] is self.entity_pos):
            return entry["row_bucket"], entry["row_pos"]
        idc = data.id_columns[self.id_name]
        codes = map_vocab_codes(self.vocab, idc.vocab[idc.codes])
        known = codes >= 0
        safe = np.where(known, codes, 0)
        row_bucket = np.where(known, self.entity_bucket[safe], -1)
        row_pos = np.where(known, self.entity_pos[safe], -1)
        cache[key] = {"vocab": self.vocab, "entity_bucket": self.entity_bucket,
                      "entity_pos": self.entity_pos, "row_bucket": row_bucket,
                      "row_pos": row_pos}
        return row_bucket, row_pos

    def score(self, data: GameDataset) -> Tensor:
        """Scores for every example row; entities without a model score 0.
        Each nonzero finds its coefficient by binary search over its
        entity's sorted projection (``models.py:155-224``)."""
        if data.id_columns.get(self.id_name) is None:
            raise KeyError(f"scoring data lacks id column '{self.id_name}'")
        shard = data.shard(self.shard_name)
        dev = data.device
        row_bucket, row_pos = self._grouping_for(data)
        live = shard.values != 0
        scores = torch.zeros(data.num_rows, dtype=torch.float32, device=dev)
        for b_idx, bm in enumerate(self.buckets):
            sel = np.flatnonzero(live & (row_bucket[shard.rows] == b_idx))
            if not len(sel):
                continue
            rows = shard.rows[sel]
            v = torch.from_numpy(shard.values[sel]).to(dev)
            g = torch.from_numpy(shard.cols[sel]).to(dev)
            pos = torch.from_numpy(row_pos[rows].astype(np.int64)).to(dev)
            proj = bm.projection.index_select(0, pos)  # [m, K]
            k = torch.searchsorted(proj, g.unsqueeze(1)).clamp(max=proj.shape[1] - 1)
            hit = proj.gather(1, k).squeeze(1) == g
            coef = bm.coefficients.index_select(0, pos).gather(1, k).squeeze(1)
            scores.index_add_(0, torch.from_numpy(rows).to(dev),
                              v * torch.where(hit, coef, 0.0))
        return scores


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Named sub-models; score = sum of the sub-models' scores. All
    coordinates share one task."""

    task: str
    models: Mapping[str, object]  # name -> FixedEffectModel | RandomEffectModel

    def __post_init__(self):
        get_loss(self.task)

    def score(self, data: GameDataset) -> Tensor:
        total = None
        for model in self.models.values():
            s = model.score(data)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("GAME model has no sub-models")
        return total

    def predict_mean(self, data: GameDataset) -> Tensor:
        scores = self.score(data) + data.per_row(data.offset)
        name = get_loss(self.task).name
        if name == "logistic":
            return torch.sigmoid(scores)
        if name == "poisson":
            return torch.exp(scores)
        return scores
