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
from photon_ml_tpu_torch.parallel.sharding import OwnerBlocks, joined

Tensor = torch.Tensor


def lookup_terms(projection: Tensor, coefficients: Tensor, pos: Tensor, cols: Tensor,
                 vals: Tensor) -> Tensor:
    """Each nonzero's term ``vals * coef``: nonzero i's coefficient is found
    by binary search for ``cols[i]`` in row ``pos[i]`` of the sorted
    ``projection`` [E, K] (0 where the row lacks the column)."""
    proj = projection.index_select(0, pos)  # [m, K]
    k = torch.searchsorted(proj, cols.unsqueeze(1)).clamp_(max=proj.shape[1] - 1)
    hit = proj.gather(1, k).squeeze(1) == cols
    coef = coefficients.index_select(0, pos).gather(1, k).squeeze(1)
    return vals * torch.where(hit, coef, 0.0)


def map_vocab_codes(vocab: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Codes of raw id values in a sorted vocabulary; -1 for values the
    vocabulary has never seen (entity identity is the id value)."""
    pos = np.searchsorted(vocab, values)
    pos_c = np.minimum(pos, len(vocab) - 1)
    hit = vocab[pos_c] == values
    return np.where(hit, pos_c, -1)


def _bucket_terms(bm, pos: Tensor, cols: Tensor, vals: Tensor, host_pos: np.ndarray) -> Tensor:
    """``lookup_terms`` of one bucket. Coefficients kept by their owners
    (``OwnerBlocks``) are read where they lie: each owner computes the terms
    of its entities' nonzeros, which are written to their places on the
    scores' device (each place once), so the terms are the same values as
    over the joined table."""
    coef = bm.coefficients
    if not isinstance(coef, OwnerBlocks):
        return lookup_terms(bm.projection, coef, pos, cols, vals)
    terms = torch.zeros(len(host_pos), dtype=torch.float32, device=pos.device)
    for (lo, hi), part in zip(coef.owner_ranges(), coef.parts):
        sel = np.flatnonzero((host_pos >= lo) & (host_pos < hi))
        if not len(sel):
            continue
        at = torch.from_numpy(sel).to(pos.device)
        d = part.device
        proj = bm.projection.index_select(0, pos.index_select(0, at)).to(d)
        local = torch.from_numpy(host_pos[sel].astype(np.int64) - lo).to(d)
        # the projection rows gathered already: positions into them are 0..m-1
        got = lookup_terms(proj, part.index_select(0, local),
                           torch.arange(len(sel), device=d), cols.index_select(0, at).to(d),
                           vals.index_select(0, at).to(d))
        terms.index_copy_(0, at, got.to(pos.device))
    return terms


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM coefficients over one feature shard (original space)."""

    coefficients: Tensor  # f32[num_features]
    shard_name: str

    def score(self, data: GameDataset) -> Tensor:
        """x.w for every example row, through the shard's CSR margins kernel."""
        return data.csr_batch(self.shard_name).dot_rows(self.coefficients)

    def to_summary_string(self) -> str:
        w = self.coefficients.detach().cpu().double()
        nnz = int((w.abs() > 1e-9).sum())
        return (f"FixedEffectModel(shard={self.shard_name}, features={len(w)}, "
                f"nonzero={nnz}, |w|2={float(torch.linalg.vector_norm(w)):.4g})")


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

    def gathered(self) -> "RandomEffectModel":
        """The model with every owner-kept table joined on its first device."""
        return dataclasses.replace(self, buckets=tuple(
            dataclasses.replace(b, coefficients=joined(b.coefficients),
                                variances=joined(b.variances)) for b in self.buckets))

    def to_summary_string(self) -> str:
        n_models = int(np.sum(self.entity_bucket >= 0))
        dims = [int(b.coefficients.shape[1]) for b in self.buckets]
        return (f"RandomEffectModel(id={self.id_name}, shard={self.shard_name}, "
                f"entities={n_models}/{len(self.vocab)}, "
                f"buckets={len(self.buckets)}, local_dims={dims})")

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
            rows = shard.rows[sel]  # non-decreasing: the shard is sorted by row
            starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
            lengths = torch.from_numpy(np.diff(np.r_[starts, len(rows)])).to(dev)
            v = torch.from_numpy(shard.values[sel]).to(dev)
            g = torch.from_numpy(shard.cols[sel]).to(dev)
            pos = torch.from_numpy(row_pos[rows].astype(np.int64)).to(dev)
            terms = _bucket_terms(bm, pos, g, v, row_pos[rows]).unsqueeze(1)
            # each row's terms summed in a fixed order (no float atomics, so
            # a score repeats bit for bit), then written to its own place
            scores[torch.from_numpy(rows[starts]).to(dev)] = torch.segment_reduce(
                terms, "sum", lengths=lengths)[:, 0]
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

    def gathered(self) -> "GameModel":
        """The model with the sub-models' owner-kept tables joined, for a
        caller that returns or saves it."""
        return dataclasses.replace(self, models={
            name: m.gathered() if hasattr(m, "gathered") else m for name, m in self.models.items()})

    def with_model(self, name: str, model) -> "GameModel":
        new = dict(self.models)
        new[name] = model
        return dataclasses.replace(self, models=new)

    def to_summary_string(self) -> str:
        """One line for the model, then one per sub-model."""
        lines = [f"GameModel(task={self.task}, coordinates={len(self.models)})"]
        for name, sub in self.models.items():
            summary = sub.to_summary_string() if hasattr(sub, "to_summary_string") else repr(sub)
            lines.append(f"  {name}: {summary}")
        return "\n".join(lines)

    def predict_mean(self, data: GameDataset) -> Tensor:
        scores = self.score(data) + data.per_row(data.offset)
        name = get_loss(self.task).name
        if name == "logistic":
            return torch.sigmoid(scores)
        if name == "poisson":
            return torch.exp(scores)
        return scores
