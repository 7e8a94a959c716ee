"""GAME dataset: row-aligned columns of scored examples with id columns.

Counterpart of ``photon_ml_tpu/game/dataset.py:25-129``: the response,
offset and weight vectors, one feature shard per name (every shard's rows
are the examples) and integer-coded id columns with their vocabularies.
The shards stay on the host as row-sorted COO (``FeatureShard``): the
random-effect build groups them with numpy. The solves and the scoring read
one device copy per shard, a ``CSRBatch`` built once and cached
(``csr_batch``). A streamed dataset (``ingest/assemble.py``) holds its
shards the other way round, on the device (``DeviceShards``): ``csr_batch``
returns the assembled batch and ``shard`` fetches the host COO from it on
first use, where the reference fetches too
(``photon_ml_tpu/game/random_effect_data.py:316-321``). Nothing is padded:
PyTorch runs eagerly, so every per-row vector has exactly ``num_rows``
entries.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.ops.sparse import validate_coo_indices


@dataclasses.dataclass(frozen=True)
class FeatureShard:
    """One feature shard as host COO sorted by row (float32 values, as the
    reference's ``SparseBatch`` holds them)."""

    values: np.ndarray  # f32[nnz]
    rows: np.ndarray  # i64[nnz], non-decreasing
    cols: np.ndarray  # i64[nnz]
    num_features: int

    @staticmethod
    def from_coo(values, rows, cols, num_features: int) -> "FeatureShard":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        values = np.asarray(values, np.float32)
        if len(rows) and not np.all(rows[1:] >= rows[:-1]):
            order = np.argsort(rows, kind="stable")
            values, rows, cols = values[order], rows[order], cols[order]
        return FeatureShard(values=values, rows=rows, cols=cols,
                            num_features=int(num_features))

    @staticmethod
    def from_dense(X) -> "FeatureShard":
        X = np.asarray(X)
        rows, cols = np.nonzero(X)
        return FeatureShard.from_coo(X[rows, cols], rows, cols, X.shape[1])


class DeviceShards(Mapping[str, FeatureShard]):
    """Feature shards that live on the device, one ``CSRBatch`` each
    (``batches``). Reading one as a host ``FeatureShard`` fetches its CSR
    once and keeps it: the rows expanded from the row pointer, columns as
    int64, values as they are."""

    def __init__(self, batches: Mapping[str, CSRBatch]):
        self.batches = dict(batches)
        self._host: dict[str, FeatureShard] = {}

    def __getitem__(self, name: str) -> FeatureShard:
        hit = self._host.get(name)
        if hit is None:
            b = self.batches[name]
            counts = np.diff(b.row_ptr.cpu().numpy().astype(np.int64))
            hit = FeatureShard(values=b.vals.cpu().numpy(),
                               rows=np.repeat(np.arange(len(counts), dtype=np.int64), counts),
                               cols=b.cols.cpu().numpy().astype(np.int64),
                               num_features=b.num_features)
            self._host[name] = hit
        return hit

    def __contains__(self, name) -> bool:
        return name in self.batches

    def __iter__(self) -> Iterator[str]:
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


@dataclasses.dataclass(frozen=True)
class IdColumn:
    """An entity-id column: dense integer codes + the value vocabulary."""

    codes: np.ndarray  # int64[n] index into vocab
    vocab: np.ndarray  # unique original values (any dtype), code -> value

    @property
    def num_entities(self) -> int:
        return len(self.vocab)

    @staticmethod
    def from_values(values: Sequence) -> "IdColumn":
        vocab, codes = np.unique(np.asarray(values), return_inverse=True)
        return IdColumn(codes=codes.astype(np.int64), vocab=vocab)


@dataclasses.dataclass(frozen=True)
class GameDataset:
    """Row-aligned columnar GAME data; ``device`` is where it is solved."""

    response: np.ndarray  # f64[n]
    offset: np.ndarray  # f64[n]
    weight: np.ndarray  # f64[n]
    feature_shards: Mapping[str, FeatureShard]
    id_columns: Mapping[str, IdColumn]
    device: torch.device

    @property
    def num_rows(self) -> int:
        return len(self.response)

    def shard(self, name: str) -> FeatureShard:
        if name not in self.feature_shards:
            raise KeyError(
                f"unknown feature shard '{name}'; have {sorted(self.feature_shards)}"
            )
        return self.feature_shards[name]

    def csr_batch(self, name: str) -> CSRBatch:
        """The shard on the device as a ``CSRBatch`` with the response, base
        offsets and weights attached, built once and cached: the
        fixed-effect solves and every scoring pass share one copy. A shard
        that lives on the device is its batch."""
        if isinstance(self.feature_shards, DeviceShards):
            if name not in self.feature_shards:
                self.shard(name)  # the unknown-shard error
            return self.feature_shards.batches[name]
        cache = self.__dict__.setdefault("_csr_batches", {})
        hit = cache.get(name)
        if hit is None:
            s = self.shard(name)
            hit = CSRBatch.from_coo(s.values, s.rows, s.cols, self.response, s.num_features,
                                    offsets=self.offset, weights=self.weight,
                                    device=self.device)
            cache[name] = hit
        return hit

    def per_row(self, a: np.ndarray) -> torch.Tensor:
        """A host per-row vector as a float32 device tensor."""
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)


def build_game_dataset(
    response: np.ndarray,
    feature_shards: Mapping[str, FeatureShard],
    id_columns: Optional[Mapping[str, Sequence]] = None,
    offset: Optional[np.ndarray] = None,
    weight: Optional[np.ndarray] = None,
    device: torch.device | str | None = None,
) -> GameDataset:
    """Assemble a dataset solved on ``device`` (default cuda). Every shard's
    row ids must index the ``len(response)`` examples."""
    dev = resolve_device(device)
    n = len(response)
    for name, s in feature_shards.items():
        if not isinstance(s, FeatureShard):
            raise TypeError(f"feature shard '{name}' must be a FeatureShard")
        validate_coo_indices(s.rows, s.cols, n, s.num_features)
    return GameDataset(
        response=np.asarray(response, np.float64),
        offset=np.zeros(n) if offset is None else np.asarray(offset, np.float64),
        weight=np.ones(n) if weight is None else np.asarray(weight, np.float64),
        feature_shards=dict(feature_shards),
        id_columns={
            k: v if isinstance(v, IdColumn) else IdColumn.from_values(v)
            for k, v in (id_columns or {}).items()
        },
        device=dev,
    )
