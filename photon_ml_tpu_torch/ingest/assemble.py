"""Out-of-core GameDataset assembly from a ``ChunkStream``.

Counterpart of ``photon_ml_tpu/ingest/assemble.py``. The host holds only
the staging ring; the feature payload accumulates on the device, shard by
shard, as a CSR that grows chunk by chunk: values and columns are appended
into buffers whose capacity doubles (``ShardAssembler._ensure``, as the
reference's ``_ensure``), and each chunk's row pointer lands at its rows,
offset by the nonzeros before it. At the end each shard becomes a
``CSRBatch`` built where it lies (``CSRBatch.from_device_csr``: the mirror,
the tile index and the slot order on the device). Chunks arrive in plan
order, so the arrays are bit for bit the in-core reader's, and a fit on
them is bit for bit the in-core fit.

Row scalars (response, offset, weight: exact float64) and id codes are a
few bytes a row and stay on the host, as ``GameDataset`` keeps them.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ingest.pipeline import ChunkCSR, ChunkStream, IngestSpec
from photon_ml_tpu_torch.ops.csr import CSRBatch
from photon_ml_tpu_torch.telemetry.executables import instrumented

Tensor = torch.Tensor

_INT32_MAX = 2**31 - 1


@instrumented(name="ingest_assemble_write")
def _write_chunk(v: Tensor, c: Tensor, row_ptr: Tensor, csr: ChunkCSR, at: int,
                 row_start: int) -> None:
    """One chunk's values and columns at ``at`` and its row pointer at its
    rows, offset by the ``at`` nonzeros before it, in place."""
    nnz, rows = csr.nnz, csr.row_ptr.shape[0] - 1
    v[at:at + nnz] = csr.vals
    c[at:at + nnz] = csr.cols
    row_ptr[row_start + 1:row_start + rows + 1] = csr.row_ptr[1:].long() + at


class ShardAssembler:
    """One feature shard's CSR, grown on ``device`` chunk by chunk."""

    def __init__(self, num_features: int, num_rows: int, initial_nnz: int,
                 device: torch.device):
        self.num_features = int(num_features)
        self.device = device
        cap = max(int(initial_nnz), 1)
        self._v = torch.empty(cap, dtype=torch.float32, device=device)
        self._c = torch.empty(cap, dtype=torch.int32, device=device)
        self._row_ptr = torch.zeros(int(num_rows) + 1, dtype=torch.int64, device=device)
        self._nnz = 0

    def _ensure(self, need: int) -> None:
        cap = self._v.shape[0]
        if need <= cap:
            return
        new_cap = max(cap * 2, need)
        v = torch.empty(new_cap, dtype=torch.float32, device=self.device)
        c = torch.empty(new_cap, dtype=torch.int32, device=self.device)
        v[:self._nnz] = self._v[:self._nnz]
        c[:self._nnz] = self._c[:self._nnz]
        self._v, self._c = v, c

    def add(self, csr: ChunkCSR, row_start: int) -> None:
        """Append one chunk's nonzeros; its rows start at ``row_start``."""
        self._ensure(self._nnz + csr.nnz)
        _write_chunk(self._v, self._c, self._row_ptr, csr, self._nnz, row_start)
        self._nnz += csr.nnz

    def finish(self, labels: np.ndarray, offsets: np.ndarray,
               weights: np.ndarray) -> CSRBatch:
        """The shard as a ``CSRBatch`` with the row scalars attached (as
        ``GameDataset.csr_batch`` attaches them), trimmed to its nonzeros;
        refused past the int32 index range at the real count."""
        nnz = self._nnz
        if nnz > _INT32_MAX:
            raise ValueError(f"{nnz} nonzeros exceed the int32 index range")
        v, c = self._v[:nnz], self._c[:nnz]
        if self._v.shape[0] != nnz:  # give the unused capacity back
            v, c = v.clone(), c.clone()
        self._v = self._c = None
        return CSRBatch.from_device_csr(self._row_ptr, c, v, labels, self.num_features,
                                        offsets=offsets, weights=weights)


def read_game_dataset_streamed(
    paths,
    feature_shards: Optional[Mapping[str, Sequence[str]]] = None,
    index_maps: Optional[Mapping] = None,
    id_columns: Sequence[str] = (),
    add_intercept: bool = True,
    is_response_required: bool = True,
    spec: Optional[IngestSpec] = None,
    return_index_maps: bool = False,
    device: torch.device | str | None = None,
):
    """The out-of-core counterpart of ``read_game_dataset_from_avro``, on
    ``device`` (default cuda).

    Streams the files through a ``ChunkStream`` (block decode in parallel
    into the staging ring, upload one chunk ahead) and assembles a
    GameDataset whose feature shards live on the device, bit for bit the
    in-core reader's arrays. ``index_maps`` are built by the vocab-only scan
    when absent (a stream cannot discover the feature space as it goes).
    """
    from photon_ml_tpu_torch.data.avro import _as_paths, build_index_maps_from_avro
    from photon_ml_tpu_torch.game.dataset import DeviceShards, GameDataset, IdColumn

    dev = resolve_device(device)
    feature_shards = dict(feature_shards or {"features": ("features",)})
    file_list = _as_paths(paths)
    if index_maps is None:
        index_maps = build_index_maps_from_avro(file_list, feature_shards,
                                                add_intercept=add_intercept)
    stream = ChunkStream(file_list, feature_shards=feature_shards, index_maps=index_maps,
                         id_columns=id_columns, add_intercept=add_intercept,
                         is_response_required=is_response_required, spec=spec, device=dev)
    n = stream.total_rows
    if n == 0:
        stream.close()
        raise ValueError(f"no records in {file_list}")
    labels = np.empty(n, np.float64)
    offsets = np.empty(n, np.float64)
    weights = np.empty(n, np.float64)
    codes = {c: np.empty(n, np.int64) for c in id_columns}
    est = n * (spec or IngestSpec()).nnz_per_row_hint
    asms = {name: ShardAssembler(len(index_maps[name]), n, est, dev) for name in feature_shards}
    with telemetry.span("ingest_assemble", rows=n, chunks=len(stream.plans)), stream:
        for chunk in stream:
            sl = slice(chunk.row_start, chunk.row_start + chunk.rows)
            labels[sl] = chunk.labels
            offsets[sl] = chunk.offsets
            weights[sl] = chunk.weights
            for col in id_columns:
                codes[col][sl] = chunk.id_codes[col]
            for name, asm in asms.items():
                asm.add(chunk.shards[name], chunk.row_start)
    batches = {name: asm.finish(labels, offsets, weights) for name, asm in asms.items()}
    # id codes: sort the stream-global vocabulary and rank-remap, as the
    # in-core reader does (models score by searchsorted over it)
    id_cols = {}
    for col in id_columns:
        vocab = stream.id_vocabulary(col)
        order = np.argsort(vocab)
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        raw = codes[col]
        id_cols[col] = IdColumn(codes=rank[raw] if len(raw) else raw, vocab=vocab[order])
    ds = GameDataset(response=labels, offset=offsets, weight=weights,
                     feature_shards=DeviceShards(batches), id_columns=id_cols, device=dev)
    return (ds, index_maps) if return_index_maps else ds
