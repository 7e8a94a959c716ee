"""Device-resident scoring engine: upload the model once, serve forever.

Counterpart of ``photon_ml_tpu/serving/engine.py``. :class:`ScoringEngine`

- uploads the model ONCE at load: each fixed effect's ``w`` as f32[d] and
  each random-effect bucket's ``projection`` as int32[E, K] and
  ``coefficients`` as f32[E, K] (entity-sharded over a mesh's model axis
  with ``mesh=``); the entity-id -> (bucket, position) lookup stays on the
  host;
- assembles each request batch on the host into padded batch-size buckets
  (powers of two up to ``max_batch``, :func:`bucket_sizes_for`): per feature
  shard a CSR (``row_ptr`` int32[b+1], ``cols`` int32, ``vals`` f32), the
  offsets f32[b], and per random-effect coordinate the nonzeros of the rows
  whose entity has a model, grouped by owner and bucket. All of it is packed
  into ONE pinned host staging buffer per bucket size and reaches the
  device in one non-blocking copy;
- computes the fixed-effect term z = X.w with the hand-written
  ``kernels.csr_margins`` (TPU kernel row 1; its plain version only on the
  CPU), and the random-effect term by looking each nonzero's coefficient up
  in its entity's sorted projection row (``torch.searchsorted``, the exact
  lookup of ``RandomEffectModel.score``), summed per row in a fixed order
  (``torch.segment_reduce``, no float atomics) and written to the row's own
  place. Each row's score depends on its own features and entity only, so
  a score repeats bit for bit whatever rides the same batch;
- adds the offsets, applies the link (sigmoid, exp or identity) and fetches
  the scores with ONE host copy per score call (``telemetry.sync_fetch``);
- scores entities unseen at training time as fixed-effect-only (counted
  ``serving.unseen_entities``), and entities known but owned by another
  fleet member (bucket -1) as 0 from that coordinate
  (``serving.not_owned_entities``).

:meth:`warmup` runs every bucket once at full width (every row at
``max_row_nnz`` features and a known entity), so the first request pays no
kernel build, handle creation or allocator growth; ``compile_summary``
counts each bucket's calls, and a call in a bucket warm-up did not run
counts ``serving.unwarmed_bucket_calls``.

Nearline row updates (:meth:`apply_re_rows`) build the new table out of
place (clone, then ``index_copy_`` of the touched rows; never in place and
never ``index_add_``) and swap the table tuple under the version lock: a
score already running keeps reading the old tuple, and every untouched row
keeps its bits. Everything runs on the device's current stream, so no
tensor crosses streams.

Request row schema (JSON-safe)::

    {"features": {"<shard>": [[col, value], ...]},   # training feature ids
     "ids": {"<id_name>": "<entity value>"},
     "offset": 0.0}

Features may instead be named — ``[name, term, value]`` or
``{"name": ..., "term": ..., "value": ...}`` — and are then resolved
through the model's persisted ``feature-indexes/`` maps (unknown names
score 0 and count ``serving.unknown_features``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import kernels, telemetry
from photon_ml_tpu_torch.data.index_map import feature_key
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    lookup_terms,
)
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.parallel import sharding as psharding
from photon_ml_tpu_torch.quality import drift as quality_drift

logger = logging.getLogger("photon_ml_tpu_torch.serving.engine")

Tensor = torch.Tensor

# staging pieces start on 16-word boundaries (the kernels' 16-byte loads)
_ALIGN = 16


class BadRequest(ValueError):
    """A score request is malformed (unknown shard schema, feature count
    over ``max_row_nnz``, unresolvable named feature without an index
    map). Servers map this to HTTP 400, never 500."""


def bucket_sizes_for(max_batch: int) -> tuple[int, ...]:
    """Padded batch-size buckets: powers of two up to (and always
    including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def _aligned(n: int) -> int:
    return -(-int(n) // _ALIGN) * _ALIGN


class _Staging:
    """One bucket size's staging: an int32 host buffer (pinned on a CUDA
    device) and its device twin. Pieces are written at 16-word boundaries
    and named by ``(offset, length, is_float)``; ``upload`` copies the used
    prefix in one non-blocking copy."""

    def __init__(self, capacity: int, device: torch.device):
        self.device = device
        if device.type == "cuda":
            self.host = torch.empty(capacity, dtype=torch.int32, pin_memory=True)
            self.dev = torch.empty(capacity, dtype=torch.int32, device=device)
        else:
            self.host = torch.empty(capacity, dtype=torch.int32)
            self.dev = self.host
        self.np = self.host.numpy()
        self.used = 0

    def put(self, arr: np.ndarray, is_float: bool) -> tuple[int, int, bool]:
        off, n = self.used, int(arr.size)
        if n:
            view = self.np[off:off + n]
            (view.view(np.float32) if is_float else view)[:] = arr
        self.used = off + _aligned(n)
        return off, n, is_float

    def upload(self) -> None:
        if self.dev is not self.host and self.used:
            self.dev[:self.used].copy_(self.host[:self.used], non_blocking=True)

    def get(self, piece: tuple[int, int, bool]) -> Tensor:
        off, n, is_float = piece
        t = self.dev[off:off + n]
        return t.view(torch.float32) if is_float else t


@dataclasses.dataclass
class _REPart:
    """One owner's share of one random-effect coordinate in a batch: its
    nonzeros grouped by bucket (``counts`` per bucket, host ints), their
    columns, values and local entity positions, and the rows they sum into
    with each row's nonzero count."""

    counts: list
    cols: tuple
    vals: tuple
    pos: tuple
    rows: tuple
    lengths: tuple


@dataclasses.dataclass
class _Batch:
    """One assembled batch: staged pieces per shard, the offsets, and per
    random-effect coordinate one ``_REPart`` per owner (None: no nonzeros)."""

    size: int
    shards: list
    offsets: tuple
    re_parts: list
    gate: Optional[tuple] = None


def _restore_re_coordinate(model: GameModel, coord: str, ckpt_dir: str, mesh=None,
                           entity_axis: Optional[str] = None,
                           device: Optional[torch.device] = None) -> GameModel:
    """Replace one random-effect coordinate's coefficient table with the
    newest certified streamed checkpoint, placed straight onto the serving
    mesh (``restore_placed``: one block per device, never the whole table
    on one device) or onto ``device``."""
    from photon_ml_tpu_torch.data.model_store import ModelLoadError
    from photon_ml_tpu_torch.game.checkpoint import StreamingCheckpointManager

    sub = model.models.get(coord)
    if not isinstance(sub, RandomEffectModel):
        raise ModelLoadError(
            ckpt_dir,
            f"re_checkpoints names coordinate '{coord}', which is not a random-effect "
            f"coordinate of the model (has: {sorted(model.models)})")
    if len(sub.buckets) != 1:
        raise ModelLoadError(
            ckpt_dir,
            f"coordinate '{coord}' has {len(sub.buckets)} geometry buckets; streamed "
            "checkpoints hold ONE dense [E, K] table, so only single-bucket coordinates "
            "restore from one")
    manager = StreamingCheckpointManager.open_for_restore(ckpt_dir)
    restore = manager.restore_placed(mesh=mesh, axis=entity_axis, device=device)
    if restore is None:
        raise ModelLoadError(
            ckpt_dir, "no certified streamed checkpoint to restore the serving table for "
            f"coordinate '{coord}' from")
    bm = sub.buckets[0]
    got = tuple(int(d) for d in restore.coefficients.shape)
    want = tuple(int(d) for d in bm.coefficients.shape)
    if got != want:
        raise ModelLoadError(
            ckpt_dir, f"checkpoint table shape {got} does not match coordinate '{coord}' "
            f"table shape {want}")
    return model.with_model(coord, dataclasses.replace(
        sub, buckets=(dataclasses.replace(bm, coefficients=restore.coefficients),)))


class ScoringEngine:
    """A :class:`GameModel` in long-lived, device-resident scoring form,
    structurally immutable after construction: the registry hot-swaps by
    replacing the engine reference while requests in flight finish on the
    old one. The one mutation is :meth:`apply_re_rows` (nearline), which
    swaps the whole table tuple under the version lock.

    ``device`` (default cuda; ``"cpu"`` runs the kernels' plain versions)
    holds the tables; with ``mesh=`` (a mesh with a ``model``/``entity``
    axis) every random-effect table is split over that axis
    (``parallel.sharding.place_entities``), each owner computes the
    random-effect term of the rows whose entity it owns, and the fixed
    effect, the sums and the link run on the mesh's first device.
    """

    def __init__(
        self,
        model: GameModel,
        index_maps: Optional[Mapping] = None,
        max_batch: int = 64,
        max_row_nnz: int = 128,
        version: str = "unversioned",
        mesh=None,
        entity_axis: Optional[str] = None,
        lineage: Optional[dict] = None,
        device: torch.device | str | None = None,
    ):
        if max_row_nnz < 1:
            raise ValueError("max_row_nnz must be >= 1")
        self.model = model
        self.version = version
        self.lineage = lineage
        self.max_batch = int(max_batch)
        self.max_row_nnz = int(max_row_nnz)
        self.task = model.task
        self.bucket_sizes = bucket_sizes_for(self.max_batch)
        self.warm = False
        self._link = get_loss(model.task).name
        self._index_maps = dict(index_maps or {})
        self.mesh = mesh
        self.entity_axis = None
        if mesh is not None:
            self.entity_axis = entity_axis or psharding.model_axis(mesh)
            if self.entity_axis is None:
                raise ValueError(f"serving mesh {dict(mesh.shape)} has no model/entity axis "
                                 "to shard coefficient tables over")
            self.device = mesh.first_device
            self._owners = tuple(mesh.axis_devices(self.entity_axis))
        else:
            self.device = resolve_device(device)
            self._owners = (self.device,)
        dev = self.device

        shard_names: list[str] = []
        shard_dims: dict[str, Optional[int]] = {}
        coords: list[tuple] = []
        tables: list = []
        re_hosts: list[tuple] = []
        predicted_bytes = 0
        for name, sub in model.models.items():
            if isinstance(sub, FixedEffectModel):
                si = self._shard_slot(shard_names, sub.shard_name)
                shard_dims[sub.shard_name] = int(sub.coefficients.shape[0])
                coords.append(("fixed", si))
                tables.append(sub.coefficients.detach().to(dev, torch.float32).contiguous())
                predicted_bytes += 4 * int(sub.coefficients.shape[0])
            elif isinstance(sub, RandomEffectModel):
                si = self._shard_slot(shard_names, sub.shard_name)
                coords.append(("re", si, len(sub.buckets)))
                buckets = []
                for bm in sub.buckets:
                    num_e, local_k = (int(d) for d in bm.coefficients.shape)
                    if mesh is not None and num_e % len(self._owners):
                        # the valid sizes, not a bare modulus: the operator
                        # picking a serving mesh needs the sizes that can
                        # hold this coordinate's table
                        raise psharding.entity_axis_mismatch(
                            num_e, self.entity_axis, len(self._owners),
                            what=f"shard coordinate '{name}' on the serving mesh")
                    buckets.append((self._place(bm.projection, torch.int32),
                                    self._place(bm.coefficients, torch.float32)))
                    # coefficients + int32 projection, both 4-byte
                    predicted_bytes += 8 * num_e * local_k
                tables.append(tuple(buckets))
                re_hosts.append((
                    sub.id_name,
                    {str(v): i for i, v in enumerate(np.asarray(sub.vocab).tolist())},
                    np.array(sub.entity_bucket, dtype=np.int32),
                    np.array(sub.entity_pos, dtype=np.int32),
                ))
            else:
                raise TypeError(f"coordinate '{name}': online serving supports fixed and "
                                f"random effects, not {type(sub).__name__}")
        if not coords:
            raise ValueError("GAME model has no sub-models")
        self._shard_names = tuple(shard_names)
        self._coords = tuple(coords)
        self._re_hosts = tuple(re_hosts)
        self._re_coord_indices = tuple(ci for ci, spec in enumerate(self._coords)
                                       if spec[0] == "re")
        # per-shard feature-space bound for request validation: an
        # out-of-range id would read past the table (the silent-wrong-scores
        # hazard); FE coefficients give the exact dim, an index map gives it
        # for RE-only shards, None leaves that shard unchecked
        self._shard_dims = tuple(
            shard_dims.get(s) if shard_dims.get(s) is not None
            else (len(self._index_maps[s]) if s in self._index_maps else None)
            for s in self._shard_names)
        self._tables = tuple(tables)
        self.model_bytes = predicted_bytes
        if dev.type == "cuda":
            free, _total = torch.cuda.mem_get_info(dev)
            if predicted_bytes > free:
                logger.warning("serving model %s needs %d bytes of tables, %d free on %s",
                               version, predicted_bytes, free, dev)
        # the VERSION LOCK: apply_re_rows builds and swaps the whole table
        # tuple under it; scoring reads self._tables once, without it (old
        # tuple or new tuple, never torn)
        self._version_lock = threading.Lock()
        # one request batch at a time owns the staging buffers
        self._score_lock = threading.Lock()
        self._staging: dict[int, _Staging] = {}
        self.nearline_seq = 0
        self._bucket_stats: dict[int, dict] = {}
        telemetry.gauge("serving.model_bytes").set(predicted_bytes)

    def _place(self, t: Tensor, dtype: torch.dtype):
        """A table on the device, or split over the mesh's entity axis (a
        table restored already placed on this axis stays as it is)."""
        if isinstance(t, psharding.EntityShards):
            if self.mesh is None or t.axis != self.entity_axis or len(t.parts) != len(self._owners):
                raise ValueError("a table placed on another mesh cannot be served here")
            return psharding.EntityShards(parts=tuple(p.to(d, dtype).contiguous() for p, d in
                                                      zip(t.parts, self._owners)),
                                          mesh=t.mesh, axis=t.axis)
        t = t.detach().to(dtype)
        if self.mesh is None:
            return t.to(self.device).contiguous()
        return psharding.place_entities(t, self.mesh, self.entity_axis)

    @property
    def index_maps(self) -> dict:
        """The per-shard feature index maps this engine resolves named
        features through (empty when constructed without any)."""
        return self._index_maps

    @staticmethod
    def _shard_slot(shard_names: list[str], name: str) -> int:
        if name not in shard_names:
            shard_names.append(name)
        return shard_names.index(name)

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(
        cls,
        model_dir: str,
        max_batch: int = 64,
        max_row_nnz: int = 128,
        version: Optional[str] = None,
        require_feature_indexes: bool = True,
        mesh=None,
        entity_axis: Optional[str] = None,
        re_checkpoints: Optional[Mapping[str, str]] = None,
        device: torch.device | str | None = None,
    ) -> "ScoringEngine":
        """Build an engine from a saved model directory (either package's
        layout) on ``device`` (default cuda) or over ``mesh``.
        ``feature-indexes/`` is required by default: without the training
        feature space pinned next to the coefficients, named features cannot
        be resolved and integer ids cannot be trusted. ``re_checkpoints``
        maps coordinate name -> streamed-checkpoint directory whose newest
        table replaces the stored one (``restore_placed``)."""
        from photon_ml_tpu_torch.data.model_store import (
            ModelLoadError,
            load_feature_index_maps,
            load_game_model,
            load_game_model_metadata,
        )

        dev = mesh.first_device if mesh is not None else resolve_device(device)
        index_maps = load_feature_index_maps(model_dir)
        if index_maps is None and require_feature_indexes:
            raise ModelLoadError(
                os.path.join(model_dir, "feature-indexes"),
                "missing feature-indexes/ — the serving feature space cannot be pinned to "
                "the stored coefficients, so scores would be silently wrong")
        model = load_game_model(model_dir, device=dev)
        for coord, ckpt_dir in (re_checkpoints or {}).items():
            model = _restore_re_coordinate(model, coord, ckpt_dir, mesh=mesh,
                                           entity_axis=entity_axis, device=dev)
        try:
            lineage = (load_game_model_metadata(model_dir).get("extra") or {}).get("lineage")
        except (OSError, ValueError):
            lineage = None  # metadata already validated by the load above
        return cls(model, index_maps=index_maps, max_batch=max_batch,
                   max_row_nnz=max_row_nnz,
                   version=version or os.path.basename(os.path.normpath(model_dir)),
                   mesh=mesh, entity_axis=entity_axis, lineage=lineage,
                   device=None if mesh is not None else dev)

    # -- request assembly ----------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        return self.max_batch

    def _resolve_feature(self, shard: str, feat):
        """-> (col, value) in the training feature space, or None for a
        named feature the training index never saw."""
        if isinstance(feat, Mapping):
            name, term, value = feat.get("name"), feat.get("term", ""), feat.get("value")
            if name is None or value is None:
                raise BadRequest(f"named feature on shard '{shard}' needs 'name' and "
                                 f"'value' keys")
        elif isinstance(feat, (list, tuple)) and len(feat) == 2:
            col, value = feat
            if isinstance(col, str):
                name, term = col, ""
            else:
                return int(col), value
        elif isinstance(feat, (list, tuple)) and len(feat) == 3:
            name, term, value = feat
        else:
            raise BadRequest(f"feature on shard '{shard}' must be [col, value], "
                             f"[name, term, value], or a name/term/value object")
        imap = self._index_maps.get(shard)
        if imap is None:
            raise BadRequest(f"named feature on shard '{shard}' but the model has no feature "
                             f"index for it — send [col, value] pairs instead")
        col = imap.get(feature_key(str(name), str(term or "")), -1)
        if col < 0:
            telemetry.counter("serving.unknown_features").inc()
            return None
        return int(col), value

    def _parse(self, rows_batch: Sequence[Mapping]):
        """Validate ``rows_batch`` -> (per shard (cols, vals, per-row
        counts), offsets, per RE coordinate (bucket, position) per row)."""
        n = len(rows_batch)
        per_shard = [([], [], np.zeros(n, np.int64)) for _ in self._shard_names]
        offsets = np.zeros((n,), np.float32)
        shard_set = set(self._shard_names)
        for i, row in enumerate(rows_batch):
            if not isinstance(row, Mapping):
                raise BadRequest(f"row {i} must be an object")
            try:
                offsets[i] = row.get("offset") or 0.0
            except (TypeError, ValueError):
                raise BadRequest(f"row {i}: 'offset' must be a number") from None
            feats = row.get("features") or {}
            if not isinstance(feats, Mapping):
                raise BadRequest(f"row {i}: 'features' must be an object")
            unknown = set(feats) - shard_set
            if unknown:
                # silently dropping a typo'd shard name would score
                # fixed-effect-of-nothing
                raise BadRequest(f"row {i}: unknown feature shard(s) {sorted(unknown)}; "
                                 f"model has {sorted(self._shard_names)}")
            for s_idx, s_name in enumerate(self._shard_names):
                flist = feats.get(s_name) or ()
                if len(flist) > self.max_row_nnz:
                    raise BadRequest(f"row {i}: {len(flist)} features on shard '{s_name}' "
                                     f"exceeds max_row_nnz={self.max_row_nnz}")
                cls_, vals, counts = per_shard[s_idx]
                dim = self._shard_dims[s_idx]
                start = len(cls_)
                for feat in flist:
                    if type(feat) is list and len(feat) == 2 and type(feat[0]) is int:
                        col, value = feat  # the common [col, value] pair, inline
                    else:
                        resolved = self._resolve_feature(s_name, feat)
                        if resolved is None:
                            continue
                        col, value = resolved
                    if col < 0 or (dim is not None and col >= dim):
                        raise BadRequest(
                            f"row {i}: feature id {col} is outside shard '{s_name}' "
                            f"(features: {dim if dim is not None else 'unknown'})")
                    vals.append(value)
                    cls_.append(col)
                counts[i] = len(cls_) - start
        shards = []
        for cls_, vals, counts in per_shard:
            try:
                v = np.asarray(vals, np.float32).reshape(-1)
            except (TypeError, ValueError):
                raise BadRequest("feature values must be numbers") from None
            shards.append((np.asarray(cls_, np.int32).reshape(-1), v, counts))
        re_rows = []
        for id_name, lookup, entity_bucket, entity_pos in self._re_hosts:
            bkt = np.full((n,), -1, np.int32)
            pos = np.full((n,), -1, np.int32)
            for i, row in enumerate(rows_batch):
                value = (row.get("ids") or {}).get(id_name)
                if value is None:
                    continue
                code = lookup.get(str(value), -1)
                if code < 0:
                    # unseen entity: fixed-effect-only fallback
                    telemetry.counter("serving.unseen_entities").inc()
                    continue
                if entity_bucket[code] < 0:
                    # known, but its rows live on another fleet member
                    telemetry.counter("serving.not_owned_entities").inc()
                    continue
                bkt[i] = entity_bucket[code]
                pos[i] = entity_pos[code]
            re_rows.append((bkt, pos))
        return shards, offsets, re_rows

    def _re_part(self, st: _Staging, tables, cols, vals, ptr, bkt, pos):
        """Stage one random-effect coordinate's nonzeros per owner: the rows
        with a model and at least one nonzero, ordered by (owner, bucket,
        row), each row's nonzeros in request order."""
        per_bucket = np.array([self._rows_per_owner(t[1]) for t in tables], np.int64)
        counts = np.diff(ptr)
        live = np.flatnonzero((bkt >= 0) & (counts > 0))
        parts = [None] * len(self._owners)
        if not len(live):
            return parts
        b = bkt[live].astype(np.int64)
        owner = pos[live].astype(np.int64) // per_bucket[b]
        local = pos[live].astype(np.int64) - owner * per_bucket[b]
        order = np.lexsort((live, b, owner))
        live, b, owner, local = live[order], b[order], owner[order], local[order]
        lengths = counts[live]
        starts = np.repeat(ptr[live] - np.cumsum(lengths) + lengths, lengths)
        idx = starts + np.arange(int(lengths.sum()))
        nz_owner = np.repeat(owner, lengths)
        nz_bucket = np.repeat(b, lengths)
        nz_local = np.repeat(local, lengths)
        for o in np.unique(owner).tolist():
            rsel = owner == o
            nsel = nz_owner == o
            parts[o] = _REPart(
                counts=np.bincount(nz_bucket[nsel], minlength=len(tables)).tolist(),
                cols=st.put(cols[idx[nsel]], False),
                vals=st.put(vals[idx[nsel]], True),
                pos=st.put(nz_local[nsel].astype(np.int32), False),
                rows=st.put(live[rsel].astype(np.int32), False),
                lengths=st.put(lengths[rsel].astype(np.int32), False))
        return parts

    def _rows_per_owner(self, coef) -> int:
        if isinstance(coef, psharding.EntityShards):
            return coef.rows_per_part
        return int(coef.shape[0])

    def _staging_for(self, batch: int) -> _Staging:
        st = self._staging.get(batch)
        if st is None:
            nz = batch * self.max_row_nnz
            pieces = 3 * len(self._shard_names) + 2 + 5 * len(self._re_hosts) * len(self._owners)
            capacity = (len(self._shard_names) * (batch + 1 + 2 * nz) + 2 * batch
                        + len(self._re_hosts) * (3 * nz + 2 * batch) + _ALIGN * pieces)
            st = self._staging[batch] = _Staging(capacity, self.device)
        return st

    def _assemble(self, rows_batch: Sequence[Mapping], batch: int, tables,
                  gate: Optional[np.ndarray] = None) -> tuple[_Batch, _Staging]:
        """Validate and stage ``rows_batch`` (at most ``batch`` rows) as the
        padded inputs of one batch-size bucket (and the fixed-effect
        ``gate`` per row, when given), uploaded in one copy."""
        shards, offsets, re_rows = self._parse(rows_batch)
        n = len(rows_batch)
        st = self._staging_for(batch)
        st.used = 0
        staged, ptrs = [], []
        for cols, vals, counts in shards:
            ptr = np.zeros(batch + 1, np.int64)
            np.cumsum(counts, out=ptr[1:n + 1])
            ptr[n + 1:] = ptr[n]
            ptrs.append(ptr)
            staged.append((st.put(ptr.astype(np.int32), False), st.put(cols, False),
                           st.put(vals, True)))
        off = np.zeros(batch, np.float32)
        off[:n] = offsets
        off_piece = st.put(off, True)
        re_parts = []
        for slot, ci in enumerate(self._re_coord_indices):
            si = self._coords[ci][1]
            bkt, pos = re_rows[slot]
            cols, vals, _counts = shards[si]
            re_parts.append(self._re_part(st, tables[ci], cols, vals, ptrs[si][:n + 1], bkt,
                                          pos))
        gate_piece = None if gate is None else st.put(gate, True)
        st.upload()
        return _Batch(size=batch, shards=staged, offsets=off_piece, re_parts=re_parts,
                      gate=gate_piece), st

    # -- the device pass -----------------------------------------------------

    def _re_term(self, st: _Staging, batch: int, tables, parts) -> Tensor:
        """One random-effect coordinate's per-row margins on the first
        device: each owner looks up and sums its rows' terms, written into
        those rows (each row has one owner, so no sums cross owners)."""
        out = torch.zeros(batch, dtype=torch.float32, device=self.device)
        for o, part in enumerate(parts):
            if part is None:
                continue
            odev = self._owners[o]
            g = st.get(part.cols).to(odev)
            v = st.get(part.vals).to(odev)
            p = st.get(part.pos).to(odev).long()
            terms = torch.empty(v.shape[0], dtype=torch.float32, device=odev)
            lo = 0
            for bi, count in enumerate(part.counts):
                if not count:
                    continue
                proj, coef = tables[bi]
                if isinstance(proj, psharding.EntityShards):
                    proj, coef = proj.parts[o], coef.parts[o]
                hi = lo + count
                terms[lo:hi] = lookup_terms(proj, coef, p[lo:hi], g[lo:hi], v[lo:hi])
                lo = hi
            lengths = st.get(part.lengths).to(odev)
            sums = torch.segment_reduce(terms, "sum", lengths=lengths)
            out[st.get(part.rows).to(self.device).long()] = sums.to(self.device)
        return out

    def _margins(self, b: _Batch, st: _Staging, tables) -> Tensor:
        """The raw margin per row: each coordinate's term summed in model
        order (a fixed effect times the batch's gate when it has one)."""
        fe_gate = None if b.gate is None else st.get(b.gate)
        total = None
        re_slot = 0
        for ci, spec in enumerate(self._coords):
            row_ptr, cols, vals = (st.get(p) for p in b.shards[spec[1]])
            if spec[0] == "fixed":
                seg = kernels.csr_margins(row_ptr, cols, vals, tables[ci],
                                          st.get(b.offsets), 0.0, False)
                if fe_gate is not None:
                    seg = fe_gate * seg
            else:
                seg = self._re_term(st, b.size, tables[ci], b.re_parts[re_slot])
                re_slot += 1
            total = seg if total is None else total + seg
        return total

    def _link_of(self, scores: Tensor) -> Tensor:
        if self._link == "logistic":
            return torch.sigmoid(scores)
        if self._link == "poisson":
            return torch.exp(scores)
        return scores

    def _count_call(self, batch: int) -> None:
        stats = self._bucket_stats.get(batch)
        if stats is None:
            if self.warm:
                telemetry.counter("serving.unwarmed_bucket_calls").inc()
            stats = self._bucket_stats[batch] = {"seconds": 0.0, "calls": 0}
        stats["calls"] += 1

    def _chunks(self, rows):
        for lo in range(0, len(rows), self.max_batch):
            yield lo, rows[lo:lo + self.max_batch]

    # -- scoring -------------------------------------------------------------

    def score_rows(self, rows: Sequence[Mapping]) -> np.ndarray:
        """Mean predictions (post-link, offset included — the
        ``GameModel.predict_mean`` contract) for ``rows``; chunks internally
        when a request exceeds ``max_batch``. One host fetch per chunk."""
        if not rows:
            return np.zeros((0,), np.float32)
        parts = []
        for _lo, chunk in self._chunks(rows):
            t0 = time.monotonic()
            batch = self._bucket_for(len(chunk))
            tables = self._tables
            with self._score_lock:
                b, st = self._assemble(chunk, batch, tables)
                preds = self._link_of(self._margins(b, st, tables) + st.get(b.offsets))
                host = telemetry.sync_fetch(preds, label="serving.scores")
                self._count_call(batch)
            telemetry.histogram("serving.device_ms").observe((time.monotonic() - t0) * 1000.0)
            telemetry.counter("serving.scored_rows").inc(len(chunk))
            # the per-version score-distribution sketch (host numpy only)
            quality_drift.observe_scores(self.version, host[:len(chunk)])
            parts.append(host[:len(chunk)])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def margin_rows(self, rows: Sequence[Mapping], include_fixed=None) -> np.ndarray:
        """RAW additive margins for ``rows`` — pre-link, offset excluded —
        the fleet-member half of routed scoring. ``include_fixed`` is None
        (fixed effects for every row) or one boolean per row (the row's
        fixed-effect owner). Chunks like :meth:`score_rows`."""
        if not rows:
            return np.zeros((0,), np.float32)
        mask = None
        if include_fixed is not None:
            mask = np.asarray(include_fixed, bool)
            if mask.shape != (len(rows),):
                raise BadRequest(f"include_fixed must have one boolean per row ({len(rows)}), "
                                 f"got shape {tuple(mask.shape)}")
        parts = []
        for lo, chunk in self._chunks(rows):
            t0 = time.monotonic()
            batch = self._bucket_for(len(chunk))
            gate = np.ones((batch,), np.float32)
            if mask is not None:
                gate[:len(chunk)] = mask[lo:lo + len(chunk)]
            tables = self._tables
            with self._score_lock:
                b, st = self._assemble(chunk, batch, tables, gate=gate)
                margins = self._margins(b, st, tables)
                host = telemetry.sync_fetch(margins, label="serving.margins")
                self._count_call(batch)
            telemetry.histogram("serving.device_ms").observe((time.monotonic() - t0) * 1000.0)
            telemetry.counter("serving.margin_rows").inc(len(chunk))
            parts.append(host[:len(chunk)])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _warmup_rows(self, batch: int) -> list[dict]:
        """``batch`` full-width rows that score 0 from every feature: each
        shard at ``max_row_nnz`` features (value 0.0) and, per random-effect
        coordinate, a known entity, cycling over the owners' blocks."""
        feats = {}
        for s, dim in zip(self._shard_names, self._shard_dims):
            k = self.max_row_nnz if dim is None else min(self.max_row_nnz, dim)
            feats[s] = [[j, 0.0] for j in range(k)]
        known = []
        for id_name, lookup, entity_bucket, _pos in self._re_hosts:
            values = [v for v, code in lookup.items() if entity_bucket[code] >= 0]
            known.append((id_name, values[::max(1, len(values) // max(batch, 1))] or [None]))
        rows = []
        for i in range(batch):
            ids = {name: vals[i % len(vals)] for name, vals in known if vals[0] is not None}
            rows.append({"features": feats, "ids": ids, "offset": 0.0})
        return rows

    def warmup(self) -> "ScoringEngine":
        """Run every batch-size bucket once at full width, so steady-state
        requests find the kernels built, the handles made and the
        allocator's blocks cached."""
        with telemetry.span("serving:warmup", version=self.version,
                            buckets=len(self.bucket_sizes)):
            for b in self.bucket_sizes:
                rows = self._warmup_rows(b)
                t0 = time.perf_counter()
                tables = self._tables
                with self._score_lock:
                    batch, st = self._assemble(rows, b, tables)
                    telemetry.sync_fetch(self._link_of(
                        self._margins(batch, st, tables) + st.get(batch.offsets)),
                        label="serving.warmup")
                self._bucket_stats[b] = {"seconds": time.perf_counter() - t0, "calls": 1}
        self.warm = True
        return self

    def request_attrs(self) -> dict:
        """The ``{version, nearline_seq}`` attribution of a request."""
        return {"version": self.version, "nearline_seq": int(self.nearline_seq or 0)}

    def compile_summary(self) -> dict[str, dict]:
        """Per batch-size bucket: the warm-up call's wall seconds
        (``compile_seconds``, the kernel builds and first allocations
        included) and the calls served; the reference's XLA cost fields are
        None (no compiled executable here)."""
        return {str(b): {"compile_seconds": round(s["seconds"], 6), "flops": None,
                         "bytes_accessed": None, "temp_bytes": None, "calls": s["calls"]}
                for b, s in sorted(self._bucket_stats.items())}

    # -- nearline updates ----------------------------------------------------

    def re_slot_for(self, id_name: str) -> int:
        """The RE slot index (into :meth:`re_host` / :meth:`re_tables`)
        serving entity ids named ``id_name``."""
        for slot, host in enumerate(self._re_hosts):
            if host[0] == id_name:
                return slot
        raise KeyError(f"model has no random-effect coordinate keyed by id '{id_name}' "
                       f"(has: {[h[0] for h in self._re_hosts]})")

    def re_host(self, slot: int):
        """(id_name, value->code lookup, entity_bucket, entity_pos) of RE
        slot ``slot``."""
        return self._re_hosts[slot]

    def re_tables(self, slot: int):
        """The CURRENT ((projection, coefficients), ...) tables of RE slot
        ``slot`` (tensors, or ``EntityShards`` on a mesh) — a snapshot; a
        concurrent :meth:`apply_re_rows` replaces the tuple, never mutates
        it."""
        return self._tables[self._re_coord_indices[slot]]

    def gather_re_rows(self, slot: int, bucket: int, positions) -> Tensor:
        """The live coefficient rows at ``positions`` of one bucket, on the
        first device (from their owners on a mesh)."""
        coef = self.re_tables(slot)[bucket][1]
        pos = torch.as_tensor(np.asarray(positions, np.int64))
        if not isinstance(coef, psharding.EntityShards):
            return coef.index_select(0, pos.to(coef.device))
        per = coef.rows_per_part
        rows = torch.empty((pos.shape[0], coef.shape[1]), dtype=torch.float32,
                           device=self.device)
        owner = pos // per
        for o, part in enumerate(coef.parts):
            sel = torch.nonzero(owner == o).squeeze(1)
            if sel.numel():
                got = part.index_select(0, (pos[sel] - o * per).to(part.device))
                rows[sel.to(self.device)] = got.to(self.device)
        return rows

    def apply_re_rows(self, slot: int, bucket: int, positions, rows,
                      real_rows: Optional[int] = None) -> int:
        """Swap re-solved coefficient rows into the live serving tables.

        The new table is built out of place (a clone with the touched rows
        copied in by ``index_copy_``; on a mesh only the owners of touched
        rows get a new block) and the whole table tuple is replaced under
        the version lock: a score call sees either the complete old tables
        or the complete new ones. Only the first ``real_rows`` rows are
        written (the rest are padding duplicates of the last real lane).
        Returns the engine's new nearline sequence number."""
        n = int(len(positions) if real_rows is None else real_rows)
        pos = torch.as_tensor(np.asarray(positions, np.int64)[:n])
        new_rows = torch.as_tensor(rows)[:n].to(torch.float32)
        ci = self._re_coord_indices[slot]
        with self._version_lock:
            tables = list(self._tables)
            buckets = list(tables[ci])
            proj, coef = buckets[bucket]
            if isinstance(coef, psharding.EntityShards):
                per = coef.rows_per_part
                owner = pos // per
                parts = list(coef.parts)
                for o, part in enumerate(parts):
                    sel = torch.nonzero(owner == o).squeeze(1)
                    if sel.numel():
                        block = part.clone()
                        block.index_copy_(0, (pos[sel] - o * per).to(part.device),
                                          new_rows[sel.to(new_rows.device)].to(part.device))
                        parts[o] = block
                new = psharding.EntityShards(parts=tuple(parts), mesh=coef.mesh, axis=coef.axis)
            else:
                new = coef.clone()
                new.index_copy_(0, pos.to(coef.device), new_rows.to(coef.device))
            buckets[bucket] = (proj, new)
            tables[ci] = tuple(buckets)
            self._tables = tuple(tables)
            self.nearline_seq += 1
            seq = self.nearline_seq
        telemetry.counter("serving.nearline.applied_rows").inc(n)
        return seq

    def current_model(self) -> GameModel:
        """The :class:`GameModel` as currently served: every random-effect
        bucket's coefficients replaced by the LIVE table (nearline swaps
        included; a mesh's blocks joined on the first device)."""
        with self._version_lock:
            tables = self._tables
        model = self.model
        re_slot = 0
        for name, sub in model.models.items():
            if not isinstance(sub, RandomEffectModel):
                continue
            ci = self._re_coord_indices[re_slot]
            re_slot += 1
            new_buckets = tuple(
                dataclasses.replace(bm, coefficients=(
                    torch.cat([p.to(self.device) for p in coef.parts])
                    if isinstance(coef, psharding.EntityShards) else coef))
                for bm, (_proj, coef) in zip(sub.buckets, tables[ci]))
            model = model.with_model(name, dataclasses.replace(sub, buckets=new_buckets))
        return model
