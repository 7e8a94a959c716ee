"""Shard-owning serving members: slice a GAME model to one fleet member's
entity block and serve it from an engine of its own.

Counterpart of ``photon_ml_tpu/serving/shard.py``. Ownership is arithmetic
(``parallel.sharding.member_row_range``): member ``i`` of ``N`` owns the
contiguous entity-code block ``[i*E/N, (i+1)*E/N)`` of every random-effect
coordinate, a function of the fleet size alone, so every member and the
router derive the same map with no coordination, and a resize re-derives it.
Fixed effects are replicated (small, and every member must be able to serve
a row's fixed-effect margin alone).

The sliced model keeps the FULL vocabulary and gives every code it does not
own bucket ``-1``, so a non-owned entity adds exactly 0 on this member
(``serving.not_owned_entities``): the router's fold over the owning members
is lossless, because the score is a sum and each entity lives on exactly one
member. The slice is cut on the host; only the slice reaches the device.

:class:`ShardMemberSource` is a member's engine source: engines keyed by
``(fleet_size, version)`` behind a stage/commit barrier, so a live resize or
a fleet-wide hot swap keeps the old slice serving until the router flips,
and a request pinned to either side of the barrier resolves.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.parallel import sharding as psharding
from photon_ml_tpu_torch.serving.engine import ScoringEngine

_FP_MEMBER_LOAD = faults.register_point(
    "serving.member_load",
    distributed=True,
    description=("a fleet member loading (or re-loading after relaunch/resize) its entity "
                 "slice — io action = transient shard read"),
)


class ShardBudgetError(RuntimeError):
    """A member's entity slice does not fit its memory budget: a
    fleet-sizing error (grow the fleet), not a corrupt model."""


def serving_table_bytes(model: GameModel) -> int:
    """Device bytes of ``model`` served: each fixed effect's f32 vector plus,
    per random-effect bucket, its f32 coefficients and int32 projection (the
    engine's ``model_bytes``, known before any engine exists)."""
    total = 0
    for sub in model.models.values():
        if isinstance(sub, FixedEffectModel):
            total += 4 * int(sub.coefficients.shape[0])
        elif isinstance(sub, RandomEffectModel):
            for bm in sub.buckets:
                num_e, local_k = (int(d) for d in bm.coefficients.shape)
                total += 2 * 4 * num_e * local_k
    return total


def slice_model_for_member(model: GameModel, member: int, num_members: int) -> GameModel:
    """``model`` with every random-effect table cut to member ``member``'s
    entity-code block.

    Per coordinate: the owned codes keep their bucket rows (packed dense,
    positions renumbered); every other code gets bucket ``-1``. Buckets the
    cut leaves empty are dropped (the bucket indices renumber). The
    vocabulary stays full, so a non-owned id resolves to a known code and is
    counted, never taken for unseen. A coordinate that does not divide over
    the fleet raises with the valid fleet sizes."""
    out = model
    for name, sub in model.models.items():
        if not isinstance(sub, RandomEffectModel):
            continue
        num_entities = int(len(sub.vocab))
        try:
            lo, hi = psharding.member_row_range(num_entities, member, num_members)
        except psharding.ElasticPlacementError:
            raise psharding.fleet_size_mismatch(
                num_entities, num_members,
                what=f"slice coordinate '{name}' across the serving fleet") from None
        entity_bucket = np.asarray(sub.entity_bucket)
        entity_pos = np.asarray(sub.entity_pos)
        new_bucket = np.full(num_entities, -1, np.int32)
        new_pos = np.full(num_entities, -1, np.int32)
        owned = np.zeros(num_entities, bool)
        owned[lo:hi] = True
        new_buckets = []
        for b, bm in enumerate(sub.buckets):
            codes = np.nonzero(owned & (entity_bucket == b))[0]
            if not len(codes):
                continue  # the bucket lies wholly elsewhere
            rows = torch.from_numpy(entity_pos[codes].astype(np.int64)).to(
                bm.coefficients.device)
            new_bucket[codes] = len(new_buckets)
            new_pos[codes] = np.arange(len(codes), dtype=np.int32)
            new_buckets.append(dataclasses.replace(
                bm,
                coefficients=bm.coefficients[rows],
                projection=bm.projection[rows.to(bm.projection.device)],
                entity_codes=np.asarray(codes, np.int32),
                variances=None if bm.variances is None
                else bm.variances[rows.to(bm.variances.device)]))
        out = out.with_model(name, dataclasses.replace(
            sub, buckets=tuple(new_buckets), entity_bucket=new_bucket, entity_pos=new_pos))
    return out


def member_owned_ranges(model: GameModel, member: int,
                        num_members: int) -> dict[str, tuple[int, int]]:
    """``{id_name: (lo, hi)}``: the code block this member serves per
    random-effect coordinate."""
    out = {}
    for sub in model.models.values():
        if isinstance(sub, RandomEffectModel):
            out[sub.id_name] = psharding.member_row_range(int(len(sub.vocab)), member,
                                                          num_members)
    return out


def _restore_member_rows(sub: RandomEffectModel, sliced: RandomEffectModel, coord: str,
                         ckpt_dir: str, lo: int, hi: int) -> RandomEffectModel:
    """The sliced single-bucket coordinate with its coefficients replaced by
    rows ``[lo, hi)`` of the newest streamed checkpoint, read off its shard
    files alone (``restore_row_range``), so no member reads more than its
    slice. The bucket positions must run contiguously over the owned block
    (the streamed-training layout); anything else fails, never reads a
    wrong slice."""
    from photon_ml_tpu_torch.data.model_store import ModelLoadError
    from photon_ml_tpu_torch.game.checkpoint import StreamingCheckpointManager

    if len(sub.buckets) != 1:
        raise ModelLoadError(
            ckpt_dir,
            f"coordinate '{coord}' has {len(sub.buckets)} geometry buckets; streamed "
            "checkpoints hold ONE dense [E, K] table, so only single-bucket coordinates "
            "restore from one")
    pos = np.asarray(sub.entity_pos)[lo:hi]
    if len(pos) and not np.array_equal(pos, np.arange(pos[0], pos[0] + len(pos))):
        raise ModelLoadError(
            ckpt_dir,
            f"coordinate '{coord}' bucket positions are not contiguous over entity block "
            f"[{lo}, {hi}) — a member cannot restore it as one checkpoint row range")
    manager = StreamingCheckpointManager.open_for_restore(ckpt_dir)
    rows = manager.restore_row_range(int(pos[0]), int(pos[0]) + len(pos))
    if rows is None:
        raise ModelLoadError(
            ckpt_dir, "no certified streamed checkpoint to restore the member slice of "
            f"coordinate '{coord}' from")
    bm = sliced.buckets[0]
    want = tuple(int(d) for d in bm.coefficients.shape)
    got = tuple(int(d) for d in rows.shape)
    if got != want:
        raise ModelLoadError(
            ckpt_dir, f"checkpoint member rows shape {got} does not match coordinate "
            f"'{coord}' slice shape {want}")
    coefficients = torch.from_numpy(rows).to(bm.coefficients.device, torch.float32)
    return dataclasses.replace(sliced, buckets=(dataclasses.replace(
        bm, coefficients=coefficients),))


def load_member_engine(
    model_dir: str,
    member: int,
    fleet_size: int,
    max_batch: int = 64,
    max_row_nnz: int = 128,
    version: Optional[str] = None,
    hbm_budget_bytes: Optional[int] = None,
    re_checkpoints: Optional[Mapping[str, str]] = None,
    warm: bool = True,
    device: torch.device | str | None = None,
) -> ScoringEngine:
    """The :class:`ScoringEngine` serving member ``member``'s slice of the
    model in ``model_dir`` on ``device`` (default cuda), warmed by default.

    The model is read and cut on the host; only the slice is uploaded.
    ``hbm_budget_bytes`` is the point of the fleet: the SLICE must fit it
    (:class:`ShardBudgetError` otherwise), even where the full model would
    not. ``re_checkpoints`` (coordinate -> streamed checkpoint dir) restores
    that coordinate's slice off the checkpoint's shard files, reading only
    the owned rows."""
    from photon_ml_tpu_torch.data.model_store import (
        ModelLoadError,
        load_feature_index_maps,
        load_game_model,
        load_game_model_metadata,
    )
    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    faults.fault_point(_FP_MEMBER_LOAD)
    with telemetry.span("serving:member_load", member=member, fleet_size=fleet_size):
        index_maps = load_feature_index_maps(model_dir)
        if index_maps is None:
            raise ModelLoadError(
                os.path.join(model_dir, "feature-indexes"),
                "missing feature-indexes/ — a fleet member cannot pin the serving feature "
                "space, so scores would be silently wrong")
        model = load_game_model(model_dir, device="cpu")
        sliced = slice_model_for_member(model, member, fleet_size)
        for coord, ckpt_dir in (re_checkpoints or {}).items():
            sub, cut = model.models.get(coord), sliced.models.get(coord)
            if not isinstance(sub, RandomEffectModel):
                raise ModelLoadError(
                    ckpt_dir,
                    f"re_checkpoints names coordinate '{coord}', which is not a random-effect "
                    f"coordinate of the model (has: {sorted(model.models)})")
            lo, hi = psharding.member_row_range(int(len(sub.vocab)), member, fleet_size)
            sliced = sliced.with_model(coord, _restore_member_rows(sub, cut, coord, ckpt_dir,
                                                                   lo, hi))
        slice_bytes = serving_table_bytes(sliced)
        if hbm_budget_bytes is not None and slice_bytes > hbm_budget_bytes:
            raise ShardBudgetError(
                f"member {member}/{fleet_size} slice needs {slice_bytes} bytes, over the "
                f"{int(hbm_budget_bytes)}-byte HBM budget (full model: "
                f"{serving_table_bytes(model)} bytes; fleet sizes whose slices fit: "
                f"{_sizes_that_fit(model, int(hbm_budget_bytes))}) — grow the fleet")
        del model
        try:
            lineage = (load_game_model_metadata(model_dir).get("extra") or {}).get("lineage")
        except (OSError, ValueError):
            lineage = None
        engine = ScoringEngine(sliced, index_maps=index_maps, max_batch=max_batch,
                               max_row_nnz=max_row_nnz,
                               version=version or os.path.basename(os.path.normpath(model_dir)),
                               lineage=lineage, device=dev)
        telemetry.gauge("serving.member_slice_bytes").set(slice_bytes)
        if warm:
            engine.warmup()
        return engine


def _sizes_that_fit(model: GameModel, budget: int) -> list[int]:
    """Fleet sizes that divide every random-effect coordinate of ``model``
    and give no member a slice over ``budget`` bytes."""
    fixed, per_entity, sizes = 0, [], None
    for sub in model.models.values():
        if isinstance(sub, FixedEffectModel):
            fixed += 4 * int(sub.coefficients.shape[0])
        elif isinstance(sub, RandomEffectModel):
            width = np.array([2 * 4 * int(bm.coefficients.shape[1]) for bm in sub.buckets] + [0],
                             np.int64)
            # bucket -1 picks the trailing 0: an entity without a model
            per_entity.append(width[np.asarray(sub.entity_bucket)])
            valid = set(psharding.valid_fleet_sizes(int(len(sub.vocab))))
            sizes = valid if sizes is None else sizes & valid
    return [n for n in sorted(sizes or ())
            if fixed + max(sum(b.reshape(n, -1).sum(axis=1)[m] for b in per_entity)
                           for m in range(n)) <= budget]


class ShardMemberSource:
    """One fleet member's engine source: ``(fleet_size, version)``-keyed
    engines behind a stage/commit barrier.

    ``stage`` loads and warms a new slice while the current one serves (a
    resize: the same version cut at the new size; a hot swap: a new version
    at the current size). ``commit`` flips the current pointer and keeps one
    previous engine, the mixed window the router pins requests through; it
    drops anything older, so its tables are freed. ``resolve`` serves a
    request pinned to either side; an unknown pin raises ``KeyError`` (the
    front ends answer 409 and the router sheds that member for the request).

    ``loader(fleet_size, version)`` returns a warmed engine (``version=None``
    means the newest)."""

    def __init__(self, loader: Callable[[int, Optional[str]], ScoringEngine], member: int,
                 fleet_size: int):
        self._loader = loader
        self.member = int(member)
        self.initial_fleet_size = int(fleet_size)
        self._lock = threading.RLock()
        self._engines: dict[tuple[int, str], ScoringEngine] = {}
        self._current: Optional[tuple[int, str]] = None
        self._previous: Optional[tuple[int, str]] = None

    @property
    def engine(self) -> ScoringEngine:
        with self._lock:
            if self._current is None:
                raise RuntimeError(f"member {self.member}: no committed shard engine")
            return self._engines[self._current]

    @property
    def fleet_size(self) -> int:
        with self._lock:
            return self.initial_fleet_size if self._current is None else self._current[0]

    def staged_keys(self) -> list[tuple[int, str]]:
        with self._lock:
            return sorted(self._engines)

    def stage(self, fleet_size: int, version: Optional[str] = None) -> tuple[int, str]:
        """Load and warm the ``(fleet_size, version)`` slice without touching
        what serves; idempotent per key."""
        fleet_size = int(fleet_size)
        with self._lock:
            if version is not None:
                key = (fleet_size, str(version))
                if key in self._engines:
                    return key
        engine = self._loader(fleet_size, version)
        key = (fleet_size, engine.version)
        with self._lock:
            self._engines.setdefault(key, engine)
        return key

    def commit(self, fleet_size: int, version: str) -> tuple[int, str]:
        """Flip the current pointer to a staged key; the previous current
        stays resolvable, everything older is dropped."""
        key = (int(fleet_size), str(version))
        with self._lock:
            if key not in self._engines:
                raise KeyError(f"member {self.member}: commit of unstaged {key}; staged: "
                               f"{sorted(self._engines)}")
            if key != self._current:
                self._previous, self._current = self._current, key
            keep = {k for k in (self._current, self._previous) if k}
            dropped = [self._engines.pop(k) for k in list(self._engines) if k not in keep]
        if any(e.device.type == "cuda" for e in dropped):
            # the dropped slice's tables go back to the card, not only to the
            # caching allocator: a member's memory holds two slices at most
            del dropped
            torch.cuda.empty_cache()
        return key

    def resolve(self, fleet_size: Optional[int] = None,
                version: Optional[str] = None) -> ScoringEngine:
        """The engine a request pinned to ``(fleet_size, version)`` scores on;
        ``None`` pins default to the current engine's."""
        with self._lock:
            if self._current is None:
                raise RuntimeError(f"member {self.member}: no committed shard engine")
            if fleet_size is None:
                fleet_size = self._current[0]
            fleet_size = int(fleet_size)
            if version is not None:
                engine = self._engines.get((fleet_size, str(version)))
                if engine is None:
                    raise KeyError(f"member {self.member} holds no engine for "
                                   f"fleet_size={fleet_size} version={version!r}; staged: "
                                   f"{sorted(self._engines)}")
                return engine
            for key in (self._current, self._previous):
                if key is not None and key[0] == fleet_size:
                    return self._engines[key]
            for key in sorted(self._engines):
                if key[0] == fleet_size:
                    return self._engines[key]
            raise KeyError(f"member {self.member} holds no engine for fleet_size={fleet_size}; "
                           f"staged: {sorted(self._engines)}")
