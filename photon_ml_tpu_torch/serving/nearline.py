"""Nearline personalization: re-solve ONE entity's coefficients online.

Counterpart of ``photon_ml_tpu/serving/nearline.py``. Every per-entity
problem is an isolated lane of the random-effect solvers, so one entity's
coefficient row can be re-solved online — warm-started from the live
serving table, against a mini-batch of just-arrived events — and swapped
into the serving tables without touching any other entity and without a
model republish.

:class:`NearlineUpdater` consumes a stream of feedback events::

    {"ids": {"<id_name>": "<entity value>"},      # which entity
     "features": {"<shard>": [[col, value], ...]},  # same schema as scoring
     "label": 1.0,                                 # observed response
     "offset": 0.0,                                # optional margin offset
     "weight": 1.0}                                # optional sample weight

accumulates them into per-entity mini-batches, and on a cadence (or an
explicit :meth:`flush`):

1. resolves each entity through the CURRENT engine's host-side lookup;
   events for entities outside the training vocabulary are counted and
   dropped;
2. maps event features into each entity's local projected space via the
   bucket's sorted projection row (features the projection never saw are
   dropped and counted). An event mapping no in-projection features, or
   with weight 0, is dropped whole, and an entity left with no usable rows
   keeps its live row untouched;
3. computes each row's residual offset on the host — event offset plus the
   fixed-effect margin and every other coordinate's contribution from the
   engine's model (:class:`_HostView`);
4. solves the touched entities of a bucket as one warm-started lane solve:
   a ``DenseBatch`` of their rows (entity lanes padded to a power of two by
   duplicating the last real lane) through ``optim.factory.dispatch_solve``
   with an ``[E, K]`` w0 gathered from the LIVE table — the lane solvers of
   the random-effect coordinate;
5. commits through :meth:`ScoringEngine.apply_re_rows` (out of place, the
   table tuple swapped under the version lock);
6. on a publish cadence, persists the live tables as the next registry
   version via ``publish_version``.

Telemetry: ``serving.nearline.events`` / ``.dropped_events`` /
``.unknown_entities`` / ``.oov_features`` / ``.applies`` / ``.publishes``
counters; ``serving.nearline.solve_ms`` and ``.update_lag_ms`` (event
enqueue -> applied on the serving tables) histograms.

Fault seams: ``serving.nearline_event`` (event admission) and
``serving.nearline_apply`` (at both commit points: the table swap and the
registry publish).
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import faults, telemetry
from photon_ml_tpu_torch.game.models import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.ops.dense import DenseBatch
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.factory import (
    OptimizerConfig,
    build_objective,
    dispatch_solve,
)
from photon_ml_tpu_torch.quality import drift as quality_drift
from photon_ml_tpu_torch.serving.batcher import Overloaded
from photon_ml_tpu_torch.serving.engine import BadRequest

_FP_NEARLINE_EVENT = faults.register_point(
    "serving.nearline_event",
    description="nearline feedback-event admission (one submit call)",
)
_FP_NEARLINE_APPLY = faults.register_point(
    "serving.nearline_apply",
    description="nearline commit: in-memory table swap (hit per bucket "
    "apply) and registry publish (hit per publish)",
)


# engine-or-registry resolution, shared with the front ends — resolved
# PER FLUSH, so a hot swap redirects subsequent nearline applies to the
# new engine
from photon_ml_tpu_torch.serving.server import _engine_of  # noqa: E402


def _host(t) -> np.ndarray:
    """A model table as host numpy (a mesh's blocks joined)."""
    from photon_ml_tpu_torch.parallel.sharding import EntityShards

    if isinstance(t, EntityShards):
        return t.numpy()
    return t.detach().cpu().numpy()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _Pending:
    """One buffered event, resolved against the engine at flush time."""

    __slots__ = ("ids", "features", "label", "offset", "weight", "t_enqueue")

    def __init__(self, ids, features, label, offset, weight):
        self.ids = ids
        self.features = features
        self.label = label
        self.offset = offset
        self.weight = weight
        self.t_enqueue = time.monotonic()


class _HostView:
    """Host-side numpy view of everything the flush path reads per
    engine: the target coordinate's projections + entity placement, and
    the OTHER coordinates' state for residual-offset computation. Built
    at updater construction and rebuilt ON THE FLUSH THREAD after a hot
    swap — never on a request path. The LIVE target coefficients are
    deliberately NOT here — they are gathered on device at solve time so
    the warm start always sees the newest rows.

    Non-target RANDOM-EFFECT tables are fetched lazily, one bucket on
    first use, and only when an event actually carries that coordinate's
    id and features — a single-RE-coordinate model (the common GLMix
    shape) never pays the host gather; a multi-coordinate model pays it
    per bucket actually referenced, not the whole model. Residuals read
    that coordinate's LOAD-TIME table: a second updater targeting it
    would not be visible here (single-target semantics)."""

    def __init__(self, engine, id_name: str):
        self.engine = engine
        self.slot = engine.re_slot_for(id_name)
        _name, self.lookup, self.entity_bucket, self.entity_pos = (
            engine.re_host(self.slot)
        )
        target = None
        self.others: list[tuple] = []
        re_slot = 0
        for name, sub in engine.model.models.items():
            if isinstance(sub, FixedEffectModel):
                # FE vectors are small and replicated: eager is fine
                self.others.append(
                    ("fixed", sub.shard_name, _host(sub.coefficients))
                )
            elif isinstance(sub, RandomEffectModel):
                # the engine's RE slots follow the model's order; the target
                # is the slot ``re_slot_for`` names, and every other random
                # effect — one keyed by the same id too — is a residual term
                # (the reference takes the last coordinate of the id as the
                # target while updating the first one's table)
                if re_slot == self.slot:
                    target = sub
                else:
                    # the engine already materialized this coordinate's
                    # value->code lookup + placement at load: reuse it
                    _oname, olookup, oebkt, oepos = engine.re_host(re_slot)
                    self.others.append(
                        (
                            "re",
                            sub.shard_name,
                            sub.id_name,
                            olookup,
                            oebkt,
                            oepos,
                            sub.buckets,
                            {},  # bucket index -> fetched (proj, coef)
                        )
                    )
                re_slot += 1
        if target is None:
            raise BadRequest(
                f"engine model has no random-effect coordinate keyed by "
                f"id '{id_name}'"
            )
        self.shard_name = target.shard_name
        self.projections = [_host(bm.projection) for bm in target.buckets]
        self.local_dims = [p.shape[1] for p in self.projections]

    @staticmethod
    def _other_bucket(buckets, cache: dict, b: int):
        got = cache.get(b)
        if got is None:
            bm = buckets[b]
            got = (_host(bm.projection), _host(bm.coefficients))
            cache[b] = got
        return got

    def residual_offset(self, ev: _Pending) -> float:
        """Event offset + every non-target coordinate's margin for this
        event's features — the residual the target re-solve fits."""
        total = ev.offset
        for other in self.others:
            if other[0] == "fixed":
                _kind, shard, w = other
                for col, val in ev.features.get(shard, ()):
                    if 0 <= col < w.shape[0]:
                        total += float(w[col]) * val
            else:
                (_kind, shard, oid, lookup, ebkt, epos, buckets, cache) = other
                feats = ev.features.get(shard)
                if not feats:
                    continue
                value = ev.ids.get(oid)
                code = lookup.get(str(value), -1) if value is not None else -1
                if code < 0:
                    continue
                proj, coef = self._other_bucket(
                    buckets, cache, int(ebkt[code])
                )
                row_p, row_c = proj[int(epos[code])], coef[int(epos[code])]
                for col, val in feats:
                    k = int(np.searchsorted(row_p, col))
                    if k < row_p.shape[0] and row_p[k] == col:
                        total += float(row_c[k]) * val
        return total


class NearlineUpdater:
    """Per-entity online re-solve loop over a stream of feedback events.

    ``source`` is a :class:`ScoringEngine` or :class:`ModelRegistry`;
    the engine is re-resolved at every flush so registry hot swaps take
    effect on the next apply. ``config`` is the per-entity solver config
    (warm-started, so a handful of iterations converges); ``l2`` adds
    the usual random-effect ridge on top of whatever the config carries.

    ``publish_dir`` + ``publish_interval_s`` persist the live tables as
    new registry versions on a cadence (``index_maps`` required then —
    a published version must pin its feature space like any other).
    """

    def __init__(
        self,
        source,
        id_name: Optional[str] = None,
        config: Optional[OptimizerConfig] = None,
        rows_per_solve: int = 32,
        queue_depth: int = 4096,
        flush_interval_s: float = 1.0,
        publish_dir: Optional[str] = None,
        publish_interval_s: float = 30.0,
        index_maps: Optional[Mapping] = None,
    ):
        if rows_per_solve < 1:
            raise ValueError("rows_per_solve must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._source = source
        engine = _engine_of(source)
        self.id_name = id_name or engine.re_host(0)[0]
        self.config = config or OptimizerConfig(
            max_iterations=16, tolerance=1e-7
        )
        self.rows_per_solve = int(rows_per_solve)
        self.queue_depth = int(queue_depth)
        self.flush_interval_s = flush_interval_s
        self.publish_dir = publish_dir
        self.publish_interval_s = publish_interval_s
        self._index_maps = index_maps
        if publish_dir is not None and not index_maps:
            raise ValueError(
                "publish_dir needs index_maps: a published version must "
                "pin the training feature space next to its coefficients"
            )
        self._cv = threading.Condition()
        # entity value -> [newest rows_per_solve _Pending events]
        self._buffers: dict[str, list[_Pending]] = {}
        self._pending = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # built EAGERLY (construction happens at attach time, off the
        # request path) so submit() never builds it on an event loop;
        # rebuilt on the flush thread after a hot swap
        self._view: _HostView = _HostView(engine, self.id_name)
        self._applies_since_publish = 0
        self._last_publish = time.monotonic()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "NearlineUpdater":
        with self._cv:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="nearline-updater", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the cadence thread, flushing buffered events first."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._running:
                    break
                self._cv.wait(timeout=self.flush_interval_s)
            try:
                self.flush()
                self._maybe_publish()
            except Exception:  # noqa: BLE001 — the cadence must survive
                telemetry.counter("serving.nearline.flush_errors").inc()
        try:
            self.flush()  # drain on stop
        except Exception:  # noqa: BLE001
            telemetry.counter("serving.nearline.flush_errors").inc()

    # -- event admission -----------------------------------------------------

    def submit(self, events: Sequence[Mapping]) -> int:
        """Buffer feedback events; returns how many were ACCEPTED
        (events for entities outside the training vocabulary, or with no
        usable features, are counted and dropped — not errors). A
        structurally malformed event raises :class:`BadRequest`; a full
        buffer sheds the whole call with :class:`Overloaded`."""
        faults.fault_point(_FP_NEARLINE_EVENT)
        # the CACHED view: rebuilding here would put a host gather on the
        # submit path (the asyncio front end's event loop), so the
        # unknown-entity pre-check only runs while the view matches the
        # live engine. After a hot swap, events are accepted unchecked and
        # flush() — which rebuilds the view on its own thread — resolves
        # them authoritatively; otherwise entities that exist only in the
        # NEW model would be dropped against the stale vocabulary forever.
        view = self._view
        check_known = view.engine is _engine_of(self._source)
        parsed = []
        dropped = 0
        for i, ev in enumerate(events):
            if not isinstance(ev, Mapping):
                raise BadRequest(f"event {i} must be an object")
            ids = ev.get("ids")
            if not isinstance(ids, Mapping) or self.id_name not in ids:
                raise BadRequest(
                    f"event {i}: 'ids' must contain '{self.id_name}'"
                )
            label = ev.get("label")
            if not isinstance(label, (int, float)):
                raise BadRequest(f"event {i}: 'label' must be a number")
            feats = ev.get("features") or {}
            if not isinstance(feats, Mapping):
                raise BadRequest(f"event {i}: 'features' must be an object")
            entity = str(ids[self.id_name])
            if check_known and view.lookup.get(entity, -1) < 0:
                telemetry.counter("serving.nearline.unknown_entities").inc()
                dropped += 1
                continue
            features = {}
            for shard, flist in feats.items():
                pairs = []
                for feat in flist or ():
                    if not (
                        isinstance(feat, (list, tuple)) and len(feat) == 2
                    ):
                        raise BadRequest(
                            f"event {i}: features must be [col, value] "
                            "pairs (named features are a scoring-path "
                            "nicety; the feedback log writes ids)"
                        )
                    pairs.append((int(feat[0]), float(feat[1])))
                features[shard] = pairs
            weight = ev.get("weight")
            parsed.append(
                (
                    entity,
                    _Pending(
                        dict(ids), features, float(label),
                        float(ev.get("offset") or 0.0),
                        # an explicit 0 must STAY 0 (a tombstone carrying
                        # no sample weight), so no falsy-or default here
                        1.0 if weight is None else float(weight),
                    ),
                )
            )
        with self._cv:
            if self._pending + len(parsed) > self.queue_depth:
                telemetry.counter("serving.nearline.shed").inc()
                raise Overloaded(
                    f"nearline buffer at capacity: {self._pending} events "
                    f"pending, depth {self.queue_depth}"
                )
            for entity, pending in parsed:
                buf = self._buffers.setdefault(entity, [])
                buf.append(pending)
                if len(buf) > self.rows_per_solve:
                    # keep the NEWEST rows_per_solve events per entity
                    del buf[0]
                else:
                    self._pending += 1
        telemetry.counter("serving.nearline.events").inc(len(parsed))
        if dropped:
            telemetry.counter("serving.nearline.dropped_events").inc(dropped)
        return len(parsed)

    def _view_for(self, engine) -> _HostView:
        view = self._view
        if view is None or view.engine is not engine:
            view = _HostView(engine, self.id_name)
            with self._cv:  # submit threads and the cadence thread race here
                self._view = view
        return view

    # -- the re-solve --------------------------------------------------------

    def flush(self) -> dict:
        """Re-solve and commit every buffered entity's rows against the
        CURRENT engine. Returns ``{"entities", "rows", "applies"}``
        counting what was actually solved and applied.

        Buckets are ISOLATED: one bucket's failure (a solver error, an
        injected fault at the commit seam) requeues that bucket's events
        for the next flush and does not stop the other buckets' applies;
        the first error is re-raised once every bucket has had its turn."""
        with self._cv:
            if not self._buffers:
                return {"entities": 0, "rows": 0, "applies": 0}
            buffers, self._buffers, self._pending = self._buffers, {}, 0
        engine = _engine_of(self._source)
        view = self._view_for(engine)
        t0 = time.monotonic()
        # group touched entities by geometry bucket: each bucket's table
        # has its own [E, K] shape, so each is one lane solve
        by_bucket: dict[int, list[tuple[int, str]]] = {}
        for entity in buffers:
            code = view.lookup.get(entity, -1)
            if code < 0:  # engine swapped to a model without this entity
                telemetry.counter("serving.nearline.unknown_entities").inc()
                continue
            by_bucket.setdefault(int(view.entity_bucket[code]), []).append(
                (code, entity)
            )
        loss_name = get_loss(engine.task).name
        obj = build_objective(loss_name, self.config)
        l1 = self.config.regularization.l1_weight(self.config.regularization_weight)
        applies = 0
        rows_total = 0
        entities_total = 0
        first_error: Optional[Exception] = None
        R = self.rows_per_solve
        for bucket, members in sorted(by_bucket.items()):
            proj = view.projections[bucket]
            local_k = view.local_dims[bucket]
            # per-entity USABLE rows: an event mapping zero in-projection
            # features carries no data about this row — as a weight-1
            # zero-design row the pure ridge term would re-solve the live
            # row toward zero, so such events are dropped and an entity
            # left with no usable rows keeps its live row untouched
            lanes: list[tuple[int, list[tuple]]] = []
            dropped = 0
            for code, entity in members:
                pos = int(view.entity_pos[code])
                proj_row = proj[pos]
                rows = []
                for ev in buffers[entity][-R:]:
                    if ev.weight <= 0:
                        # a weightless row adds nothing to the data term;
                        # like an all-OOV row it would leave the ridge
                        # term free to pull the live row toward zero
                        dropped += 1
                        continue
                    xrow = np.zeros((local_k,), np.float32)
                    mapped = 0
                    for col, val in ev.features.get(view.shard_name, ()):
                        k = int(np.searchsorted(proj_row, col))
                        if k < local_k and proj_row[k] == col:
                            xrow[k] = val
                            mapped += 1
                        else:
                            telemetry.counter(
                                "serving.nearline.oov_features"
                            ).inc()
                    if not mapped:
                        dropped += 1
                        continue
                    rows.append(
                        (xrow, ev.label, view.residual_offset(ev),
                         ev.weight, ev.t_enqueue)
                    )
                if rows:
                    lanes.append((pos, rows))
            if dropped:
                telemetry.counter("serving.nearline.dropped_events").inc(
                    dropped
                )
            if not lanes:
                continue
            n = len(lanes)
            n_pad = _next_pow2(n)
            x = np.zeros((n_pad, R, local_k), np.float32)
            labels = np.zeros((n_pad, R), np.float32)
            offsets = np.zeros((n_pad, R), np.float32)
            weights = np.zeros((n_pad, R), np.float32)
            positions = np.zeros((n_pad,), np.int32)
            lags = []
            for j, (pos, rows) in enumerate(lanes):
                positions[j] = pos
                for r, (xrow, label, offset, weight, t_enq) in enumerate(
                    rows
                ):
                    x[j, r] = xrow
                    labels[j, r] = label
                    offsets[j, r] = offset
                    weights[j, r] = weight
                    lags.append(t_enq)
            # pad entity lanes by DUPLICATING the last real lane: the
            # duplicate solves to the identical row and the double
            # scatter at the same position is idempotent — no lane ever
            # commits a zero-data artifact over a real row
            for j in range(n, n_pad):
                x[j], labels[j] = x[n - 1], labels[n - 1]
                offsets[j], weights[j] = offsets[n - 1], weights[n - 1]
                positions[j] = positions[n - 1]
            try:
                batch = DenseBatch.from_arrays(x, labels, offsets, weights,
                                               device=engine.device)
                # warm start from the LIVE rows (a device gather: every
                # previous nearline apply, not the load-time model)
                w0 = engine.gather_re_rows(view.slot, bucket, positions)
                res = _nearline_solve(obj, batch, w0, self.config, l1)
                faults.fault_point(_FP_NEARLINE_APPLY)
                engine.apply_re_rows(
                    view.slot, bucket, positions, res.w, real_rows=n
                )
            except Exception as exc:  # noqa: BLE001 — isolate the bucket
                self._requeue(members, buffers)
                if first_error is None:
                    first_error = exc
                continue
            applies += 1
            entities_total += n
            rows_total += sum(len(rows) for _pos, rows in lanes)
            # labeled events feed the per-version calibration sketch:
            # predicted probability (from the rows just applied) against
            # the observed label. Flush thread, never the request path —
            # one extra fetch per bucket apply. Logistic only: the
            # calibration bins assume probabilities.
            if loss_name == "logistic":
                w_host = telemetry.sync_fetch(
                    res.w, label="nearline.calibration_rows"
                )
                margins = offsets[:n] + np.einsum(
                    "jrk,jk->jr", x[:n], w_host[:n]
                )
                live = weights[:n] > 0
                if live.any():
                    probs = 1.0 / (1.0 + np.exp(-margins[live]))
                    quality_drift.observe_labeled(
                        engine.version, probs, labels[:n][live]
                    )
            now = time.monotonic()
            lag_ms = telemetry.histogram("serving.nearline.update_lag_ms")
            for t in lags:
                lag_ms.observe((now - t) * 1000.0)
        if applies:
            telemetry.histogram("serving.nearline.solve_ms").observe(
                (time.monotonic() - t0) * 1000.0
            )
            telemetry.counter("serving.nearline.applies").inc(applies)
            with self._cv:
                self._applies_since_publish += applies
        if first_error is not None:
            raise first_error
        return {
            "entities": entities_total,
            "rows": rows_total,
            "applies": applies,
        }

    def _requeue(self, members, buffers) -> None:
        """Put a failed bucket's events back at the FRONT of the live
        buffers — they are older than anything submitted since — capped
        to the newest ``rows_per_solve`` per entity, so a transient
        bucket failure retries on the next flush instead of silently
        discarding accepted events."""
        with self._cv:
            for _code, entity in members:
                old = buffers.get(entity)
                if not old:
                    continue
                cur = self._buffers.get(entity, [])
                merged = (old + cur)[-self.rows_per_solve:]
                self._pending += len(merged) - len(cur)
                self._buffers[entity] = merged

    # -- persistence ---------------------------------------------------------

    def _maybe_publish(self) -> None:
        if self.publish_dir is None:
            return
        with self._cv:
            due = (
                self._applies_since_publish > 0
                and time.monotonic() - self._last_publish
                >= self.publish_interval_s
            )
        if due:
            self.publish()

    def publish(self) -> Optional[str]:
        """Persist the engine's LIVE tables (every nearline row swap
        included) as the next registry version. Returns the published
        path, or None when nothing was applied since the last publish."""
        from photon_ml_tpu_torch.serving.registry import publish_version

        if self.publish_dir is None:
            raise ValueError("no publish_dir configured")
        with self._cv:
            if not self._applies_since_publish:
                return None
        engine = _engine_of(self._source)
        faults.fault_point(_FP_NEARLINE_APPLY)
        path = publish_version(
            self.publish_dir,
            engine.current_model(),
            self._publishable_index_maps(),
            extra_metadata={
                "nearline_seq": engine.nearline_seq,
                "nearline_base_version": engine.version,
            },
        )
        with self._cv:
            self._applies_since_publish = 0
            self._last_publish = time.monotonic()
        telemetry.counter("serving.nearline.publishes").inc()
        return path

    def _publishable_index_maps(self):
        """publish_version accepts IndexMaps or name sequences; a plain
        {name: col} mapping (the engine-construction convenience) is
        normalized to its col-ordered name list."""
        from photon_ml_tpu_torch.data.index_map import IndexMap

        out = {}
        for shard, imap in self._index_maps.items():
            if isinstance(imap, Mapping) and not isinstance(imap, IndexMap):
                out[shard] = [
                    name for name, _c in sorted(imap.items(), key=lambda kv: kv[1])
                ]
            else:
                out[shard] = imap
        return out


def _nearline_solve(obj, batch: DenseBatch, w0: torch.Tensor, config: OptimizerConfig,
                    l1: float):
    """The warm-started lane solve of one bucket's touched entities: the
    random-effect coordinate's solve (``dispatch_solve`` over the lane
    adapter of a ``DenseBatch`` with an ``[E, K]`` w0)."""
    return dispatch_solve(glm_adapter(obj, batch), w0, config, l1, None, device=batch.x.device)
