"""Selective re-solve: coordinate descent in which only the touched
random-effect lanes solve again.

Counterpart of ``photon_ml_tpu/incremental/refit.py``. Per random-effect
bucket, the touched entities' problems are gathered once, when the masked
coordinate is built (``DenseBucket.take``: an ``index_select`` on the
device; ``CooBucket.take``: a block-diagonal batch of their host arrays,
built on the device with its tile index), since the touched set does not
change between coordinate-descent iterations and only the residual offsets
do. Each update solves exactly those lanes with the inner coordinate's
``dispatch_solve``, its box and its variances, and writes them back into a
copy of the table with ``index_copy_``: the untouched rows are never
computed on and stay bit for bit the warm start's. A bucket with no touched
entity is skipped, with no launch at all. The reference pads the gathered
lanes to a power of two for its compile cache; the port solves exactly the
touched lanes. On a mesh, each owner of the model axis solves its touched
lanes of its own block on its device (owners with none are skipped), so no
padding is needed there either. The fixed effect refreshes over the whole
combined data (the margins and scatter kernels).

Telemetry: ``incremental.lanes_solved`` / ``incremental.lanes_skipped``
(entities solved again or kept, counted per update pass) and
``incremental.bucket_solves`` / ``incremental.buckets_skipped``, also kept
on each masked coordinate.

Transplanting (:func:`transplant_random_effect`): the combined run's
buckets are built anew, so the base's rows are re-homed by entity value
(vocabulary growth shifts codes) and within a row by global feature id, an
exact searchsorted take in float32: an untouched entity's row, whose
geometry cannot have changed, lands bit for bit. Entities the base never
trained start at zero, as a fresh fit starts them, and always solve.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.device import resolve_device, same_device
from photon_ml_tpu_torch.game.models import GameModel, map_vocab_codes
from photon_ml_tpu_torch.optim.common import BoxConstraints
from photon_ml_tpu_torch.optim.guard import damped_objective, solve_health

logger = logging.getLogger("photon_ml_tpu_torch.incremental")

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# warm-start transplanting
# ---------------------------------------------------------------------------


def transplant_fixed_effect(base, coord):
    """The base fixed effect, checked against the combined run's feature
    space: an incremental fit needs the feature space pinned (a delta that
    grows or reorders features would map every coefficient wrongly), so a
    dimension mismatch is a typed refusal."""
    from photon_ml_tpu_torch.incremental.warmstart import WarmStartError

    fresh = coord.initialize_model()
    if tuple(base.coefficients.shape) != tuple(fresh.coefficients.shape):
        raise WarmStartError(
            f"fixed-effect '{coord.name}': warm-start coefficients have "
            f"{base.coefficients.shape[0]} features but the combined data has "
            f"{fresh.coefficients.shape[0]} — the feature space must stay pinned across "
            "incremental retrains (new entities are supported; new features are not)")
    return dataclasses.replace(fresh, coefficients=base.coefficients.to(
        device=fresh.coefficients.device, dtype=fresh.coefficients.dtype, copy=True))


def transplant_random_effect(base, coord) -> tuple[object, np.ndarray]:
    """The base ``RandomEffectModel``'s rows re-homed into the combined
    run's buckets: ``(model, untransplanted_codes)``, the second the
    combined-vocabulary codes whose rows start at zero because the base
    trained none (an unseen value, or one without a model there); those
    lanes solve whatever the delta says. A row is matched by entity value,
    then each coefficient by global feature id: a float32 take."""
    red = coord.re_data
    fresh = coord.initialize_model()
    base_vocab = np.asarray(base.vocab)
    base_bucket = np.asarray(base.entity_bucket)
    base_pos = np.asarray(base.entity_pos)
    base_projs = [b.projection.cpu().numpy() for b in base.buckets]
    base_coeffs = [b.coefficients.detach().cpu().numpy().astype(np.float32, copy=False)
                   for b in base.buckets]
    new_vocab = np.asarray(fresh.vocab)
    sentinel = red.num_global_features
    stride = np.int64(sentinel) + 1
    untransplanted: list[np.ndarray] = []
    out_buckets = []
    for bm, eb in zip(fresh.buckets, red.buckets):
        codes_new = np.asarray(bm.entity_codes)
        bcodes = map_vocab_codes(base_vocab, new_vocab[codes_new])  # -1: never seen
        known = bcodes >= 0
        src_bucket = np.where(known, base_bucket[np.maximum(bcodes, 0)], -1)
        untransplanted.append(codes_new[~known | (src_bucket < 0)])
        tgt_proj = eb.projection.astype(np.int64)  # the host copy of bm.projection
        W = np.zeros(tuple(bm.coefficients.shape), np.float32)
        for src in range(len(base_projs)):
            sel = np.nonzero(src_bucket == src)[0]
            if not len(sel):
                continue
            pp = base_pos[bcodes[sel]]
            old_proj = base_projs[src][pp].astype(np.int64)  # [S, K_old]
            old_w = base_coeffs[src][pp]
            rows = np.arange(len(sel), dtype=np.int64)[:, None] * stride
            # (row, global id) in one sorted key space, then searchsorted: a
            # take of the old value, never arithmetic on it
            base_keys = (rows + old_proj).ravel()
            tgt_keys = (rows + tgt_proj[sel]).ravel()
            pos = np.minimum(np.searchsorted(base_keys, tgt_keys), base_keys.size - 1)
            hit = (base_keys[pos] == tgt_keys) & (tgt_proj[sel].ravel() != sentinel)
            W[sel] = np.where(hit, old_w.ravel()[pos], np.float32(0)).reshape(len(sel), -1)
        out_buckets.append(dataclasses.replace(
            bm, coefficients=torch.from_numpy(W).to(bm.coefficients.device)))
    missing = (np.concatenate(untransplanted) if untransplanted
               else np.zeros(0, np.int64)).astype(np.int64)
    return dataclasses.replace(fresh, buckets=tuple(out_buckets)), missing


def transplant_factored_random_effect(base, coord) -> tuple[object, np.ndarray]:
    """The base ``FactoredRandomEffectModel``'s latent rows moved by entity
    value into the combined run's latent table (a row move, bit for bit for
    every entity the base trained), and its projection A carried as it is
    (the latent rows mean something only against the A they trained under).
    Returns ``(model, untransplanted_codes)`` as
    :func:`transplant_random_effect` does."""
    from photon_ml_tpu_torch.incremental.warmstart import WarmStartError

    fresh = coord.initialize_model()
    if int(base.latent.shape[1]) != int(fresh.latent.shape[1]):
        raise WarmStartError(
            f"factored coordinate '{coord.name}': warm-start latent dimension "
            f"{int(base.latent.shape[1])} != configured {int(fresh.latent.shape[1])} — the "
            "latent space must stay pinned across incremental retrains")
    if tuple(base.projection.matrix.shape) != tuple(fresh.projection.matrix.shape):
        raise WarmStartError(
            f"factored coordinate '{coord.name}': warm-start projection is "
            f"{tuple(base.projection.matrix.shape)} but the combined data needs "
            f"{tuple(fresh.projection.matrix.shape)} — the feature space must stay pinned "
            "across incremental retrains")
    bcodes = map_vocab_codes(np.asarray(base.vocab), np.asarray(fresh.vocab))
    base_flat = np.asarray(base.entity_flat)
    new_flat = np.asarray(fresh.entity_flat)
    active = np.nonzero(new_flat >= 0)[0]
    src = np.where(bcodes[active] >= 0, base_flat[np.maximum(bcodes[active], 0)], -1)
    known = src >= 0
    dev = fresh.latent.device
    latent = torch.zeros_like(fresh.latent)
    latent.index_copy_(0, torch.from_numpy(new_flat[active[known]]).to(dev),
                       base.latent.to(dev).index_select(
                           0, torch.from_numpy(src[known]).to(dev)))
    return (dataclasses.replace(fresh, latent=latent, projection=base.projection),
            active[~known].astype(np.int64))


# ---------------------------------------------------------------------------
# the masked coordinates
# ---------------------------------------------------------------------------


def _touched_positions(red, touched_mask: np.ndarray, name: str) -> list[np.ndarray]:
    """Per bucket of ``red``, the sorted positions of the touched entities."""
    mask = np.asarray(touched_mask, bool)
    if len(mask) != red.num_entities:
        raise ValueError(f"touched mask covers {len(mask)} entities but coordinate "
                         f"'{name}' has {red.num_entities}")
    codes = np.nonzero(mask)[0]
    return [np.sort(red.entity_pos[codes[red.entity_bucket[codes] == i]]).astype(np.int64)
            for i in range(len(red.buckets))]


def _take_box(box: Optional[BoxConstraints], idx: Tensor) -> Optional[BoxConstraints]:
    if box is None:
        return None
    return BoxConstraints(lower=box.lower.index_select(0, idx),
                          upper=box.upper.index_select(0, idx))


class _LaneCounts:
    """The structural counters of a masked coordinate, per instance and in
    telemetry."""

    def _init_counts(self) -> None:
        self.lanes_solved = 0
        self.lanes_skipped = 0
        self.bucket_solves = 0
        self.buckets_skipped = 0

    def _count_skip(self, n_real: int) -> None:
        self.buckets_skipped += 1
        self.lanes_skipped += n_real
        telemetry.counter("incremental.buckets_skipped").inc()
        telemetry.counter("incremental.lanes_skipped").inc(n_real)

    def _count_solve(self, t: int, n_real: int) -> None:
        self.bucket_solves += 1
        self.lanes_solved += t
        self.lanes_skipped += n_real - t
        telemetry.counter("incremental.bucket_solves").inc()
        telemetry.counter("incremental.lanes_solved").inc(t)
        telemetry.counter("incremental.lanes_skipped").inc(n_real - t)


class MaskedRandomEffectCoordinate(_LaneCounts):
    """A ``RandomEffectCoordinate`` whose ``update_model`` solves only the
    touched entities' lanes. It keeps the coordinate protocol, so
    ``run_coordinate_descent`` drives it unchanged, the guard included
    (``extra_l2`` and ``health_check`` act as on the inner coordinate);
    scoring is the inner coordinate's, over the whole table."""

    def __init__(self, inner, touched_mask: np.ndarray):
        self.inner = inner
        self.name = inner.name
        self.data = inner.data
        self._positions = _touched_positions(inner.re_data, touched_mask, inner.name)
        dev = inner.data.device
        self._idx = [torch.from_numpy(ti).to(dev) for ti in self._positions]
        # the gathered buckets and boxes, built once: without a mesh one per
        # bucket, on a mesh one per (bucket, owner) holding touched lanes
        self._gathered: list = []
        for i, ti in enumerate(self._positions):
            if not len(ti):
                self._gathered.append(None)
            elif not inner._owners:
                self._gathered.append((inner._buckets[i].take(ti),
                                       _take_box(inner._constraints[i], self._idx[i])))
            else:
                owned = []
                for (d, buckets, cons), (lo, hi, _pad) in zip(inner._owners, inner._splits[i]):
                    local = ti[(ti >= lo) & (ti < hi)] - lo
                    if not len(local):
                        continue
                    idx_d = torch.from_numpy(local).to(d)
                    owned.append((d, buckets[i].take(local), _take_box(cons[i], idx_d),
                                  torch.from_numpy(local + lo).to(dev)))
                self._gathered.append(owned)
        self.extra_l2 = 0.0
        self.health_check = False
        self.last_health: Optional[Tensor] = None
        self.last_tracker = None
        self.last_results: list = []
        self._init_counts()
        # the last pass's solve inputs, for bootstrap_touched
        self._last_inputs: list[dict] = []

    def initialize_model(self):
        return self.inner.initialize_model()

    def score(self, model):
        return self.inner.score(model)

    def update_model(self, model, residual_scores: Optional[Tensor]):
        from photon_ml_tpu_torch.game.coordinates import _join_lanes
        from photon_ml_tpu_torch.optim.trackers import RandomEffectOptimizationTracker

        inner = self.inner
        dev = inner.data.device
        obj = damped_objective(inner._obj, self.extra_l2)
        residual_on = {str(d): residual_scores.to(d) for d, _, _ in inner._owners
                       if residual_scores is not None}
        new_buckets, results, healths = [], [], []
        self._last_inputs = []
        # the masked refresh writes rows by copy into the joined table
        model = model.gathered()
        for i, bm in enumerate(model.buckets):
            ti, n_real = self._positions[i], int(bm.coefficients.shape[0])
            if not len(ti):
                # no touched entity: no solve at all, the rows stand as they are
                self._count_skip(n_real)
                new_buckets.append(bm)
                continue
            idx = self._idx[i]
            if not inner._owners:
                gathered, box = self._gathered[i]
                w0 = bm.coefficients.index_select(0, idx)
                res, var = inner._solve(obj, gathered, w0, box, residual_scores, dev)
                if self.health_check:
                    healths.append(solve_health(res, res.w))
                self._last_inputs.append({"bucket": i, "gathered": gathered, "touched": ti,
                                          "residual": residual_scores, "w0": res.w})
            else:
                parts = []
                for d, gathered, box, owned_idx in self._gathered[i]:
                    w0 = bm.coefficients.index_select(0, owned_idx).to(d)
                    r, v = inner._solve(obj, gathered, w0, box, residual_on.get(str(d)), d)
                    parts.append((r, v, int(owned_idx.shape[0])))
                    if self.health_check:
                        healths.append(solve_health(r, r.w).to(dev))
                res = _join_lanes([(r, n) for r, _, n in parts], dev)
                var = (None if parts[0][1] is None
                       else torch.cat([v.to(dev) for _, v, _ in parts]))
            # only the touched rows are written, into a copy: the untouched
            # rows are never computed on
            coeffs = bm.coefficients.clone().index_copy_(0, idx, res.w.to(bm.coefficients.dtype))
            variances = bm.variances
            if var is not None:
                base_var = (bm.variances if bm.variances is not None
                            else torch.zeros_like(bm.coefficients))
                variances = base_var.clone().index_copy_(0, idx, var.to(base_var.dtype))
            results.append(res)
            self._count_solve(len(ti), n_real)
            new_buckets.append(dataclasses.replace(bm, coefficients=coeffs,
                                                   variances=variances))
        self.last_results = results
        self.last_tracker = (RandomEffectOptimizationTracker.from_results(results)
                             if results else None)
        if self.health_check:
            self.last_health = (torch.stack(healths).all() if healths
                                else torch.tensor(True, device=dev))
        else:
            self.last_health = None
        return dataclasses.replace(model, buckets=tuple(new_buckets))

    def bootstrap_touched(self, num_samples: int = 32, seed: int = 0) -> dict:
        """The bootstrap of exactly the rows the last ``update_model`` pass
        solved: per solved bucket, B resamples of its touched lanes solve as
        B x T lanes of its gathered problems. The [B, E, R] resample weights
        are drawn for the whole bucket from the seed and gathered down to
        the touched lanes, so each touched lane sees the draws a bootstrap
        of the whole bucket gives it. Returns ``{bucket index: {"report":
        ReBootstrapReport, "touched": positions}}``; a mesh fit keeps no
        inputs for it (empty)."""
        from photon_ml_tpu_torch.diagnostics.bootstrap import (
            bootstrap_random_effect,
            bootstrap_re_weights,
        )

        inner = self.inner
        out: dict[int, dict] = {}
        for stash in self._last_inputs:
            i = stash["bucket"]
            full = inner._buckets[i]
            full_w = telemetry.sync_fetch(getattr(full, "block", full).weights,
                                          label="bootstrap_touched_weights")
            counts = bootstrap_re_weights(num_samples, full_w, seed)
            report = bootstrap_random_effect(
                stash["gathered"].batch(stash["residual"]), inner.loss_name, inner.config,
                stash["w0"], num_samples=num_samples, seed=seed,
                lane_weights=counts[:, stash["touched"], :], device=inner.data.device)
            out[i] = {"report": report, "touched": stash["touched"]}
        return out


class MaskedFactoredRandomEffectCoordinate(_LaneCounts):
    """A ``FactoredRandomEffectCoordinate`` whose ``update_model`` solves only
    the touched entities' latent vectors. The shared projection A stays
    frozen even when ``refit_projection`` is set: refitting it would change
    every entity's effective coefficients A^T c_e. The touched entities
    solve in the fixed projected space (the ``refit_projection=False``
    step), their latent design built over their gathered rows only."""

    def __init__(self, inner, touched_mask: np.ndarray):
        self.inner = inner
        self.name = inner.name
        self.data = inner.data
        if inner.refit_projection:
            logger.warning(
                "masked incremental solve freezes coordinate '%s's shared projection "
                "matrix (refit_projection is configured on); escalate to a full retrain "
                "to refresh it", inner.name)
        self._positions = _touched_positions(inner.re_data, touched_mask, inner.name)
        dev = inner.data.device
        self._gathered = []
        for i, ti in enumerate(self._positions):
            if not len(ti):
                self._gathered.append(None)
                continue
            idx = torch.from_numpy(ti).to(dev)
            flat = torch.from_numpy(inner._flat_offsets[i] + ti).to(dev)
            self._gathered.append((inner._buckets[i].take(ti),
                                   inner._proj[i].index_select(0, idx), flat))
        self.extra_l2 = 0.0
        self.health_check = False
        self.last_health: Optional[Tensor] = None
        self.last_tracker = None
        self.last_results: list = []
        self._init_counts()

    def initialize_model(self):
        return self.inner.initialize_model()

    def score(self, model):
        return self.inner.score(model)

    def update_model(self, model, residual_scores: Optional[Tensor]):
        from photon_ml_tpu_torch.game.factored import latent_batch, latent_design
        from photon_ml_tpu_torch.optim.adapter import glm_adapter
        from photon_ml_tpu_torch.optim.factory import dispatch_solve
        from photon_ml_tpu_torch.optim.trackers import (
            FactoredRandomEffectOptimizationTracker,
            RandomEffectOptimizationTracker,
        )

        inner = self.inner
        dev = inner.data.device
        obj = damped_objective(inner._re_obj, self.extra_l2)
        a_ext = model.projection.extended()
        latent = model.latent
        results, healths = [], []
        for i, ti in enumerate(self._positions):
            n_real = inner.re_data.buckets[i].num_entities
            if not len(ti):
                self._count_skip(n_real)
                continue
            gathered, proj, flat = self._gathered[i]
            batch = latent_batch(gathered, latent_design(gathered, proj, a_ext), residual_scores)
            res = dispatch_solve(glm_adapter(obj, batch), latent.index_select(0, flat),
                                 inner.re_config, inner._re_l1, device=dev)
            if latent is model.latent:
                latent = latent.clone()
            latent.index_copy_(0, flat, res.w.to(latent.dtype))
            if self.health_check:
                healths.append(solve_health(res, res.w))
            results.append(res)
            self._count_solve(len(ti), n_real)
        self.last_results = results
        self.last_tracker = (FactoredRandomEffectOptimizationTracker(steps=(
            (RandomEffectOptimizationTracker.from_results(results), None),))
            if results else None)
        if self.health_check:
            self.last_health = (torch.stack(healths).all() if healths
                                else torch.tensor(True, device=dev))
        else:
            self.last_health = None
        return dataclasses.replace(model, latent=latent)


# ---------------------------------------------------------------------------
# the incremental fit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IncrementalFitResult:
    """A finished incremental refresh: the fresh model and the evidence of
    what solved again, what stood, and where it came from."""

    model: GameModel
    best_model: GameModel
    best_metric: Optional[float]
    history: list
    lineage: object  # BaseLineage
    delta: Optional[object]  # DeltaScan
    lanes_solved: int
    lanes_skipped: int
    bucket_solves: int
    buckets_skipped: int
    new_entities: int
    seconds: float
    selection: Optional[object] = None  # SweepSelection when λ-swept
    published_version: Optional[str] = None
    # the masked-lane bootstrap's JSON summaries per coordinate (with
    # bootstrap_samples > 0): the error bars the publish gate records
    bootstrap: Optional[dict] = None


def local_lambda_factors(points: int = 3, span: float = 4.0) -> list[float]:
    """A small descending multiplier grid around the incumbent λ (index 0
    the most regularized): ``points=3, span=4`` gives ``[4.0, 1.0, 0.25]``;
    the incumbent itself is always one of them."""
    if points < 1:
        raise ValueError("lambda points must be >= 1")
    if span <= 1.0:
        raise ValueError("lambda span must be > 1")
    if points == 1:
        return [1.0]
    factors = np.logspace(np.log10(span), -np.log10(span), points).tolist()
    # the incumbent exactly, not a float-noise neighbour
    mid = min(range(points), key=lambda i: abs(np.log(factors[i])))
    factors[mid] = 1.0
    return factors


def _scaled_overrides(config, factor: float) -> dict:
    """Per-coordinate optimizer configs with every regularization weight
    scaled by ``factor`` (the local λ sweep)."""
    from photon_ml_tpu_torch.game.estimator import (
        FactoredRandomEffectConfig,
        FixedEffectConfig,
        RandomEffectConfig,
    )

    overrides = {}
    for name, c in config.coordinates.items():
        if isinstance(c, (FixedEffectConfig, RandomEffectConfig)):
            opt = c.optimizer
        elif isinstance(c, FactoredRandomEffectConfig):
            opt = c.re_optimizer
        else:
            continue
        overrides[name] = dataclasses.replace(
            opt, regularization_weight=opt.regularization_weight * factor)
    return overrides


def _wrap_masked(coords: dict, delta, data, untransplanted: dict) -> dict:
    """Every random-effect coordinate whose id column the delta names,
    masked. The mask is the delta's touched set and the coordinate's
    untransplanted entities: an entity that came in through the combined
    window and not through the delta still has only a zero row, and
    skipping it would publish an all-zero random effect."""
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate

    if delta is None:
        return dict(coords)
    out = {}
    for name, coord in coords.items():
        masked_cls = {RandomEffectCoordinate: MaskedRandomEffectCoordinate,
                      FactoredRandomEffectCoordinate: MaskedFactoredRandomEffectCoordinate
                      }.get(type(coord))
        cd = None if masked_cls is None else delta.for_id(coord.re_data.id_name)
        if cd is None:
            out[name] = coord
            continue
        mask = cd.touched_mask(data.id_columns[coord.re_data.id_name].vocab)
        missing = untransplanted.get(name)
        if missing is not None and len(missing):
            mask[missing] = True
        out[name] = masked_cls(coord, mask)
    return out


def _transplant_models(coords: dict, base_model: GameModel) -> tuple[dict, int, dict]:
    """``(initial_models, new_entities, untransplanted)`` of the combined
    run's coordinates, re-homed from the base model; ``untransplanted``
    maps a coordinate to its combined-vocabulary codes without a base row.
    A coordinate the base lacks, or of a type without a transplant, starts
    fresh with a warning."""
    from photon_ml_tpu_torch.game.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
        FactoredRandomEffectModel,
    )
    from photon_ml_tpu_torch.incremental.warmstart import WarmStartError

    initial, untransplanted = {}, {}
    new_entities = 0
    for name, coord in coords.items():
        base = base_model.models.get(name)
        if base is None:
            logger.warning("warm start lacks coordinate '%s'; it initializes fresh", name)
            continue
        if isinstance(coord, FixedEffectCoordinate):
            initial[name] = transplant_fixed_effect(base, coord)
            continue
        if isinstance(coord, RandomEffectCoordinate):
            model, missing = transplant_random_effect(base, coord)
        elif isinstance(coord, FactoredRandomEffectCoordinate):
            if not isinstance(base, FactoredRandomEffectModel):
                raise WarmStartError(
                    f"coordinate '{name}' is factored in this config but the warm start "
                    f"holds a {type(base).__name__} — the coordinate structure must stay "
                    "pinned across incremental retrains")
            model, missing = transplant_factored_random_effect(base, coord)
        else:
            logger.warning("coordinate '%s' (%s) does not support warm-start transplanting; "
                           "it initializes fresh", name, type(coord).__name__)
            continue
        initial[name] = model
        new_entities += int(len(missing))
        untransplanted[name] = missing
    return initial, new_entities, untransplanted


def _primary_metric_value(model, validation_data, metric: str) -> float:
    """One validation metric of a whole model (the λ sweep's scorer, as
    ``sweep.select.evaluate_sweep`` scores), with one host fetch."""
    from photon_ml_tpu_torch.evaluation.evaluators import EVALUATORS
    from photon_ml_tpu_torch.game.coordinate_descent import validation_arrays

    labels, weights, offsets = validation_arrays(validation_data)
    value = EVALUATORS[metric](model.score(validation_data) + offsets, labels, weights)
    return float(telemetry.sync_fetch(torch.as_tensor(value), label=f"incremental_eval:{metric}"))


def run_incremental_fit(
    estimator,
    data,
    warm_start,
    delta=None,
    validation_data=None,
    mesh=None,
    num_iterations: Optional[int] = None,
    lambda_factors: Optional[Sequence[float]] = None,
    metric: Optional[str] = None,
    policy: str = "best",
    rel_tol: float = 0.01,
    guard=None,
    checkpoint_spec=None,
    should_stop=None,
    bootstrap_samples: int = 0,
    bootstrap_seed: int = 0,
    device: torch.device | str | None = None,
) -> IncrementalFitResult:
    """The delta-aware warm-start refresh of ``estimator``'s model over the
    combined data (base and delta) on ``device`` (default cuda; with
    ``mesh``, its first device). ``GameEstimator.fit_incremental`` is the
    public entry."""
    from photon_ml_tpu_torch.game.checkpoint import CheckpointManager
    from photon_ml_tpu_torch.game.coordinate_descent import (
        ValidationSpec,
        run_coordinate_descent,
    )
    from photon_ml_tpu_torch.incremental.warmstart import WarmStartError
    from photon_ml_tpu_torch.utils.timing import Timer

    if mesh is not None and device is None:
        device = mesh.first_device
    dev = resolve_device(device)
    if not same_device(data.device, dev):
        raise ValueError(f"the dataset lives on {data.device} but the fit runs on {dev}; "
                         "build it with the same device")
    if warm_start.model is None:
        raise WarmStartError(
            "fit_incremental needs a warm start carrying a full GAME model (kind "
            f"'{warm_start.lineage.kind}' restored a bare coefficient table; streamed tables "
            "warm-start StreamingRandomEffectTrainer via "
            "ShardedCoefficientTable.from_coefficients instead)")
    if checkpoint_spec is not None and os.path.realpath(checkpoint_spec.directory) == \
            os.path.realpath(warm_start.lineage.checkpoint_dir):
        raise WarmStartError(
            "the incremental fit's checkpoint directory must not be its own warm-start base "
            "— a crash mid-refresh would corrupt the base checkpoint it restarts from")
    config = estimator.config
    validation = None
    if validation_data is not None:
        if not config.evaluators:
            raise ValueError("validation data provided but no evaluators")
        validation = ValidationSpec(data=validation_data, evaluators=list(config.evaluators))
    iters = num_iterations or config.num_iterations
    t = Timer().start()
    lineage = warm_start.lineage
    # the span's lineage attributes: the run report's Freshness section
    attrs = {"base": lineage.checkpoint_dir, "kind": lineage.kind}
    if lineage.digest:
        attrs["base_digest"] = lineage.digest
    if lineage.step is not None:
        attrs["base_step"] = int(lineage.step)
    if delta is not None:
        attrs["delta_digest"] = delta.digest
        attrs["delta_rows"] = int(delta.delta_rows)
        attrs["touched_fraction"] = round(
            max((c.touched_fraction for c in delta.coordinates.values()), default=0.0), 6)
    with telemetry.span("incremental_fit", **attrs):
        factors = list(lambda_factors) if lambda_factors else [1.0]
        if len(factors) > 1 and validation is None:
            raise ValueError("a local λ sweep needs validation data to select on")
        lane_results, lane_wrapped = [], []
        initial = None
        new_entities = 0
        untransplanted: dict = {}
        # one whole coordinate descent per factor, in turn; each starts from
        # its more regularized neighbour's models (the first from the base)
        for li, factor in enumerate(factors):
            overrides = None if factor == 1.0 else _scaled_overrides(config, factor)
            coords = estimator._build_coordinates(data, mesh, overrides)
            if initial is None:
                initial, new_entities, untransplanted = _transplant_models(
                    coords, warm_start.model)
            wrapped = _wrap_masked(coords, delta, data, untransplanted)
            result = run_coordinate_descent(
                wrapped, task=config.task, num_iterations=iters, validation=validation,
                initial_models=initial, guard=guard,
                checkpoint=(None if checkpoint_spec is None or li > 0
                            else CheckpointManager(checkpoint_spec, device=dev)),
                should_stop=should_stop)
            lane_results.append(result)
            lane_wrapped.append(wrapped)
            initial = dict(result.model.models)

        selection = None
        pick = 0
        if len(factors) > 1:
            from photon_ml_tpu_torch.sweep.select import (
                SweepSelection,
                default_metric,
                select_best,
            )

            metric_name = metric or default_metric(config.task)
            values = np.asarray([_primary_metric_value(r.model, validation.data, metric_name)
                                 for r in lane_results], np.float64)
            pick = select_best(values, metric_name, policy=policy, rel_tol=rel_tol)
            selection = SweepSelection(index=pick, metric=metric_name, metrics=values,
                                       policy=policy)
            telemetry.gauge("sweep.selected_metric").set(float(values[pick]))
        result = lane_results[pick]
        bootstrap = None
        if bootstrap_samples > 0:
            # the masked-lane bootstrap of the selected factor's touched rows
            with telemetry.span("incremental_bootstrap", samples=bootstrap_samples):
                per_coord = {}
                for name, coord in lane_wrapped[pick].items():
                    if not hasattr(coord, "bootstrap_touched"):
                        continue
                    buckets = coord.bootstrap_touched(num_samples=bootstrap_samples,
                                                      seed=bootstrap_seed)
                    if not buckets:
                        continue
                    agg = {}
                    for bi, entry in buckets.items():
                        summ = entry["report"].summary()
                        summ["touched_lanes"] = int(len(entry["touched"]))
                        agg[str(bi)] = summ
                    per_coord[name] = agg
                if per_coord:
                    bootstrap = {"num_samples": int(bootstrap_samples),
                                 "coordinates": per_coord}
                    telemetry.counter("quality.bootstrap_fits").inc()
        counts = {k: sum(getattr(c, k, 0) for w in lane_wrapped for c in w.values())
                  for k in ("lanes_solved", "lanes_skipped", "bucket_solves",
                            "buckets_skipped")}
    seconds = t.stop()
    telemetry.gauge("incremental.time_to_fresh_s").set(seconds)
    telemetry.counter("incremental.fits").inc()
    return IncrementalFitResult(
        model=result.model, best_model=result.best_model or result.model,
        best_metric=result.best_metric, history=result.history, lineage=lineage, delta=delta,
        new_entities=new_entities, seconds=seconds, selection=selection, bootstrap=bootstrap,
        **counts)
