"""GameEstimator: typed-config end-to-end GAME training.

Counterpart of ``photon_ml_tpu/game/estimator.py``: one typed config names
the coordinates in updating order, their shards and optimizers, the
evaluators and the coordinate-descent schedule; ``fit`` (:392-504) builds
the random-effect datasets and the coordinates, caches both for repeated
fits over the same data, and runs coordinate descent on the dataset's
device. A fixed effect's normalization context is built from ``summarize``
of its shard (``_normalization_for``, :381-390), and ``output_dir`` receives
the final and the best model (``<output_dir>/final``, ``<output_dir>/best``,
:487-501) in the model store's layout. ``guard`` (a ``GuardSpec``) guards
every coordinate solve. ``events`` is the lifecycle event bus: ``fit``
sends a setup, a start, one optimization-log event per coordinate update
and a finish event (:423-480). ``checkpoint_spec`` (a ``CheckpointSpec``)
saves the state after each step and resumes from the newest valid
checkpoint; ``should_stop`` is polled after every step (:399-471). A
``FactoredRandomEffectConfig`` builds a factored coordinate and a random
effect with ``projector="random"`` the random projector, both
``game/factored.py``'s coordinate (:329-367).

``fit_sweep`` (:585-674) trains every λ of a grid at once as lanes
(``sweep/runner.py`` ``sweep_game``), selects the winner on the validation
data (``sweep/select.py``) and saves it under ``<output_dir>/best``;
``fit_grid`` (:676-768) runs the cartesian product of per-coordinate
optimizer configs, one coordinate-descent run each, reusing a coordinate
whose config a combination does not change, and returns its entries
best-first.

``mesh`` (a ``parallel.Mesh``, in ``fit`` and ``fit_grid``; :241-292) trains
over a device mesh: a mesh with named ``batch``/``model`` axes is used as
given (fixed effects split their rows over ``batch``, random effects their
entities over ``model``), a legacy 1-D mesh becomes two views over the same
devices (``data`` and ``entity``), and a mesh that names neither on more
than one axis is refused. The mesh's first device must be the dataset's.
A factored random effect and the random projector work over the mesh's
model axis (else its batch axis, ``game/factored.py``). The returned and
saved models are joined on the first device; during the fit the random
effects' coefficients stay with their owners.

``fit_incremental`` (:506-581) is the incremental refresh
(``incremental/``): the base model transplanted into the combined data's
coordinates, and only the delta's touched random-effect lanes solved.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Mapping, Optional, Sequence

import torch

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.normalization import (
    NormalizationContext,
    NormalizationType,
    build_normalization_context,
)
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.device import resolve_device, same_device
from photon_ml_tpu_torch.evaluation.evaluators import better_than
from photon_ml_tpu_torch.game.checkpoint import CheckpointManager, CheckpointSpec
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    ValidationSpec,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.game.random_effect_data import (
    RandomEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.optim.factory import OptimizerConfig
from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, ENTITY_AXIS, Mesh
from photon_ml_tpu_torch.parallel.sharding import BATCH_AXIS, MODEL_AXIS, data_axis, model_axis
from photon_ml_tpu_torch.utils.events import (
    EventEmitter,
    OptimizationLogEvent,
    SetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_tpu_torch.utils.timing import Timer


@dataclasses.dataclass(frozen=True)
class FixedEffectConfig:
    """One global GLM coordinate."""

    shard_name: str
    optimizer: OptimizerConfig = OptimizerConfig()
    normalization: NormalizationType | str = NormalizationType.NONE
    intercept_index: Optional[int] = None
    down_sampling_seed: int = 0


@dataclasses.dataclass(frozen=True)
class RandomEffectConfig:
    """One per-entity coordinate: the id column, the shard, active-data
    caps, the Pearson feature bound and the projector: "index_map" (each
    entity's observed features) or "random" (a shared Gaussian projection
    into ``projected_dim`` dimensions, drawn from ``projection_seed``, with
    ``projection_intercept_index`` passed through)."""

    shard_name: str
    id_name: str
    optimizer: OptimizerConfig = OptimizerConfig()
    active_rows_per_entity: Optional[int] = None
    min_rows_per_entity: int = 1
    features_to_samples_ratio: Optional[float] = None
    projector: str = "index_map"
    projected_dim: Optional[int] = None
    projection_seed: int = 0
    projection_intercept_index: Optional[int] = None
    compute_variances: bool = False

    def __post_init__(self):
        if self.projector == "random" and self.compute_variances:
            raise ValueError(
                "compute_variances needs the index_map projector: under a Gaussian "
                "random projection the local coordinates are mixtures of global "
                "features, so per-coefficient variances have no original-space meaning"
            )
        if self.projector not in ("index_map", "random"):
            raise ValueError(f"unknown projector '{self.projector}'")
        if self.projector == "random" and not self.projected_dim:
            raise ValueError("projector='random' requires projected_dim")


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectConfig:
    """One factored (matrix-factorization) random-effect coordinate:
    ``latent_dim`` latent factors, ``mf_iterations`` alternations, the
    per-entity optimizer ``re_optimizer`` and the latent matrix's
    ``latent_optimizer``."""

    shard_name: str
    id_name: str
    latent_dim: int
    mf_iterations: int = 1
    re_optimizer: OptimizerConfig = OptimizerConfig()
    latent_optimizer: OptimizerConfig = OptimizerConfig()
    active_rows_per_entity: Optional[int] = None
    min_rows_per_entity: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class GameConfig:
    """``coordinates`` is ordered: iteration order is the updating sequence.
    The first evaluator selects the best model."""

    task: str
    coordinates: Mapping[str, FixedEffectConfig | RandomEffectConfig
                         | FactoredRandomEffectConfig]
    num_iterations: int = 1
    evaluators: Sequence[str] = ()

    def __post_init__(self):
        if not self.coordinates:
            raise ValueError("GameConfig needs at least one coordinate")


@dataclasses.dataclass
class GameFitResult:
    model: GameModel
    best_model: GameModel
    best_metric: Optional[float]
    history: list


@dataclasses.dataclass
class SweepFitResult:
    """A finished λ sweep: the selection, the winning model, and the full
    per-config record (``sweep.runner.GameSweepResult``)."""

    model: GameModel  # the selected winner
    selection: object  # sweep.select.SweepSelection
    sweep: object  # sweep.runner.GameSweepResult
    published_version: Optional[str] = None  # the registry version path, when published


@dataclasses.dataclass
class GridFitEntry:
    """One combination of a ``fit_grid`` sweep: the per-coordinate optimizer
    configs used and the resulting fit (the reference's (config, model,
    evaluation) triple)."""

    optimizer_configs: Mapping[str, OptimizerConfig]
    result: GameFitResult


def _record_table_estimate(name: str, red, dim=None) -> None:
    """Publish the predicted device residency of a random-effect
    coordinate's coefficient table (``memory.table_bytes.<name>``) and check
    the headroom before the solve allocates it. ``dim``: the per-entity
    dimension of a projected or factored table; None: the buckets'
    [entities, local features] blocks."""
    if dim is not None:
        table_bytes = telemetry.memory.estimate_table_bytes(red.num_entities, dim)
    else:
        table_bytes = sum(telemetry.memory.estimate_table_bytes(b.num_entities,
                                                                b.num_local_features)
                          for b in red.buckets)
    telemetry.gauge(f"memory.table_bytes.{name}").set(table_bytes)
    telemetry.memory.check_headroom(table_bytes, label=f"coordinate:{name} coefficient table")


class GameEstimator:
    """Builds datasets and coordinates from a GameConfig and trains by
    coordinate descent."""

    def __init__(self, config: GameConfig):
        self.config = config
        self._re_datasets: dict = {}
        self._coordinates: dict = {}
        # register listeners before fit() to observe its events
        self.events = EventEmitter()

    def _re_dataset(self, data: GameDataset, c) -> RandomEffectDataset:
        """Build, or reuse, the bucketed dataset of a random-effect or
        factored config, keyed by the data-side parameters only."""
        ratio = getattr(c, "features_to_samples_ratio", None)
        key = (id(data), c.id_name, c.shard_name, c.active_rows_per_entity,
               c.min_rows_per_entity, ratio)
        hit = self._re_datasets.get(key)
        if hit is not None and hit[0] is data:
            return hit[1]
        with telemetry.span(f"re_build:{c.id_name}:{c.shard_name}"):
            red = build_random_effect_dataset(
                data, c.id_name, c.shard_name,
                active_rows_per_entity=c.active_rows_per_entity,
                min_rows_per_entity=c.min_rows_per_entity,
                features_to_samples_ratio=ratio,
            )
        self._re_datasets[key] = (data, red)
        return red

    def _build_coordinates(self, data: GameDataset, mesh: Optional[Mesh] = None,
                           overrides: Optional[Mapping[str, OptimizerConfig]] = None,
                           only: Optional[set] = None) -> dict:
        """The coordinates of the config over ``data`` (on ``mesh``, when
        given), with a coordinate's optimizer config replaced where
        ``overrides`` names it (only the coordinates in ``only``, when given);
        a coordinate built for the same data, config and mesh devices is
        reused with its per-fit state reset (caches of other datasets are
        dropped, so no device copy pins old data)."""
        data_mesh, entity_mesh = _mesh_views(mesh, data)
        overrides = overrides or {}
        self._coordinates = {k: v for k, v in self._coordinates.items() if v[0] is data}
        self._re_datasets = {k: v for k, v in self._re_datasets.items() if v[0] is data}
        coords = {}
        for name, c in self.config.coordinates.items():
            if only is not None and name not in only:
                continue
            opt = overrides.get(name)
            key = (id(data), name) if opt is None else (id(data), name, opt)
            if mesh is not None:
                key += (mesh.key(),)
            hit = self._coordinates.get(key)
            if hit is not None:
                coord = hit[1]
                # a fresh fit: the down-sampling salt restarts, stale
                # trackers clear, and the guarded loop opts in again
                if hasattr(coord, "_update_count"):
                    coord._update_count = 0
                coord.last_tracker = None
                if hasattr(coord, "health_check"):
                    coord.health_check, coord.extra_l2, coord.last_health = False, 0.0, None
                coords[name] = coord
                continue
            if isinstance(c, FixedEffectConfig):
                coord = FixedEffectCoordinate(
                    name=name, data=data, shard_name=c.shard_name,
                    loss_name=self.config.task, config=opt or c.optimizer,
                    seed=c.down_sampling_seed, normalization=self._normalization_for(data, c),
                    mesh=data_mesh,
                )
            elif isinstance(c, RandomEffectConfig) and c.projector == "random":
                # per-entity solves in a fixed Gaussian space, no refit
                red = self._re_dataset(data, c)
                _record_table_estimate(name, red, dim=c.projected_dim)
                coord = FactoredRandomEffectCoordinate(
                    name=name, data=data, re_data=red,
                    loss_name=self.config.task, re_config=opt or c.optimizer,
                    latent_config=opt or c.optimizer, latent_dim=c.projected_dim,
                    refit_projection=False,
                    projection_intercept_index=c.projection_intercept_index,
                    seed=c.projection_seed, mesh=entity_mesh,
                )
            elif isinstance(c, RandomEffectConfig):
                red = self._re_dataset(data, c)
                _record_table_estimate(name, red)
                coord = RandomEffectCoordinate(
                    name=name, data=data, re_data=red,
                    loss_name=self.config.task, config=opt or c.optimizer,
                    compute_variances=c.compute_variances, mesh=entity_mesh,
                )
            elif isinstance(c, FactoredRandomEffectConfig):
                red = self._re_dataset(data, c)
                _record_table_estimate(name, red, dim=c.latent_dim)
                coord = FactoredRandomEffectCoordinate(
                    name=name, data=data, re_data=red,
                    loss_name=self.config.task, re_config=opt or c.re_optimizer,
                    latent_config=c.latent_optimizer, latent_dim=c.latent_dim,
                    mf_iterations=c.mf_iterations, seed=c.seed, mesh=entity_mesh,
                )
            else:
                raise TypeError(f"coordinate '{name}': unknown config {type(c).__name__}")
            self._coordinates[key] = (data, coord)
            coords[name] = coord
        return coords

    @staticmethod
    def _normalization_for(data: GameDataset,
                           c: FixedEffectConfig) -> Optional[NormalizationContext]:
        """The fixed effect's normalization context, from the feature summary
        of its shard on the dataset's device; None for NONE."""
        ntype = NormalizationType(c.normalization)
        if ntype == NormalizationType.NONE:
            return None
        summary = summarize(data.csr_batch(c.shard_name))
        return build_normalization_context(ntype, summary, intercept_index=c.intercept_index)

    def fit(
        self,
        data: GameDataset,
        validation_data: Optional[GameDataset] = None,
        initial_models: Optional[Mapping[str, object]] = None,
        output_dir: Optional[str] = None,
        mesh=None,
        checkpoint_spec: Optional[CheckpointSpec] = None,
        guard=None,
        should_stop=None,
        device: torch.device | str | None = None,
    ) -> GameFitResult:
        """Train on ``device`` (default cuda), where ``data`` must live; with
        ``output_dir``, save the final model to ``<output_dir>/final`` and
        the best to ``<output_dir>/best``. With ``checkpoint_spec`` the state
        is saved after the steps it asks for and a fit resumes from the
        newest valid checkpoint; when ``should_stop()`` turns true after a
        step, a final checkpoint is written and ``TrainingInterrupted``
        raised. With ``mesh`` the fit runs over its devices (the module's
        docstring); ``device`` then defaults to the mesh's first device."""
        if mesh is not None and device is None:
            device = mesh.first_device
        dev = resolve_device(device)
        if not same_device(data.device, dev):
            raise ValueError(f"the dataset lives on {data.device} but the fit runs on {dev}; "
                             "build it with the same device")
        t = Timer().start()
        self.events.send(SetupEvent(config=_config_metadata(self.config)))
        with telemetry.span("fit", task=self.config.task):
            with telemetry.span("build_coordinates"):
                coordinates = self._build_coordinates(data, mesh)
            telemetry.memory.record_phase_memory("build_coordinates", device=dev)
            validation = None
            if validation_data is not None:
                if not self.config.evaluators:
                    raise ValueError("validation data provided but no evaluators")
                validation = ValidationSpec(data=validation_data,
                                            evaluators=list(self.config.evaluators))
            self.events.send(TrainingStartEvent(num_rows=data.num_rows))
            result: CoordinateDescentResult = run_coordinate_descent(
                coordinates, task=self.config.task,
                num_iterations=self.config.num_iterations, validation=validation,
                initial_models=initial_models,
                on_step=lambda entry: self.events.send(OptimizationLogEvent(
                    iteration=entry["iteration"], coordinate=entry["coordinate"],
                    seconds=entry["seconds"], metrics=entry.get("metrics"))),
                guard=guard, should_stop=should_stop,
                checkpoint=(None if checkpoint_spec is None
                            else CheckpointManager(checkpoint_spec, device=dev)),
            )
            telemetry.memory.record_phase_memory("fit", device=dev)
        self.events.send(TrainingFinishEvent(best_metric=result.best_metric, seconds=t.stop(),
                                             metrics_snapshot=telemetry.snapshot()))
        if output_dir is not None:
            # imported here: model_store imports game.models, which imports
            # this package
            from photon_ml_tpu_torch.data.model_store import save_game_model

            meta = {"config": _config_metadata(self.config), "best_metric": result.best_metric}
            save_game_model(result.model, os.path.join(output_dir, "final"),
                            extra_metadata=meta)
            save_game_model(result.best_model, os.path.join(output_dir, "best"),
                            extra_metadata=meta)
        return GameFitResult(model=result.model, best_model=result.best_model,
                             best_metric=result.best_metric, history=result.history)

    def fit_incremental(
        self,
        data: GameDataset,
        warm_start,
        delta=None,
        validation_data: Optional[GameDataset] = None,
        output_dir: Optional[str] = None,
        mesh=None,
        num_iterations: Optional[int] = None,
        lambda_factors=None,
        metric: Optional[str] = None,
        policy: str = "best",
        rel_tol: float = 0.01,
        guard=None,
        checkpoint_spec: Optional[CheckpointSpec] = None,
        should_stop=None,
        bootstrap_samples: int = 0,
        bootstrap_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        """Delta-aware warm-start refresh over the combined data on
        ``device`` (default cuda; with ``mesh``, its first device).

        ``warm_start`` (``incremental.load_warm_start``) seeds every
        coordinate from the base model, the per-entity rows re-homed by
        entity value, so a grown vocabulary starts only new entities at
        zero. With ``delta`` (``incremental.scan_delta``) the random
        effects solve only the touched entities' lanes (the untouched rows
        stay bit for bit; a bucket with no touched entity is not solved)
        while the fixed effect refreshes over all rows. ``lambda_factors``
        (descending multipliers, e.g. ``incremental.local_lambda_factors``)
        runs one fit per factor around the incumbent regularization, each
        from its more regularized neighbour's models, and selects with
        ``sweep.select`` (it needs ``validation_data``). With
        ``output_dir`` the final and best models are saved with the lineage
        in their metadata. Returns ``incremental.IncrementalFitResult``."""
        from photon_ml_tpu_torch.incremental.refit import run_incremental_fit

        result = run_incremental_fit(
            self, data, warm_start, delta=delta, validation_data=validation_data, mesh=mesh,
            num_iterations=num_iterations, lambda_factors=lambda_factors, metric=metric,
            policy=policy, rel_tol=rel_tol, guard=guard, checkpoint_spec=checkpoint_spec,
            should_stop=should_stop, bootstrap_samples=bootstrap_samples,
            bootstrap_seed=bootstrap_seed, device=device)
        if output_dir is not None:
            from photon_ml_tpu_torch.data.model_store import save_game_model
            from photon_ml_tpu_torch.incremental.publish import lineage_record

            meta = {"config": _config_metadata(self.config), "best_metric": result.best_metric,
                    "lineage": lineage_record(result.lineage, delta=result.delta)}
            save_game_model(result.model, os.path.join(output_dir, "final"),
                            extra_metadata=meta)
            save_game_model(result.best_model, os.path.join(output_dir, "best"),
                            extra_metadata=meta)
        return result

    def fit_sweep(
        self,
        data: GameDataset,
        validation_data: GameDataset,
        grid,
        metric: Optional[str] = None,
        policy: str = "best",
        rel_tol: float = 0.01,
        num_iterations: Optional[int] = None,
        warm_start: bool = True,
        output_dir: Optional[str] = None,
        registry_dir: Optional[str] = None,
        index_maps: Optional[Mapping] = None,
        device: torch.device | str | None = None,
    ) -> SweepFitResult:
        """Train every λ of ``grid`` at once on ``device`` (default cuda) and
        keep the best.

        The lane path (``sweep.runner.sweep_game``): each coordinate update
        solves all G configs as lanes, unconverged lanes warm-start from
        their more-regularized neighbour, every lane is scored against
        ``validation_data``, and the winner is selected by ``metric``
        (default: the task's ModelSelection metric) under ``policy``. With
        ``output_dir`` the winner is saved under ``<output_dir>/best``; with
        ``registry_dir`` (and ``index_maps`` pinning the feature space) it is
        published through ``serving.registry.publish_version``."""
        from photon_ml_tpu_torch.sweep.runner import sweep_game
        from photon_ml_tpu_torch.sweep.select import export_winner, run_selection

        if registry_dir is not None and not index_maps:
            raise ValueError("publishing a sweep winner to a registry requires index_maps "
                             "(the registry refuses versions without a pinned feature space)")

        result = sweep_game(self.config, data, grid, num_iterations=num_iterations,
                            warm_start=warm_start, device=device)
        selection = run_selection(result, validation_data, metric=metric, policy=policy,
                                  rel_tol=rel_tol)
        model = result.model_for(selection.index)
        meta = {"config": _config_metadata(self.config), "sweep_grid": grid.to_json()}
        if output_dir is not None:
            from photon_ml_tpu_torch.data.model_store import save_game_model

            save_game_model(model, os.path.join(output_dir, "best"), extra_metadata={
                **meta, "sweep_selection": selection.to_json()})
        published = None
        if registry_dir is not None:
            published = export_winner(model, index_maps, registry_dir, selection=selection,
                                      extra_metadata=meta)
        return SweepFitResult(model=model, selection=selection, sweep=result,
                              published_version=published)

    def fit_grid(
        self,
        data: GameDataset,
        validation_data: GameDataset,
        grid: Mapping[str, Sequence[OptimizerConfig]],
        mesh=None,
        device: torch.device | str | None = None,
    ) -> list[GridFitEntry]:
        """Sweep the cartesian product of per-coordinate optimizer configs on
        ``device`` (default cuda).

        The reference trains one coordinate-descent run per combination and
        returns (config, model, evaluation) triples
        (GameEstimator.scala:279-398). Datasets are built once; a coordinate
        whose config a combination does not change is reused (built once per
        (name, config) within the sweep). Each combination sends a start, its
        optimization-log and a finish event (the setup event once); the
        entries come back sorted best-first by the primary evaluator. With
        ``mesh`` every combination trains over its devices, as ``fit``."""
        if mesh is not None and device is None:
            device = mesh.first_device
        dev = resolve_device(device)
        if not same_device(data.device, dev):
            raise ValueError(f"the dataset lives on {data.device} but the fit runs on {dev}; "
                             "build it with the same device")
        if not self.config.evaluators:
            raise ValueError("fit_grid needs evaluators to rank combinations")
        unknown = set(grid) - set(self.config.coordinates)
        if unknown:
            raise ValueError(f"grid names unknown coordinates: {sorted(unknown)}")
        names = list(grid)
        combos = list(itertools.product(*(grid[n] for n in names)))
        validation = ValidationSpec(data=validation_data,
                                    evaluators=list(self.config.evaluators))
        primary = self.config.evaluators[0]
        self.events.send(SetupEvent(config=_config_metadata(self.config)))
        coord_cache: dict = {}

        def coordinates_for(overrides):
            missing = {n for n in self.config.coordinates
                       if (n, overrides.get(n)) not in coord_cache}
            built = (self._build_coordinates(data, mesh, overrides, only=missing) if missing
                     else {})
            out = {}
            for n in self.config.coordinates:
                key = (n, overrides.get(n))
                if key not in coord_cache:
                    coord_cache[key] = built[n]
                out[n] = coord_cache[key]
            return out

        entries: list[GridFitEntry] = []
        for i, combo in enumerate(combos):
            overrides = dict(zip(names, combo))
            t = Timer().start()
            self.events.send(TrainingStartEvent(num_rows=data.num_rows))
            with telemetry.span("fit", task=self.config.task, combination=i):
                result = run_coordinate_descent(
                    coordinates_for(overrides), task=self.config.task,
                    num_iterations=self.config.num_iterations, validation=validation,
                    on_step=lambda entry: self.events.send(OptimizationLogEvent(
                        iteration=entry["iteration"], coordinate=entry["coordinate"],
                        seconds=entry["seconds"], metrics=entry.get("metrics"))))
            self.events.send(TrainingFinishEvent(best_metric=result.best_metric,
                                                 seconds=t.stop(),
                                                 metrics_snapshot=telemetry.snapshot()))
            entries.append(GridFitEntry(
                optimizer_configs=overrides,
                result=GameFitResult(model=result.model, best_model=result.best_model,
                                     best_metric=result.best_metric, history=result.history)))
        return sorted(entries, key=lambda e: e.result.best_metric,
                      reverse=better_than(primary, 1.0, 0.0))  # True iff maximizing


def _mesh_views(mesh: Optional[Mesh], data: GameDataset) -> tuple[Optional[Mesh], ...]:
    """(the fixed effects' mesh, the random effects' mesh) of a fit's mesh
    (``photon_ml_tpu/game/estimator.py:252-272``)."""
    if mesh is None:
        return None, None
    first = mesh.first_device
    if not same_device(first, data.device):
        raise ValueError(f"the mesh's first device is {first} but the dataset lives on "
                         f"{data.device}; the solver state and the models live on the first "
                         "device")
    if set(mesh.axis_names) & {BATCH_AXIS, MODEL_AXIS} or len(mesh.axis_names) > 1:
        if data_axis(mesh) is None and model_axis(mesh) is None:
            # every coordinate would drop the mesh and train on one device
            raise ValueError(
                f"mesh axes {mesh.axis_names} name neither a batch/data nor a model/entity "
                "axis — nothing would shard; use --mesh batch=N,model=M (or a 1-D mesh)")
        return mesh, mesh
    devices = mesh.device_list()
    return Mesh(devices, (DATA_AXIS,)), Mesh(devices, (ENTITY_AXIS,))


def _config_metadata(config: GameConfig) -> dict:
    """A JSON-safe description of the training config, saved with the model
    (the reference's ``_config_metadata``, ``estimator.py:770-833``)."""

    def describe_opt(opt: OptimizerConfig) -> dict:
        out = {
            "type": str(opt.optimizer_type.value),
            "max_iterations": opt.max_iterations,
            "tolerance": opt.tolerance,
            "regularization": str(opt.regularization.reg_type.value),
            "alpha": opt.regularization.alpha,
            "regularization_weight": opt.regularization_weight,
            "lbfgs_history": opt.lbfgs_history,
            "down_sampling_rate": opt.down_sampling_rate,
        }
        if opt.box_constraints:
            out["box_constraints"] = [
                [i, None if lo == float("-inf") else lo, None if hi == float("inf") else hi]
                for i, lo, hi in opt.box_constraints]
        return out

    def describe(c) -> dict:
        out = {"shard_name": c.shard_name}
        if isinstance(c, RandomEffectConfig):
            out.update(type="random_effect", id_name=c.id_name,
                       active_rows_per_entity=c.active_rows_per_entity,
                       min_rows_per_entity=c.min_rows_per_entity,
                       features_to_samples_ratio=c.features_to_samples_ratio,
                       projector=c.projector, projected_dim=c.projected_dim,
                       projection_seed=c.projection_seed,
                       projection_intercept_index=c.projection_intercept_index,
                       compute_variances=c.compute_variances)
        elif isinstance(c, FactoredRandomEffectConfig):
            out.update(type="factored_random_effect", id_name=c.id_name,
                       active_rows_per_entity=c.active_rows_per_entity,
                       min_rows_per_entity=c.min_rows_per_entity,
                       latent_dim=c.latent_dim, mf_iterations=c.mf_iterations, seed=c.seed,
                       optimizer=describe_opt(c.re_optimizer),
                       latent_optimizer=describe_opt(c.latent_optimizer))
            return out
        else:
            out.update(type="fixed_effect",
                       normalization=str(NormalizationType(c.normalization).value),
                       intercept_index=c.intercept_index,
                       down_sampling_seed=c.down_sampling_seed)
        out["optimizer"] = describe_opt(c.optimizer)
        return out

    return {"task": config.task, "num_iterations": config.num_iterations,
            "evaluators": list(config.evaluators),
            "coordinates": {n: describe(c) for n, c in config.coordinates.items()}}
