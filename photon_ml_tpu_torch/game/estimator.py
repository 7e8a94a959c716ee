"""GameEstimator: typed-config end-to-end GAME training.

Counterpart of ``photon_ml_tpu/game/estimator.py``: one typed config names
the coordinates in updating order, their shards and optimizers, the
evaluators and the coordinate-descent schedule; ``fit`` (:392-504) builds
the random-effect datasets and the coordinates, caches both for repeated
fits over the same data, and runs coordinate descent on the dataset's
device. A fixed effect's normalization context is built from ``summarize``
of its shard (``_normalization_for``, :381-390), and ``output_dir`` receives
the final and the best model (``<output_dir>/final``, ``<output_dir>/best``,
:487-501) in the model store's layout.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
``mesh``, the random and factored projectors, ``fit_incremental``,
``fit_sweep`` and ``fit_grid``.
"""

from __future__ import annotations

import dataclasses
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
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    ValidationSpec,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import (
    NOT_PORTED,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.dataset import GameDataset
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.game.random_effect_data import (
    RandomEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.optim.factory import OptimizerConfig


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
    caps, the Pearson feature bound and the projector."""

    shard_name: str
    id_name: str
    optimizer: OptimizerConfig = OptimizerConfig()
    active_rows_per_entity: Optional[int] = None
    min_rows_per_entity: int = 1
    features_to_samples_ratio: Optional[float] = None
    projector: str = "index_map"
    projected_dim: Optional[int] = None
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
class GameConfig:
    """``coordinates`` is ordered: iteration order is the updating sequence.
    The first evaluator selects the best model."""

    task: str
    coordinates: Mapping[str, FixedEffectConfig | RandomEffectConfig]
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


class GameEstimator:
    """Builds datasets and coordinates from a GameConfig and trains by
    coordinate descent."""

    def __init__(self, config: GameConfig):
        self.config = config
        self._re_datasets: dict = {}
        self._coordinates: dict = {}

    def _re_dataset(self, data: GameDataset, c: RandomEffectConfig) -> RandomEffectDataset:
        """Build, or reuse, the bucketed dataset of a random-effect config,
        keyed by the data-side parameters only."""
        key = (id(data), c.id_name, c.shard_name, c.active_rows_per_entity,
               c.min_rows_per_entity, c.features_to_samples_ratio)
        hit = self._re_datasets.get(key)
        if hit is not None and hit[0] is data:
            return hit[1]
        with telemetry.span(f"re_build:{c.id_name}:{c.shard_name}"):
            red = build_random_effect_dataset(
                data, c.id_name, c.shard_name,
                active_rows_per_entity=c.active_rows_per_entity,
                min_rows_per_entity=c.min_rows_per_entity,
                features_to_samples_ratio=c.features_to_samples_ratio,
            )
        self._re_datasets[key] = (data, red)
        return red

    def _build_coordinates(self, data: GameDataset) -> dict:
        """The coordinates of the config over ``data``; a coordinate built for
        the same data is reused with its per-fit state reset (caches of
        other datasets are dropped, so no device copy pins old data)."""
        self._coordinates = {k: v for k, v in self._coordinates.items() if v[0] is data}
        self._re_datasets = {k: v for k, v in self._re_datasets.items() if v[0] is data}
        coords = {}
        for name, c in self.config.coordinates.items():
            hit = self._coordinates.get((id(data), name))
            if hit is not None:
                coord = hit[1]
                if isinstance(coord, FixedEffectCoordinate):
                    coord._update_count = 0
                coords[name] = coord
                continue
            if isinstance(c, FixedEffectConfig):
                coord = FixedEffectCoordinate(
                    name=name, data=data, shard_name=c.shard_name,
                    loss_name=self.config.task, config=c.optimizer,
                    seed=c.down_sampling_seed, normalization=self._normalization_for(data, c),
                )
            elif isinstance(c, RandomEffectConfig):
                if c.projector != "index_map":
                    raise NotImplementedError(NOT_PORTED.format(
                        f"the '{c.projector}' projector", 10))
                coord = RandomEffectCoordinate(
                    name=name, data=data, re_data=self._re_dataset(data, c),
                    loss_name=self.config.task, config=c.optimizer,
                    compute_variances=c.compute_variances,
                )
            else:
                raise TypeError(f"coordinate '{name}': unknown config {type(c).__name__} "
                                f"(factored random effects are ROADMAP.md Queue 1 item 10)")
            self._coordinates[(id(data), name)] = (data, coord)
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
        checkpoint_spec=None,
        guard=None,
        should_stop=None,
        device: torch.device | str | None = None,
    ) -> GameFitResult:
        """Train on ``device`` (default cuda), where ``data`` must live; with
        ``output_dir``, save the final model to ``<output_dir>/final`` and
        the best to ``<output_dir>/best``."""
        dev = resolve_device(device)
        if data.device.type != dev.type or (dev.index is not None
                                            and data.device.index != dev.index):
            raise ValueError(f"the dataset lives on {data.device} but the fit runs on {dev}; "
                             "build it with the same device")
        if mesh is not None:
            raise NotImplementedError(NOT_PORTED.format("a mesh", 12))
        with telemetry.span("fit", task=self.config.task):
            with telemetry.span("build_coordinates"):
                coordinates = self._build_coordinates(data)
            validation = None
            if validation_data is not None:
                if not self.config.evaluators:
                    raise ValueError("validation data provided but no evaluators")
                validation = ValidationSpec(data=validation_data,
                                            evaluators=list(self.config.evaluators))
            result: CoordinateDescentResult = run_coordinate_descent(
                coordinates, task=self.config.task,
                num_iterations=self.config.num_iterations, validation=validation,
                initial_models=initial_models, guard=guard,
                checkpoint=checkpoint_spec, should_stop=should_stop,
            )
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

    def fit_incremental(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED.format("GameEstimator.fit_incremental", 14))

    def fit_sweep(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED.format("GameEstimator.fit_sweep", 11))

    def fit_grid(self, *args, **kwargs):
        raise NotImplementedError(NOT_PORTED.format("GameEstimator.fit_grid", 11))


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
                       compute_variances=c.compute_variances)
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
