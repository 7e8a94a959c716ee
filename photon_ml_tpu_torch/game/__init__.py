"""GAME / GLMix training (counterpart of ``photon_ml_tpu/game``): a fixed
effect on the CSR fast path plus per-entity random effects solved by a
batched Newton over dense bucket designs, trained by coordinate descent."""

from photon_ml_tpu_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    ValidationSpec,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.dataset import (
    FeatureShard,
    GameDataset,
    IdColumn,
    build_game_dataset,
)
from photon_ml_tpu_torch.game.estimator import (
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    GameFitResult,
    RandomEffectConfig,
)
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.game.random_effect_data import (
    EntityBucket,
    RandomEffectDataset,
    build_random_effect_dataset,
)

__all__ = [
    "CoordinateDescentResult",
    "EntityBucket",
    "FeatureShard",
    "FixedEffectConfig",
    "FixedEffectCoordinate",
    "FixedEffectModel",
    "GameConfig",
    "GameDataset",
    "GameEstimator",
    "GameFitResult",
    "GameModel",
    "IdColumn",
    "RandomEffectBucketModel",
    "RandomEffectConfig",
    "RandomEffectCoordinate",
    "RandomEffectDataset",
    "RandomEffectModel",
    "ValidationSpec",
    "build_game_dataset",
    "build_random_effect_dataset",
    "run_coordinate_descent",
]
