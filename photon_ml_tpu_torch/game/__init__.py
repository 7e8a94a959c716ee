"""GAME / GLMix training (counterpart of ``photon_ml_tpu/game``): a fixed
effect on the CSR fast path, per-entity random effects solved as lanes of a
bucket, factored random effects and the random projector, trained by
coordinate descent with checkpoints."""

from photon_ml_tpu_torch.game.checkpoint import (
    CheckpointError,
    CheckpointManager,
    CheckpointSpec,
    CheckpointState,
    GracefulStop,
    TrainingInterrupted,
)
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
    FactoredRandomEffectConfig,
    FixedEffectConfig,
    GameConfig,
    GameEstimator,
    GameFitResult,
    RandomEffectConfig,
)
from photon_ml_tpu_torch.game.factored import (
    FactoredRandomEffectCoordinate,
    FactoredRandomEffectModel,
    MatrixFactorizationModel,
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
    "CheckpointError",
    "CheckpointManager",
    "CheckpointSpec",
    "CheckpointState",
    "CoordinateDescentResult",
    "EntityBucket",
    "FactoredRandomEffectConfig",
    "FactoredRandomEffectCoordinate",
    "FactoredRandomEffectModel",
    "FeatureShard",
    "FixedEffectConfig",
    "FixedEffectCoordinate",
    "FixedEffectModel",
    "GameConfig",
    "GameDataset",
    "GameEstimator",
    "GameFitResult",
    "GameModel",
    "GracefulStop",
    "IdColumn",
    "MatrixFactorizationModel",
    "RandomEffectBucketModel",
    "RandomEffectConfig",
    "RandomEffectCoordinate",
    "RandomEffectDataset",
    "RandomEffectModel",
    "TrainingInterrupted",
    "ValidationSpec",
    "build_game_dataset",
    "build_random_effect_dataset",
    "run_coordinate_descent",
]
