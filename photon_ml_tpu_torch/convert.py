"""Carry parameters across from the JAX package.

The JAX side hands numpy arrays (``np.asarray(model.coefficients.means)``),
so both packages score and warm-start from the same numbers: GLMs,
normalization contexts and GAME models. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.data.projection import ProjectionMatrix
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.game.factored import (
    FactoredRandomEffectModel,
    MatrixFactorizationModel,
)
from photon_ml_tpu_torch.game.models import (
    FixedEffectModel,
    GameModel,
    RandomEffectBucketModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel, make_model


def _tensor(a, dev: torch.device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def model_from_jax(
    task: str,
    means: np.ndarray,
    variances: Optional[np.ndarray] = None,
    device: torch.device | str | None = None,
) -> GeneralizedLinearModel:
    """The port's model from a JAX model's coefficient arrays."""
    dev = resolve_device(device)
    return make_model(task, _tensor(means, dev), variances=_tensor(variances, dev))


def normalization_from_jax(
    factors: Optional[np.ndarray],
    shifts: Optional[np.ndarray],
    intercept_index: Optional[int],
    device: torch.device | str | None = None,
) -> NormalizationContext:
    """The port's normalization context from a JAX context's arrays."""
    dev = resolve_device(device)
    return NormalizationContext(
        factors=_tensor(factors, dev),
        shifts=_tensor(shifts, dev),
        intercept_index=intercept_index,
    )


def game_model_from_jax(
    task: str,
    models: Mapping[str, Mapping],
    device: torch.device | str | None = None,
) -> GameModel:
    """The port's GAME model from a JAX ``GameModel``'s arrays, one entry per
    coordinate in the model's order:

    - a fixed effect: ``{"shard_name", "coefficients"}``;
    - a random effect: ``{"id_name", "shard_name", "buckets", "entity_bucket",
      "entity_pos", "vocab"}`` with ``buckets`` a sequence of
      ``{"coefficients" [E, K], "projection" [E, K], "entity_codes" [E]}``;
    - a factored random effect: ``{"id_name", "shard_name", "projection"
      [K, d], "latent" [n_flat, K], "entity_flat", "vocab"}``;
    - a matrix factorization: ``{"row_effect", "col_effect", "row_factors",
      "col_factors", "row_vocab", "col_vocab"}``.
    """
    dev = resolve_device(device)
    out = {}
    for name, m in models.items():
        if "latent" in m:
            out[name] = FactoredRandomEffectModel(
                id_name=m["id_name"], shard_name=m["shard_name"],
                projection=ProjectionMatrix(matrix=_tensor(m["projection"], dev)),
                latent=_tensor(m["latent"], dev),
                entity_flat=np.asarray(m["entity_flat"], np.int64), vocab=np.asarray(m["vocab"]))
            continue
        if "row_factors" in m:
            out[name] = MatrixFactorizationModel(
                row_effect=m["row_effect"], col_effect=m["col_effect"],
                row_factors=_tensor(m["row_factors"], dev),
                col_factors=_tensor(m["col_factors"], dev),
                row_vocab=np.asarray(m["row_vocab"]), col_vocab=np.asarray(m["col_vocab"]))
            continue
        if "buckets" not in m:
            out[name] = FixedEffectModel(coefficients=_tensor(m["coefficients"], dev),
                                         shard_name=m["shard_name"])
            continue
        buckets = tuple(
            RandomEffectBucketModel(
                coefficients=_tensor(b["coefficients"], dev),
                projection=torch.from_numpy(np.asarray(b["projection"], np.int64)).to(dev),
                entity_codes=np.asarray(b["entity_codes"], np.int32),
            )
            for b in m["buckets"]
        )
        out[name] = RandomEffectModel(
            id_name=m["id_name"], shard_name=m["shard_name"], buckets=buckets,
            entity_bucket=np.asarray(m["entity_bucket"], np.int32),
            entity_pos=np.asarray(m["entity_pos"], np.int32),
            vocab=np.asarray(m["vocab"]),
        )
    return GameModel(task=task, models=out)
