"""Carry parameters across from the JAX package.

The JAX side hands numpy arrays (``np.asarray(model.coefficients.means)``),
so both packages score and warm-start from the same numbers. Nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import resolve_device
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
