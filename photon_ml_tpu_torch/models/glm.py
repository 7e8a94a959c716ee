"""GLM model classes: coefficients, link functions, prediction.

Counterpart of ``photon_ml_tpu/models/glm.py``. Scores are margins w.x
(+ offset); means apply the task's link function.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.losses import get_loss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Coefficients:
    """Means and optional per-coefficient variances."""

    means: Tensor
    variances: Optional[Tensor] = None


@dataclasses.dataclass(frozen=True)
class GeneralizedLinearModel:
    """A trained GLM; ``task`` selects the link (logistic -> sigmoid,
    poisson -> exp, squared / smoothed hinge -> identity)."""

    coefficients: Coefficients
    task: str

    def compute_score(self, batch) -> Tensor:
        return batch.margins(self.coefficients.means)

    def compute_mean(self, batch) -> Tensor:
        return self.mean_of(self.compute_score(batch))

    def mean_of(self, scores: Tensor) -> Tensor:
        name = get_loss(self.task).name
        if name == "logistic":
            return torch.sigmoid(scores)
        if name == "poisson":
            return torch.exp(scores)
        return scores


def make_model(task: str, means: Tensor, variances=None) -> GeneralizedLinearModel:
    get_loss(task)  # validates the task name
    return GeneralizedLinearModel(
        coefficients=Coefficients(means=means, variances=variances), task=task
    )
