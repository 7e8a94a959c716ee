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

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def norm(self, order: int = 2) -> Tensor:
        return torch.linalg.vector_norm(self.means, ord=order)


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

    def predict_class(self, batch, threshold: float = 0.5) -> Tensor:
        """0/1 classes of a binary task (int32): the mean against
        ``threshold`` for logistic, the score's sign for smoothed hinge."""
        name = get_loss(self.task).name
        if name not in ("logistic", "smoothed_hinge"):
            raise ValueError(f"{self.task} is not a binary classification task")
        if name == "logistic":
            return (self.compute_mean(batch) > threshold).to(torch.int32)
        return (self.compute_score(batch) > 0.0).to(torch.int32)

    def with_coefficients(self, means: Tensor, variances=None) -> "GeneralizedLinearModel":
        return dataclasses.replace(
            self, coefficients=Coefficients(means=means, variances=variances)
        )


def make_model(task: str, means: Tensor, variances=None) -> GeneralizedLinearModel:
    get_loss(task)  # validates the task name
    return GeneralizedLinearModel(
        coefficients=Coefficients(means=means, variances=variances), task=task
    )
