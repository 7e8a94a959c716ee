"""Gaussian random projection matrices: the random projector of a random
effect and the initial latent matrix of a factored one.

Counterpart of ``photon_ml_tpu/data/projection.py:26-77``. Entries are drawn
N(0, 1) by ``np.random.default_rng(seed).standard_normal`` in float64,
divided by the projected dimension (the reference's scale, not its square
root), clipped to [-1, 1], with an optional intercept passthrough row (zeros
but a 1 in the intercept column), and cast to float32 last: the same seed
gives the same bits in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ProjectionMatrix:
    """A dense projection x -> A x, A of [projected_dim, original_dim];
    ``project_coefficients`` maps projected coefficients back: A^T w."""

    matrix: Tensor  # f32[k, d]

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[0]

    @property
    def original_dim(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, x: Tensor) -> Tensor:
        return self.matrix @ x

    def project_coefficients(self, w_projected: Tensor) -> Tensor:
        return self.matrix.T @ w_projected

    def extended(self) -> Tensor:
        """The matrix with one more all-zero column at ``original_dim``, where
        a bucket's sentinel feature id (its padding) gathers zeros."""
        return torch.nn.functional.pad(self.matrix, (0, 1))


def build_gaussian_projection_matrix(
    projected_dim: int,
    original_dim: int,
    intercept_index: Optional[int] = None,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> ProjectionMatrix:
    """The Gaussian projection of ``seed`` on ``device`` (default cuda); with
    ``intercept_index`` one more row passes the intercept through."""
    if projected_dim < 1 or original_dim < 1:
        raise ValueError("projection dims must be positive")
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((projected_dim, original_dim)) / projected_dim
    m = np.clip(m, -1.0, 1.0)
    if intercept_index is not None:
        passthrough = np.zeros((1, original_dim))
        passthrough[0, intercept_index] = 1.0
        m = np.concatenate([m, passthrough], axis=0)
    return ProjectionMatrix(matrix=torch.from_numpy(m.astype(np.float32)).to(
        resolve_device(device)))
