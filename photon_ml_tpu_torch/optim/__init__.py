"""Optimizers (counterpart of ``photon_ml_tpu/optim``): LBFGS with the
strong-Wolfe line search and the GLM adapter."""

from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import (
    CONVERGENCE_REASON_NAMES,
    BoxConstraints,
    Objective,
    SolveResult,
)
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve

__all__ = [
    "CONVERGENCE_REASON_NAMES",
    "BoxConstraints",
    "LBFGSConfig",
    "Objective",
    "SolveResult",
    "glm_adapter",
    "lbfgs_solve",
]
