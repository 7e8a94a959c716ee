"""Optimizers (counterpart of ``photon_ml_tpu/optim``): LBFGS with the
strong-Wolfe line search, OWLQN with the backtracking search, TRON, and the
GLM adapter."""

from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import (
    CONVERGENCE_REASON_NAMES,
    BoxConstraints,
    Objective,
    SolveResult,
)
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.owlqn import owlqn_solve, pseudo_gradient
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve

__all__ = [
    "CONVERGENCE_REASON_NAMES",
    "BoxConstraints",
    "LBFGSConfig",
    "Objective",
    "SolveResult",
    "TRONConfig",
    "glm_adapter",
    "lbfgs_solve",
    "owlqn_solve",
    "pseudo_gradient",
    "tron_solve",
]
