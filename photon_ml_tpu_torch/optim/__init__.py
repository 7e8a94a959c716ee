"""Optimizers (counterpart of ``photon_ml_tpu/optim``): LBFGS with the
strong-Wolfe line search, OWLQN with the backtracking search, TRON, the
batched Newton of random-effect buckets, the lane solvers (LBFGS, OWLQN and
TRON for every entity of a bucket at once), the GLM adapter, and the
coordinate-descent guard's ``GuardSpec``."""

from photon_ml_tpu_torch.optim.adapter import glm_adapter, lane_adapter
from photon_ml_tpu_torch.optim.common import (
    CONVERGENCE_REASON_NAMES,
    BoxConstraints,
    Objective,
    SolveResult,
)
from photon_ml_tpu_torch.optim.guard import GuardSpec
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve, lbfgs_solve_lanes
from photon_ml_tpu_torch.optim.newton import NewtonConfig, newton_solve
from photon_ml_tpu_torch.optim.owlqn import owlqn_solve, owlqn_solve_lanes, pseudo_gradient
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve, tron_solve_lanes

__all__ = [
    "CONVERGENCE_REASON_NAMES",
    "BoxConstraints",
    "GuardSpec",
    "LBFGSConfig",
    "NewtonConfig",
    "Objective",
    "SolveResult",
    "TRONConfig",
    "glm_adapter",
    "lane_adapter",
    "lbfgs_solve",
    "lbfgs_solve_lanes",
    "newton_solve",
    "owlqn_solve",
    "owlqn_solve_lanes",
    "pseudo_gradient",
    "tron_solve",
    "tron_solve_lanes",
]
