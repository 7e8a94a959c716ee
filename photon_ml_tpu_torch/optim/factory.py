"""Optimizer selection and regularization wiring.

Counterpart of ``photon_ml_tpu/optim/factory.py``: LBFGS handles NONE/L2,
OWLQN handles L1/ELASTIC_NET (l1 = alpha*lambda, l2 = (1-alpha)*lambda),
TRON handles NONE/L2 only and needs a twice-differentiable loss. NEWTON
(NONE/L2, twice differentiable) solves a bucket of per-entity problems with
explicit Hessians, in a box too; an adapter without them (the CSR and COO
layouts of one problem) is refused, never routed to another optimizer. A
bucket (``w0`` of shape ``[E, K]``) goes to the lane solvers, one problem
per entity, as the reference's ``vmap`` over a bucket.

``solve`` (:261-284) is the one-stop GLM solve: ``build_objective`` with the
L2 part of the configured regularization, the adapter, and
``dispatch_solve``. ``split_reg_weights`` splits a whole grid of weights.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.objective import GLMObjective, make_objective
from photon_ml_tpu_torch.optim.adapter import glm_adapter
from photon_ml_tpu_torch.optim.common import BoxConstraints, Objective, SolveResult
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve, lbfgs_solve_lanes
from photon_ml_tpu_torch.optim.newton import NewtonConfig, newton_solve
from photon_ml_tpu_torch.optim.owlqn import owlqn_solve, owlqn_solve_lanes
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve, tron_solve_lanes

Tensor = torch.Tensor

class OptimizerType(str, Enum):
    LBFGS = "lbfgs"
    TRON = "tron"
    NEWTON = "newton"


class RegularizationType(str, Enum):
    NONE = "none"
    L1 = "l1"
    L2 = "l2"
    ELASTIC_NET = "elastic_net"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits one regularization weight into (l1, l2) parts."""

    reg_type: RegularizationType = RegularizationType.NONE
    alpha: float = 1.0  # elastic net: l1 = alpha*w, l2 = (1-alpha)*w

    def __post_init__(self):
        if self.reg_type == RegularizationType.ELASTIC_NET and not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"elastic-net alpha must be in [0,1]: {self.alpha}")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * reg_weight
        return 0.0

    @property
    def uses_l1(self) -> bool:
        return self.reg_type in (RegularizationType.L1, RegularizationType.ELASTIC_NET)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer type, stopping rule, regularization and box constraints
    (``(feature_index, lower, upper)`` triples). ``train_glm`` solves each
    value of its ``lambdas`` and ignores ``regularization_weight``, the one
    weight of a GAME coordinate's solves; ``down_sampling_rate`` thins a
    fixed-effect coordinate's rows."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    regularization: RegularizationContext = RegularizationContext()
    regularization_weight: float = 0.0
    lbfgs_history: int = 10
    down_sampling_rate: float = 1.0
    box_constraints: Optional[tuple[tuple[int, float, float], ...]] = None

    def dense_box_bounds(self, num_features: int, sentinel: bool = False):
        """Validated dense numpy (lower, upper) bounds, or None. With
        ``sentinel`` the arrays carry one more, unbounded, trailing slot: the
        one a projected space's padding id (``num_features``) gathers."""
        if not self.box_constraints:
            return None
        size = num_features + (1 if sentinel else 0)
        lower = np.full(size, -np.inf, np.float32)
        upper = np.full(size, np.inf, np.float32)
        for idx, lo, hi in self.box_constraints:
            if not 0 <= idx < num_features:
                raise ValueError(
                    f"box constraint index {idx} out of range [0, {num_features})"
                )
            if lo > hi:
                raise ValueError(f"box constraint [{lo}, {hi}] is empty")
            lower[idx], upper[idx] = lo, hi
        return lower, upper

    def build_box_constraints(
        self, num_features: int, device: torch.device
    ) -> Optional[BoxConstraints]:
        bounds = self.dense_box_bounds(num_features)
        if bounds is None:
            return None
        lower, upper = bounds
        return BoxConstraints(
            lower=torch.from_numpy(lower).to(device),
            upper=torch.from_numpy(upper).to(device),
        )

    def validate(self, loss_name: str) -> None:
        """Refuse what the reference refuses: TRON/NEWTON with L1 or
        elastic net, or with a loss that is not twice differentiable."""
        if self.optimizer_type in (OptimizerType.TRON, OptimizerType.NEWTON):
            name = self.optimizer_type.value.upper()
            if self.regularization.uses_l1:
                raise ValueError(
                    f"{name} does not support L1/elastic-net regularization "
                    "(OptimizerFactory parity)"
                )
            if not get_loss(loss_name).has_hessian:
                raise ValueError(
                    f"{name} requires a twice-differentiable loss; "
                    f"'{loss_name}' is not (use LBFGS/OWLQN)"
                )


def split_reg_weights(reg: RegularizationContext, weights) -> tuple[Tensor, Tensor]:
    """The (l2, l1) split of a grid of weights as two float32 [G] tensors
    (a NONE regularization gives zeros of the grid's shape)."""
    lams = torch.as_tensor(weights, dtype=torch.float32)
    return (torch.broadcast_to(torch.as_tensor(reg.l2_weight(lams), dtype=torch.float32),
                               lams.shape),
            torch.broadcast_to(torch.as_tensor(reg.l1_weight(lams), dtype=torch.float32),
                               lams.shape))


def build_objective(
    loss_name: str,
    config: OptimizerConfig,
    factors: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
) -> GLMObjective:
    """The GLM objective with the L2 part of the configured regularization."""
    return make_objective(loss_name,
                          l2_weight=config.regularization.l2_weight(config.regularization_weight),
                          factors=factors, shifts=shifts)


def dispatch_solve(
    adapter: Objective,
    w0: Tensor,
    config: OptimizerConfig,
    l1: float = 0.0,
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """Route a prebuilt adapter to the configured optimizer: NEWTON (a
    bucket's batched solve), TRON, OWLQN (L1/elastic net, with weight
    ``l1``) or LBFGS. A ``w0`` of shape ``[E, K]`` is a bucket over a lane
    adapter, solved by the lane solvers, one problem per entity."""
    lanes = w0.dim() == 2
    if config.optimizer_type == OptimizerType.NEWTON:
        if adapter.hessian is None:
            raise ValueError(
                "NEWTON needs a dense-Hessian adapter (a bucket of per-entity problems; "
                "the CSR and COO layouts of one problem cannot densify)"
            )
        ncfg = NewtonConfig(max_iterations=config.max_iterations, tolerance=config.tolerance)
        return newton_solve(adapter.value_and_grad, adapter.hessian, w0, adapter.ls_prepare,
                            adapter.ls_eval, ncfg, device=device, constraints=constraints,
                            value=adapter.value)
    if config.optimizer_type == OptimizerType.TRON:
        tcfg = TRONConfig(max_iterations=config.max_iterations, tolerance=config.tolerance)
        tron = tron_solve_lanes if lanes else tron_solve
        return tron(adapter, w0, tcfg, constraints=constraints, device=device)
    lcfg = LBFGSConfig(
        max_iterations=config.max_iterations,
        tolerance=config.tolerance,
        history=config.lbfgs_history,
    )
    if config.regularization.uses_l1:
        owlqn = owlqn_solve_lanes if lanes else owlqn_solve
        return owlqn(adapter, w0, l1, lcfg, constraints=constraints, device=device)
    lbfgs = lbfgs_solve_lanes if lanes else lbfgs_solve
    return lbfgs(adapter, w0, lcfg, constraints=constraints, device=device)


def solve(
    loss_name: str,
    batch,
    config: OptimizerConfig,
    w0: Tensor,
    constraints: Optional[BoxConstraints] = None,
    factors: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """One GLM solve on ``device`` (default cuda): the objective of
    ``config`` (with normalization ``factors`` and ``shifts``), its adapter
    over ``batch`` and the configured optimizer. Without ``constraints`` the
    config's box constraints apply."""
    config.validate(loss_name)
    obj = build_objective(loss_name, config, factors=factors, shifts=shifts)
    if constraints is None and config.box_constraints:
        constraints = config.build_box_constraints(batch.num_features, w0.device)
    return dispatch_solve(glm_adapter(obj, batch), w0, config,
                          config.regularization.l1_weight(config.regularization_weight),
                          constraints, device=device)
