"""Optimizer selection and regularization wiring.

Counterpart of ``photon_ml_tpu/optim/factory.py``: LBFGS handles NONE/L2,
OWLQN handles L1/ELASTIC_NET (l1 = alpha*lambda, l2 = (1-alpha)*lambda),
TRON handles NONE/L2 only and needs a twice-differentiable loss. NEWTON
(NONE/L2, twice differentiable) solves a bucket of dense per-entity problems
with explicit Hessians; an adapter without them (the CSR and COO layouts)
is refused, never routed to another optimizer.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.optim.common import BoxConstraints, Objective, SolveResult
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.newton import NewtonConfig, newton_solve
from photon_ml_tpu_torch.optim.owlqn import owlqn_solve
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve

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

    def dense_box_bounds(self, num_features: int):
        """Validated dense numpy (lower, upper) bounds, or None."""
        if not self.box_constraints:
            return None
        lower = np.full(num_features, -np.inf, np.float32)
        upper = np.full(num_features, np.inf, np.float32)
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
    ``l1``) or LBFGS."""
    if config.optimizer_type == OptimizerType.NEWTON:
        if adapter.hessian is None:
            raise ValueError(
                "NEWTON needs a dense-Hessian adapter (a DenseBatch bucket; the CSR "
                "and COO layouts cannot densify)"
            )
        if constraints is not None:
            raise NotImplementedError(
                "NEWTON with box constraints is not ported to photon_ml_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 8)"
            )
        ncfg = NewtonConfig(max_iterations=config.max_iterations, tolerance=config.tolerance)
        return newton_solve(adapter.value_and_grad, adapter.hessian, w0, adapter.ls_prepare,
                            adapter.ls_eval, ncfg, device=device)
    if config.optimizer_type == OptimizerType.TRON:
        tcfg = TRONConfig(max_iterations=config.max_iterations, tolerance=config.tolerance)
        return tron_solve(adapter, w0, tcfg, constraints=constraints, device=device)
    lcfg = LBFGSConfig(
        max_iterations=config.max_iterations,
        tolerance=config.tolerance,
        history=config.lbfgs_history,
    )
    if config.regularization.uses_l1:
        return owlqn_solve(adapter, w0, l1, lcfg, constraints=constraints, device=device)
    return lbfgs_solve(adapter, w0, lcfg, constraints=constraints, device=device)
