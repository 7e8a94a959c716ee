"""Shared optimizer machinery: the objective adapter type, convergence
semantics, box constraints and the result type.

Counterpart of ``photon_ml_tpu/optim/common.py``. The reference runs its
loops on the device and decides convergence with ``jnp.where``; the port
drives its loops from the host, so ``convergence_reason`` takes host
float32 scalars and mirrors the reference's float32 arithmetic.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry

Tensor = torch.Tensor

NOT_CONVERGED = 0
MAX_ITERATIONS = 1
OBJECTIVE_NOT_IMPROVING = 2
FUNCTION_VALUES_CONVERGED = 3
GRADIENT_CONVERGED = 4

CONVERGENCE_REASON_NAMES = {
    NOT_CONVERGED: "NotConverged",
    MAX_ITERATIONS: "MaxIterations",
    OBJECTIVE_NOT_IMPROVING: "ObjectiveNotImproving",
    FUNCTION_VALUES_CONVERGED: "FunctionValuesConverged",
    GRADIENT_CONVERGED: "GradientConverged",
}


class Objective(NamedTuple):
    """The adapter the optimizers drive (see the reference's docstring).

    ``ls_eval(carry, alpha)`` returns ``(phi, dphi)`` as 0-d device tensors.
    The margin-carrying protocol (``margins``, ``ls_prepare_z``,
    ``ls_advance``, ``value_and_grad_at``, ``dir_margins``) lets LBFGS keep
    z = X'w in its state: one gather + one scatter per iteration. TRON uses
    the second-order fields: ``hvp(w, v)`` (a fused Hessian-vector pass),
    and on the margin-carrying path ``curvature(z)`` once per outer step and
    ``hvp_at(d2, v)`` per CG step. They are None for a loss without a
    Hessian. The reference's dense ``hessian`` comes with Newton.
    """

    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]]
    value: Callable[[Tensor], Tensor]
    ls_prepare: Callable[[Tensor, Tensor], Any]
    ls_eval: Callable[[Any, float], tuple[Tensor, Tensor]]
    margins: Optional[Callable[[Tensor], Tensor]] = None
    ls_prepare_z: Optional[Callable[[Tensor, Tensor, Tensor], Any]] = None
    ls_advance: Optional[Callable[[Any, float], Tensor]] = None
    value_and_grad_at: Optional[Callable[[Tensor, Tensor], tuple[Tensor, Tensor]]] = None
    dir_margins: Optional[Callable[[Tensor], Tensor]] = None
    hvp: Optional[Callable[[Tensor, Tensor], Tensor]] = None
    curvature: Optional[Callable[[Tensor], Tensor]] = None
    hvp_at: Optional[Callable[[Tensor, Tensor], Tensor]] = None


class BoxConstraints(NamedTuple):
    """Per-coefficient box [lower, upper]; +-inf entries are unconstrained."""

    lower: Tensor
    upper: Tensor

    def project(self, w: Tensor) -> Tensor:
        return torch.clamp(w, self.lower, self.upper)


def project_or_identity(constraints: Optional[BoxConstraints], w: Tensor) -> Tensor:
    return w if constraints is None else constraints.project(w)


class SolveResult(NamedTuple):
    """Terminal optimizer state plus per-iteration tracking buffers.

    ``values``/``grad_norms`` have max_iterations + 1 entries, valid up to
    ``iterations`` inclusive and +inf after. ``data_passes`` counts full
    passes over the data: the init evaluation plus one per LBFGS/OWLQN
    iteration, or per TRON step the CG Hessian-vector passes (at least one)
    and the trial evaluation.
    """

    w: Tensor
    value: Tensor
    grad: Tensor
    iterations: int
    reason: int
    values: Tensor
    grad_norms: Tensor
    data_passes: int = 0


def fetch_f32(*scalars: Tensor) -> tuple[np.float32, ...]:
    """Bring 0-d device tensors to the host in one sync, as float32 scalars.

    The host-driven loops call this once per line-search trial, twice per
    LBFGS/OWLQN iteration and once per TRON CG step and step; ``host_syncs``
    counts the calls.
    """
    telemetry.counter("host_syncs").inc()
    arr = torch.stack([s.reshape(()) for s in scalars]).to(torch.float32).cpu().numpy()
    return tuple(np.float32(x) for x in arr)


def convergence_reason(
    iteration: int,
    value: np.float32,
    prev_value: np.float32,
    grad_norm: np.float32,
    init_value: np.float32,
    init_grad_norm: np.float32,
    max_iterations: int,
    tolerance: float,
    ls_failed: bool,
) -> int:
    """Reference-parity convergence decision, in float32 on the host."""
    tol = np.float32(tolerance)
    if iteration >= max_iterations:
        return MAX_ITERATIONS
    if ls_failed:
        return OBJECTIVE_NOT_IMPROVING
    if np.abs(np.float32(value - prev_value)) <= np.float32(tol * np.abs(init_value)):
        return FUNCTION_VALUES_CONVERGED
    if grad_norm <= np.float32(tol * init_grad_norm):
        return GRADIENT_CONVERGED
    return NOT_CONVERGED
