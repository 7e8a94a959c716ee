"""Shared optimizer machinery: the objective adapter type, convergence
semantics, box constraints and the result type.

Counterpart of ``photon_ml_tpu/optim/common.py``. The reference runs its
loops on the device and decides convergence with ``jnp.where``; the port
drives its single-problem loops from the host, so ``convergence_reason``
takes host float32 scalars and mirrors the reference's float32
arithmetic, while the lane solvers of a bucket decide every lane on the
device with ``convergence_reasons`` and fetch one flag per round
(``any_lane``).
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
    Hessian. Newton uses ``hessian(w)``, the explicit ``[E, K, K]``
    Hessians of a bucket (None for the layouts of one problem). Over a
    bucket (``lane_adapter``) every field is per lane: ``ls_eval(carry,
    alphas)`` takes step sizes ``[A]`` shared by the lanes or ``[E, A]``,
    one row per lane, and returns ``(phi, dphi)`` as ``[E, A]``;
    ``ls_advance(carry, alpha)`` takes one step size per lane ``[E]``.
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
    hessian: Optional[Callable[[Tensor], Tensor]] = None


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


def any_lane(flags: Tensor) -> bool:
    """One host fetch for a bucket's lanes: is any flag set? The lane
    solvers call it once per iteration, line-search round or CG step."""
    (n,) = fetch_f32(flags.any())
    return bool(n > 0.0)


def convergence_reasons(
    iteration: Tensor,
    value: Tensor,
    prev_value: Tensor,
    grad_norm: Tensor,
    init_value: Tensor,
    init_grad_norm: Tensor,
    max_iterations: int,
    tolerance: float,
    ls_failed: Tensor,
) -> Tensor:
    """``convergence_reason`` on device tensors, one reason per lane (int32),
    for the batched solves (``photon_ml_tpu/optim/common.py:146-174``)."""
    tol = torch.tensor(tolerance, dtype=value.dtype, device=value.device)
    reason = torch.full_like(iteration, NOT_CONVERGED, dtype=torch.int32)
    reason = torch.where(grad_norm <= tol * init_grad_norm, GRADIENT_CONVERGED, reason)
    reason = torch.where(torch.abs(value - prev_value) <= tol * torch.abs(init_value),
                         FUNCTION_VALUES_CONVERGED, reason)
    reason = torch.where(ls_failed, OBJECTIVE_NOT_IMPROVING, reason)
    return torch.where(iteration >= max_iterations, MAX_ITERATIONS, reason).to(torch.int32)


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


def lane_tracks(f: Tensor, gn: Tensor, max_iterations: int) -> tuple[Tensor, Tensor]:
    """The per-lane ``values`` and ``grad_norms`` buffers [E, max_iterations
    + 1], +inf but for the initial entry."""
    values = torch.full((f.shape[0], max_iterations + 1), float("inf"), dtype=f.dtype,
                        device=f.device)
    gnorms = torch.full_like(values, float("inf"))
    values[:, 0], gnorms[:, 0] = f, gn
    return values, gnorms


def record_lanes(values: Tensor, gnorms: Tensor, k: int, active: Tensor, f: Tensor,
                 gn: Tensor) -> None:
    """Write iteration ``k``'s value and gradient norm of the active lanes
    (every active lane of LBFGS and OWLQN is at iteration k)."""
    if k < values.shape[1]:  # max_iterations=0 still runs one iteration
        values[:, k] = torch.where(active, f, values[:, k])
        gnorms[:, k] = torch.where(active, gn, gnorms[:, k])
