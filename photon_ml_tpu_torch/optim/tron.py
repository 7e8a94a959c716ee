"""TRON: trust-region Newton method with a truncated conjugate-gradient inner
solver (LIBLINEAR's algorithm; Lin & More, Hsia et al.).

Counterpart of ``photon_ml_tpu/optim/tron.py``, with its constants and
counting: (eta0, eta1, eta2) = (1e-4, 0.25, 0.75), (sigma1, sigma2, sigma3) =
(0.25, 0.5, 4.0), initial radius ||g0||, CG to ||r|| <= 0.1*||g|| in at most
20 steps with the boundary step of eq. (13), up to 5 improvement failures a
step, and the iteration advancing only on improvement.

The reference runs both loops as ``lax.while_loop``s; here they run on the
host. Vectors stay on the device. Each CG step computes its candidate step,
residual and the boundary terms on the device and fetches their scalars in
one ``fetch_f32``; each outer step fetches its trial scalars in one more.
The host takes every decision the reference takes with ``jnp.where``, in the
same float32 arithmetic.

Two paths, as in the reference:
  - margin-carrying (no box constraints): z = X'w is carried; the row
    curvature d2 = wgt*l''(z) is computed once per outer step and each CG
    step is one ``hvp_at`` pass; the trial point advances z by X'step;
  - box-constrained: each CG step is one fused ``hvp`` pass at w, each
    trial one fused value-and-gradient pass, and the accepted point is
    projected into the box.

``tron_solve_lanes`` solves a random-effect bucket, one TRON per entity:
radius, failures, iterations and the truncated CG are per lane, and the
host fetches one flag per CG step and per outer step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.optim.common import (
    NOT_CONVERGED,
    OBJECTIVE_NOT_IMPROVING,
    BoxConstraints,
    Objective,
    SolveResult,
    any_lane,
    convergence_reason,
    convergence_reasons,
    fetch_f32,
    lane_tracks,
    project_or_identity,
)

Tensor = torch.Tensor
F32 = np.float32


@dataclasses.dataclass(frozen=True)
class TRONConfig:
    max_iterations: int = 15
    tolerance: float = 1e-5
    max_cg_iterations: int = 20
    cg_tolerance_factor: float = 0.1  # CG stops at ||r|| <= factor * ||g||
    max_improvement_failures: int = 5
    eta0: float = 1e-4
    eta1: float = 0.25
    eta2: float = 0.75
    sigma1: float = 0.25
    sigma2: float = 0.5
    sigma3: float = 4.0


def _safe(x: Tensor) -> Tensor:
    """x, or 1 where x is 0 (the reference's guarded denominators)."""
    return torch.where(x != 0.0, x, torch.ones_like(x))


def _truncated_cg(
    hvp: Callable[[Tensor], Tensor],
    gradient: Tensor,
    grad_norm: np.float32,
    delta: np.float32,
    config: TRONConfig,
) -> tuple[int, Tensor, Tensor]:
    """Solve H step = -gradient approximately within ||step|| <= delta.

    Returns (cg_iterations, step, residual), as the reference's
    ``_truncated_cg`` (TRON.scala:280-341). One Hessian-vector pass and one
    host fetch per CG step.
    """
    tol = F32(config.cg_tolerance_factor) * grad_norm
    step = torch.zeros_like(gradient)
    residual = -gradient
    direction = residual
    rtr = torch.dot(residual, residual)
    r_norm = grad_norm  # ||-g|| = ||g||
    dsq = delta * delta
    its = 0
    while its < config.max_cg_iterations and not r_norm <= tol:
        hd = hvp(direction)
        dhd = torch.dot(direction, hd)
        alpha = rtr / _safe(dhd)
        step_try = step + alpha * direction
        r_try = residual - alpha * hd
        rtr_try = torch.dot(r_try, r_try)
        step_norm, std, sts, dtd, r_norm_try = fetch_f32(
            torch.linalg.vector_norm(step_try),
            torch.dot(step, direction),
            torch.dot(step, step),
            torch.dot(direction, direction),
            torch.linalg.vector_norm(r_try),
        )
        its += 1
        if step_norm > delta:
            # boundary case: solve ||step + alpha*d|| = delta (eq. 13)
            rad = np.sqrt(max(std * std + dtd * (dsq - sts), F32(0.0)))
            if std >= 0.0:
                den = std + rad
                alpha_b = (dsq - sts) / (den if den != 0.0 else F32(1.0))
            else:
                alpha_b = (rad - std) / (dtd if dtd != 0.0 else F32(1.0))
            alpha_b = F32(alpha_b)
            step = step + float(alpha_b) * direction
            residual = residual - float(alpha_b) * hd
            break
        beta = rtr_try / _safe(rtr)
        step, residual, rtr, r_norm = step_try, r_try, rtr_try, r_norm_try
        direction = r_try + beta * direction
    return its, step, residual


def tron_solve(
    objective: Objective,
    w0: Tensor,
    config: TRONConfig = TRONConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """Minimize a twice-differentiable objective (needs ``objective.hvp``)
    from ``w0`` on ``device`` (default cuda)."""
    if objective.hvp is None:
        raise ValueError("TRON requires an objective with a Hessian-vector product")
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    # Projection breaks the linearity of z in w, so box-constrained solves
    # take the fused Hessian-vector path.
    use_z = (
        constraints is None
        and objective.margins is not None
        and objective.dir_margins is not None
        and objective.curvature is not None
        and objective.hvp_at is not None
        and objective.value_and_grad_at is not None
    )
    if use_z:
        z = objective.margins(w0)
        f, g = objective.value_and_grad_at(w0, z)
    else:
        z = None
        f, g = objective.value_and_grad(w0)
    f_h, gn_h = fetch_f32(f, torch.linalg.vector_norm(g))
    anchor_f, anchor_gn = f_h, gn_h

    values = np.full(config.max_iterations + 1, np.inf, np.float32)
    gnorms = np.full(config.max_iterations + 1, np.inf, np.float32)
    values[0], gnorms[0] = f_h, gn_h

    eta0, eta1, eta2 = F32(config.eta0), F32(config.eta1), F32(config.eta2)
    sigma1, sigma2, sigma3 = F32(config.sigma1), F32(config.sigma2), F32(config.sigma3)
    w = w0
    delta = gn_h
    it = failures = 0
    passes = 1  # the init value_and_grad evaluation
    reason = NOT_CONVERGED

    while reason == NOT_CONVERGED:
        if use_z:
            d2 = objective.curvature(z)  # fixed across the CG solve
            hvp = lambda v: objective.hvp_at(d2, v)  # noqa: E731
        else:
            hvp = lambda v, w=w: objective.hvp(w, v)  # noqa: E731
        cg_its, step, residual = _truncated_cg(hvp, g, gn_h, delta, config)

        w_try = w + step
        if use_z:
            z_try = z + objective.dir_margins(step)
            f_try, g_try = objective.value_and_grad_at(w_try, z_try)
        else:
            z_try = None
            f_try, g_try = objective.value_and_grad(w_try)
        gs, sr, f_try_h, step_norm, gn_try_h = fetch_f32(
            torch.dot(g, step),
            torch.dot(step, residual),
            f_try,
            torch.linalg.vector_norm(step),
            torch.linalg.vector_norm(g_try),
        )
        predicted = F32(-0.5) * (gs - sr)
        actual = f_h - f_try_h

        # first-iteration adjustment of the initial step bound
        if it == 0:
            delta = min(delta, step_norm)

        denom = f_try_h - f_h - gs
        if denom <= 0.0:
            alpha = sigma3
        else:
            alpha = max(sigma1, F32(-0.5) * (gs / denom))

        # trust-region radius update (TRON.scala:205-218)
        a_s = alpha * step_norm
        if actual < eta0 * predicted:
            delta = min(max(alpha, sigma1) * step_norm, sigma2 * delta)
        elif actual < eta1 * predicted:
            delta = max(sigma1 * delta, min(a_s, sigma2 * delta))
        elif actual < eta2 * predicted:
            delta = max(sigma1 * delta, min(a_s, sigma3 * delta))
        else:
            delta = max(delta, min(a_s, sigma3 * delta))
        delta = F32(delta)

        # each CG step is one Hv data pass, plus this step's trial-point
        # value_and_grad (CG counted as 1 when the radius truncated it at once)
        passes += max(cg_its, 1) + 1
        if actual > eta0 * predicted:  # improved
            it += 1
            failures = 0
            reason = convergence_reason(
                it, f_try_h, f_h, gn_try_h, anchor_f, anchor_gn,
                config.max_iterations, config.tolerance, False,
            )
            if it < len(values):
                values[it], gnorms[it] = f_try_h, gn_try_h
            w = project_or_identity(constraints, w_try)
            f, g, z, f_h, gn_h = f_try, g_try, z_try, f_try_h, gn_try_h
        else:
            failures += 1
            if failures >= config.max_improvement_failures:
                reason = OBJECTIVE_NOT_IMPROVING

    return SolveResult(
        w=w,
        value=f,
        grad=g,
        iterations=it,
        reason=reason,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(gnorms),
        data_passes=passes,
    )


# -- the lane solver: one TRON per entity of a random-effect bucket ----------


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _truncated_cg_lanes(
    hvp: Callable[[Tensor], Tensor],
    gradient: Tensor,
    grad_norm: Tensor,
    delta: Tensor,
    active: Tensor,
    config: TRONConfig,
) -> tuple[Tensor, Tensor, Tensor]:
    """``_truncated_cg`` for every lane at once: the state (step, residual,
    direction, r.r, CG step count) is per lane, each round is one batched
    Hessian-vector pass, and a lane whose CG has stopped (its residual under
    the tolerance, the trust region reached, the step limit, or not
    ``active``) is frozen while the others go on; the host fetches one flag
    per round. Returns (cg_iterations [E], step, residual), as the
    reference's ``_truncated_cg`` under ``vmap``."""
    tol = config.cg_tolerance_factor * grad_norm
    step = torch.zeros_like(gradient)
    residual = -gradient
    direction = residual
    rtr = _dot(residual, residual)
    its = torch.zeros(gradient.shape[0], dtype=torch.int32, device=gradient.device)
    done = ~active
    dsq = delta * delta
    while True:
        running = ~done & (its < config.max_cg_iterations)
        converged = torch.linalg.vector_norm(residual, dim=-1) <= tol
        hd = hvp(direction)
        alpha = rtr / _safe(_dot(direction, hd))
        outside = torch.linalg.vector_norm(step + alpha.unsqueeze(-1) * direction,
                                           dim=-1) > delta
        # boundary case: solve ||step + alpha*d|| = delta (eq. 13)
        std, sts, dtd = _dot(step, direction), _dot(step, step), _dot(direction, direction)
        rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
        alpha_b = torch.where(std >= 0.0, (dsq - sts) / _safe(std + rad),
                              (rad - std) / _safe(dtd))
        alpha = torch.where(outside, alpha_b, alpha).unsqueeze(-1)
        new_residual = residual - alpha * hd
        new_rtr = _dot(new_residual, new_residual)
        beta = (new_rtr / _safe(rtr)).unsqueeze(-1)
        new_direction = torch.where(outside.unsqueeze(-1), direction,
                                    new_residual + beta * direction)
        adv = running & ~converged
        keep = adv.unsqueeze(-1)
        step = torch.where(keep, step + alpha * direction, step)
        residual = torch.where(keep, new_residual, residual)
        direction = torch.where(keep, new_direction, direction)
        rtr = torch.where(adv, new_rtr, rtr)
        its = torch.where(adv, its + 1, its)
        done = torch.where(running, converged | outside, done)
        if not any_lane(~done & (its < config.max_cg_iterations)):
            break
    return its, step, residual


def tron_solve_lanes(
    objective: Objective,
    w0: Tensor,
    config: TRONConfig = TRONConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """``tron_solve`` for E independent problems from ``w0 [E, K]``, one
    TRON per lane (the reference's ``tron_solve`` under ``vmap`` over a
    random-effect bucket). The trust-region radius, the improvement
    failures, the iteration (which advances only on improvement) and the
    data passes are per lane, and so is the truncated CG
    (``_truncated_cg_lanes``); a lane whose reason is set is frozen while
    the others go on. The two paths of ``tron_solve`` carry over: margins
    carried with one ``hvp_at`` pass per CG step, or, in a box, one fused
    ``hvp`` pass per CG step and the accepted point projected per lane.
    The host fetches one flag per CG step and one per outer step."""
    if objective.hvp is None:
        raise ValueError("TRON requires an objective with a Hessian-vector product")
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    if w0.dim() != 2:
        raise ValueError(f"tron_solve_lanes solves a bucket: w0 must be [E, K], got "
                         f"{tuple(w0.shape)}")
    n_lanes = w0.shape[0]
    use_z = (
        constraints is None
        and objective.margins is not None
        and objective.dir_margins is not None
        and objective.curvature is not None
        and objective.hvp_at is not None
        and objective.value_and_grad_at is not None
    )
    if use_z:
        z = objective.margins(w0)
        f, g = objective.value_and_grad_at(w0, z)
    else:
        z = None
        f, g = objective.value_and_grad(w0)
    gn = torch.linalg.vector_norm(g, dim=-1)
    anchor_f, anchor_gn = f, gn
    values, gnorms = lane_tracks(f, gn, config.max_iterations)
    lanes = torch.arange(n_lanes, device=dev)
    w = w0
    delta = gn
    iteration = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    failures = torch.zeros_like(iteration)
    passes = torch.ones_like(iteration)  # the init value_and_grad evaluation
    reason = torch.full_like(iteration, NOT_CONVERGED)
    never = torch.zeros(n_lanes, dtype=torch.bool, device=dev)

    while True:
        active = reason == NOT_CONVERGED
        if use_z:
            d2 = objective.curvature(z)  # fixed across the CG solve
            hvp = lambda v: objective.hvp_at(d2, v)  # noqa: E731
        else:
            hvp = lambda v, w=w: objective.hvp(w, v)  # noqa: E731
        cg_its, step, residual = _truncated_cg_lanes(hvp, g, gn, delta, active, config)

        w_try = w + step
        if use_z:
            z_try = z + objective.dir_margins(step)
            f_try, g_try = objective.value_and_grad_at(w_try, z_try)
        else:
            f_try, g_try = objective.value_and_grad(w_try)
        gs = _dot(g, step)
        predicted = -0.5 * (gs - _dot(step, residual))
        actual = f - f_try
        step_norm = torch.linalg.vector_norm(step, dim=-1)

        # first-iteration adjustment of the initial step bound
        delta_0 = torch.where(iteration == 0, torch.minimum(delta, step_norm), delta)
        denom = f_try - f - gs
        alpha = torch.where(denom <= 0.0, torch.full_like(denom, config.sigma3),
                            torch.clamp(-0.5 * (gs / _safe(denom)), min=config.sigma1))
        # trust-region radius update (TRON.scala:205-218)
        a_s = alpha * step_norm
        delta_new = torch.where(
            actual < config.eta0 * predicted,
            torch.minimum(torch.clamp(alpha, min=config.sigma1) * step_norm,
                          config.sigma2 * delta_0),
            torch.where(
                actual < config.eta1 * predicted,
                torch.maximum(config.sigma1 * delta_0,
                              torch.minimum(a_s, config.sigma2 * delta_0)),
                torch.where(
                    actual < config.eta2 * predicted,
                    torch.maximum(config.sigma1 * delta_0,
                                  torch.minimum(a_s, config.sigma3 * delta_0)),
                    torch.maximum(delta_0, torch.minimum(a_s, config.sigma3 * delta_0)),
                ),
            ),
        )
        improved = actual > config.eta0 * predicted
        it = torch.where(improved, iteration + 1, iteration)
        failures_new = torch.where(improved, 0, failures + 1)
        gave_up = ~improved & (failures_new >= config.max_improvement_failures)
        gn_try = torch.linalg.vector_norm(g_try, dim=-1)
        reason_new = torch.where(
            improved,
            convergence_reasons(it, f_try, f, gn_try, anchor_f, anchor_gn,
                                config.max_iterations, config.tolerance, never),
            torch.where(gave_up, OBJECTIVE_NOT_IMPROVING, NOT_CONVERGED),
        ).to(torch.int32)

        # each CG step is one Hv data pass, plus this step's trial-point
        # value_and_grad (CG counted as 1 when the radius truncated it at once)
        passes = torch.where(active, passes + torch.clamp(cg_its, min=1) + 1, passes)
        accepted = active & improved
        slot = torch.clamp(it.long(), max=values.shape[1] - 1)
        tracked = accepted & (it < values.shape[1])
        values[lanes, slot] = torch.where(tracked, f_try, values[lanes, slot])
        gnorms[lanes, slot] = torch.where(tracked, gn_try, gnorms[lanes, slot])
        keep = accepted.unsqueeze(-1)
        w = torch.where(keep, project_or_identity(constraints, w_try), w)
        g = torch.where(keep, g_try, g)
        if use_z:
            z = torch.where(keep, z_try, z)
        f = torch.where(accepted, f_try, f)
        gn = torch.where(accepted, gn_try, gn)
        delta = torch.where(active, delta_new, delta)
        iteration = torch.where(active, it, iteration)
        failures = torch.where(active, failures_new, failures)
        reason = torch.where(active, reason_new, reason)
        if not any_lane(reason == NOT_CONVERGED):
            break

    return SolveResult(w=w, value=f, grad=g, iterations=iteration, reason=reason,
                       values=values, grad_norms=gnorms, data_passes=passes)
