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
    convergence_reason,
    fetch_f32,
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
