"""OWL-QN (Orthant-Wise Limited-memory Quasi-Newton) for L1 / elastic-net
regularized objectives (Andrew & Gao 2007).

Counterpart of ``photon_ml_tpu/optim/owlqn.py``. The L1 term is handled by a
pseudo-gradient and an orthant-projected backtracking line search; the LBFGS
history is built from raw (smooth-part) gradients. The reference runs the
solve as one ``lax.while_loop``; here the loop runs on the host. The
orthant projection and the alignment with -pseudo stay elementwise on the
device (``torch.where``); the host fetches a few float32 scalars per
iteration (the direction's squared norm, one (value, decrease) pair per
backtracking trial, then the new value, pseudo-gradient norm and curvature
pair) and takes the reference's decisions in the same float32 arithmetic.
Each iteration is one fused value-and-gradient pass plus one margins pass
per trial. ``owlqn_solve_lanes`` solves a random-effect bucket, one OWLQN per
entity, with the state per lane and the host fetching one flag per
backtracking round and per iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.optim.common import (
    NOT_CONVERGED,
    BoxConstraints,
    Objective,
    SolveResult,
    any_lane,
    convergence_reason,
    convergence_reasons,
    fetch_f32,
    lane_tracks,
    project_or_identity,
    record_lanes,
)
from photon_ml_tpu_torch.optim.lbfgs import (
    LaneHistory,
    LBFGSConfig,
    first_step,
    two_loop_direction,
    update_history,
)
from photon_ml_tpu_torch.optim.linesearch import backtracking, backtracking_lanes

Tensor = torch.Tensor
F32 = np.float32


def pseudo_gradient(w: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """Sub-gradient of f(w) + l1*|w| used as OWL-QN's steepest-descent proxy."""
    right = g + l1  # derivative approaching from the positive side
    left = g - l1  # from the negative side
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0.0, right, torch.where(left > 0.0, left, zero))
    return torch.where(w > 0.0, right, torch.where(w < 0.0, left, at_zero))


def owlqn_solve(
    objective: Objective,
    w0: Tensor,
    l1_weight: Tensor | float,
    config: LBFGSConfig = LBFGSConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """Minimize f(w) + l1_weight * ||w||_1 from ``w0`` on ``device`` (default cuda).

    ``l1_weight`` is a scalar or a per-coefficient vector. The smooth part f
    comes from the adapter, which already holds any L2 term (elastic net =
    L2 in the objective + l1 here). ``SolveResult.grad`` is the
    pseudo-gradient.
    """
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    m, d = config.history, w0.shape[0]
    l1 = torch.as_tensor(l1_weight, dtype=torch.float32, device=dev).broadcast_to((d,))

    def l1_norm(w):
        return torch.sum(l1 * torch.abs(w))

    f, g = objective.value_and_grad(w0)
    F = f + l1_norm(w0)
    pg = pseudo_gradient(w0, g, l1)
    F_h, pgn_h = fetch_f32(F, torch.linalg.vector_norm(pg))
    anchor_f, anchor_gn = F_h, pgn_h

    values = np.full(config.max_iterations + 1, np.inf, np.float32)
    gnorms = np.full(config.max_iterations + 1, np.inf, np.float32)
    values[0], gnorms[0] = F_h, pgn_h

    S = torch.zeros((m, d), dtype=torch.float32, device=dev)
    Y = torch.zeros((m, d), dtype=torch.float32, device=dev)
    rho = torch.zeros((m,), dtype=torch.float32, device=dev)
    gamma = torch.ones((), dtype=torch.float32, device=dev)
    head = n_hist = it = 0
    reason = NOT_CONVERGED
    w = w0
    c1 = F32(config.c1)

    while reason == NOT_CONVERGED:
        v = -pg  # steepest descent direction on F
        p = -two_loop_direction(pg, S, Y, rho, head, n_hist, gamma)
        # orthant alignment: zero coordinates where p disagrees with -pseudo
        p = torch.where(p * v > 0.0, p, torch.zeros_like(p))
        (pp_h,) = fetch_f32(torch.dot(p, p))
        if pp_h <= 0.0:  # the alignment annihilated p: steepest descent
            p = v
        # orthant signs: sign(w) where nonzero, else the sign of -pseudo
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(v))

        def candidate(alpha):
            stepped = w + float(alpha) * p
            proj = torch.where(stepped * xi > 0.0, stepped, torch.zeros_like(stepped))
            return project_or_identity(constraints, proj)

        def trial(alpha):
            # Armijo on F via the pseudo-gradient: F(w_c) <= F(w) + c1 * pg.(w_c - w)
            w_c = candidate(alpha)
            value, decrease = fetch_f32(
                objective.value(w_c) + l1_norm(w_c), torch.dot(pg, w_c - w)
            )
            return value, bool(value <= F_h + c1 * decrease)

        if n_hist == 0:
            init_step = min(F32(1.0), F32(1.0) / max(pgn_h, F32(1e-12)))
        else:
            init_step = F32(1.0)
        alpha, _, failed = backtracking(trial, F_h, init_step=init_step,
                                        max_evals=config.max_ls_evals)

        w_new = candidate(alpha)
        f_new, g_new = objective.value_and_grad(w_new)
        F_new = f_new + l1_norm(w_new)
        pg_new = pseudo_gradient(w_new, g_new, l1)
        s_vec, y_vec = w_new - w, g_new - g
        sy, yy = torch.dot(s_vec, y_vec), torch.dot(y_vec, y_vec)
        F_new_h, pgn_new_h, sy_h, yy_h = fetch_f32(
            F_new, torch.linalg.vector_norm(pg_new), sy, yy
        )
        head, n_hist, gamma = update_history(
            S, Y, rho, head, n_hist, gamma, s_vec, y_vec, sy, yy, sy_h, yy_h,
            config.min_curvature,
        )
        it += 1
        reason = convergence_reason(
            it, F_new_h, F_h, pgn_new_h, anchor_f, anchor_gn,
            config.max_iterations, config.tolerance, failed,
        )
        if it < len(values):  # max_iterations=0 still runs one iteration
            values[it], gnorms[it] = F_new_h, pgn_new_h
        w, F, g, pg, F_h, pgn_h = w_new, F_new, g_new, pg_new, F_new_h, pgn_new_h

    return SolveResult(
        w=w,
        value=F,
        grad=pg,
        iterations=it,
        reason=reason,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(gnorms),
        data_passes=it + 1,
    )


def owlqn_solve_lanes(
    objective: Objective,
    w0: Tensor,
    l1_weight: Tensor | float,
    config: LBFGSConfig = LBFGSConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """``owlqn_solve`` for E independent problems from ``w0 [E, K]``, one
    OWLQN per lane (the reference's ``owlqn_solve`` under ``vmap`` over a
    random-effect bucket): per-lane pseudo-gradients, orthant projections,
    histories and backtracking searches (``backtracking_lanes``); a lane
    whose reason is set is frozen while the others go on. The host fetches
    one flag per backtracking round and one per iteration."""
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    if w0.dim() != 2:
        raise ValueError(f"owlqn_solve_lanes solves a bucket: w0 must be [E, K], got "
                         f"{tuple(w0.shape)}")
    n_lanes, d = w0.shape
    l1 = torch.as_tensor(l1_weight, dtype=torch.float32, device=dev).broadcast_to((n_lanes, d))

    def full_value(w, f):
        return f + torch.sum(l1 * torch.abs(w), dim=-1)

    f, g = objective.value_and_grad(w0)
    F = full_value(w0, f)
    pg = pseudo_gradient(w0, g, l1)
    pgn = torch.linalg.vector_norm(pg, dim=-1)
    anchor_f, anchor_gn = F, pgn
    values, gnorms = lane_tracks(F, pgn, config.max_iterations)
    hist = LaneHistory(n_lanes, config.history, d, dev)
    iteration = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    reason = torch.full_like(iteration, NOT_CONVERGED)
    w = w0

    k = 0
    while True:
        active = reason == NOT_CONVERGED
        v = -pg  # steepest descent direction on F
        p = -hist.direction(pg)
        # orthant alignment: zero coordinates where p disagrees with -pseudo
        p = torch.where(p * v > 0.0, p, torch.zeros_like(p))
        degenerate = torch.sum(p * p, dim=-1) <= 0.0
        p = torch.where(degenerate.unsqueeze(-1), v, p)
        # orthant signs: sign(w) where nonzero, else the sign of -pseudo
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(v))

        def candidate(alpha, w=w, p=p, xi=xi):
            stepped = w + alpha.unsqueeze(-1) * p
            proj = torch.where(stepped * xi > 0.0, stepped, torch.zeros_like(stepped))
            return project_or_identity(constraints, proj)

        def sufficient(alpha, value, w=w, F=F, pg=pg, candidate=candidate):
            # Armijo on F via the pseudo-gradient: F(w_c) <= F(w) + c1 * pg.(w_c - w)
            w_c = candidate(alpha)
            return value <= F + config.c1 * torch.sum(pg * (w_c - w), dim=-1)

        def trial_value(alpha, candidate=candidate):
            w_c = candidate(alpha)
            return full_value(w_c, objective.value(w_c))

        alpha, _, failed = backtracking_lanes(
            trial_value, F, sufficient, first_step(hist.n_hist, pgn), active,
            max_evals=config.max_ls_evals)
        w_new = candidate(alpha)
        f_new, g_new = objective.value_and_grad(w_new)
        F_new = full_value(w_new, f_new)
        pg_new = pseudo_gradient(w_new, g_new, l1)
        hist.update(w_new - w, g_new - g, active, config.min_curvature)
        pgn_new = torch.linalg.vector_norm(pg_new, dim=-1)
        it = iteration + 1
        reason_new = convergence_reasons(it, F_new, F, pgn_new, anchor_f, anchor_gn,
                                         config.max_iterations, config.tolerance, failed)
        k += 1
        record_lanes(values, gnorms, k, active, F_new, pgn_new)
        keep = active.unsqueeze(-1)
        w = torch.where(keep, w_new, w)
        g = torch.where(keep, g_new, g)
        pg = torch.where(keep, pg_new, pg)
        F = torch.where(active, F_new, F)
        pgn = torch.where(active, pgn_new, pgn)
        iteration = torch.where(active, it, iteration)
        reason = torch.where(active, reason_new, reason)
        if not any_lane(reason == NOT_CONVERGED):
            break

    return SolveResult(w=w, value=F, grad=pg, iterations=iteration, reason=reason,
                       values=values, grad_norms=gnorms, data_passes=iteration + 1)
