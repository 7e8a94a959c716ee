"""L-BFGS with the margin-carrying fast path.

Counterpart of ``photon_ml_tpu/optim/lbfgs.py``. The reference runs the
whole solve as one ``lax.while_loop`` on the device. Here the loop runs on
the host: vectors and the history stay on the device, and the host fetches
a few float32 scalars per iteration (the direction's slope, then the new
value, gradient norm and curvature pair) plus one (phi, dphi) pair per
line-search trial, and takes every decision the reference takes with
``jnp.where``, in the same float32 arithmetic. The loop stops at the first
convergence reason (the reference's freeze-on-converged exists only for
``vmap`` lanes). The history is updated in place.

``lbfgs_solve_lanes`` solves a random-effect bucket, one LBFGS per entity,
as the reference's ``vmap`` of ``lbfgs_solve`` does: the state is per lane,
a converged lane is frozen while the others go on, and the host fetches one
flag per line-search round and per iteration.

Defaults match the reference: maxIter=100, history m=10, tolerance=1e-7.
"""

from __future__ import annotations

import dataclasses
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
from photon_ml_tpu_torch.optim.linesearch import strong_wolfe, strong_wolfe_lanes

Tensor = torch.Tensor
F32 = np.float32


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    max_iterations: int = 100
    tolerance: float = 1e-7
    history: int = 10
    c1: float = 1e-4
    c2: float = 0.9
    max_ls_evals: int = 20
    min_curvature: float = 1e-10  # skip the history update below this s.y


def two_loop_direction(
    g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, head: int, n_hist: int, gamma: Tensor
) -> Tensor:
    """Two-loop recursion over the ``n_hist`` newest pairs: H^{-1} g (not negated)."""
    m = S.shape[0]
    alphas: dict[int, Tensor] = {}
    q = g
    for i in range(n_hist):
        idx = (head - 1 - i) % m
        a = rho[idx] * torch.dot(S[idx], q)
        alphas[idx] = a
        q = q - a * Y[idx]
    r = gamma * q
    for i in range(n_hist):
        idx = (head - n_hist + i) % m
        b = rho[idx] * torch.dot(Y[idx], r)
        r = r + (alphas[idx] - b) * S[idx]
    return r


def update_history(
    S: Tensor,
    Y: Tensor,
    rho: Tensor,
    head: int,
    n_hist: int,
    gamma: Tensor,
    s: Tensor,
    y: Tensor,
    sy: Tensor,
    yy: Tensor,
    sy_host: np.float32,
    yy_host: np.float32,
    min_curvature: float,
) -> tuple[int, int, Tensor]:
    """Push (s, y) into the circular history (in place) if s.y is positive
    enough; returns the new (head, n_hist, gamma)."""
    if not sy_host > F32(min_curvature):
        return head, n_hist, gamma
    m = S.shape[0]
    S[head].copy_(s)
    Y[head].copy_(y)
    rho[head] = 1.0 / sy
    if yy_host > 0.0:
        gamma = sy / yy
    return (head + 1) % m, min(n_hist + 1, m), gamma


def lbfgs_solve(
    objective: Objective,
    w0: Tensor,
    config: LBFGSConfig = LBFGSConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """Minimize the objective from ``w0`` on ``device`` (default cuda).

    Without box constraints and with the adapter's margin protocol,
    z = X'w is carried through the loop: each iteration is one gather
    (u = X'p) and one scatter (the gradient). Convergence is judged
    against the value and gradient norm at ``w0``.
    """
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    m, d = config.history, w0.shape[0]
    use_z = (
        constraints is None
        and objective.margins is not None
        and objective.ls_prepare_z is not None
        and objective.ls_advance is not None
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

    S = torch.zeros((m, d), dtype=torch.float32, device=dev)
    Y = torch.zeros((m, d), dtype=torch.float32, device=dev)
    rho = torch.zeros((m,), dtype=torch.float32, device=dev)
    gamma = torch.ones((), dtype=torch.float32, device=dev)
    head = n_hist = it = 0
    reason = NOT_CONVERGED
    w = w0

    while reason == NOT_CONVERGED:
        p = -two_loop_direction(g, S, Y, rho, head, n_hist, gamma)
        dphi0, gg = fetch_f32(torch.dot(g, p), torch.dot(g, g))
        if dphi0 >= 0.0:  # not a descent direction: steepest descent
            p = -g
            dphi0 = -gg
        if n_hist == 0:
            init_step = min(F32(1.0), F32(1.0) / max(gn_h, F32(1e-12)))
        else:
            init_step = F32(1.0)

        carry = objective.ls_prepare_z(z, w, p) if use_z else objective.ls_prepare(w, p)
        ls = strong_wolfe(
            objective.ls_eval, carry, f_h, dphi0, init_step=init_step,
            c1=config.c1, c2=config.c2, max_evals=config.max_ls_evals,
        )

        w_step = w + float(ls.alpha) * p
        if use_z:
            w_new = w_step
            z = objective.ls_advance(carry, float(ls.alpha))
            f_new, g_new = objective.value_and_grad_at(w_new, z)
        else:
            w_new = project_or_identity(constraints, w_step)
            f_new, g_new = objective.value_and_grad(w_new)

        s_vec, y_vec = w_new - w, g_new - g
        sy, yy = torch.dot(s_vec, y_vec), torch.dot(y_vec, y_vec)
        f_new_h, gn_new_h, sy_h, yy_h = fetch_f32(
            f_new, torch.linalg.vector_norm(g_new), sy, yy
        )
        head, n_hist, gamma = update_history(
            S, Y, rho, head, n_hist, gamma, s_vec, y_vec, sy, yy, sy_h, yy_h,
            config.min_curvature,
        )
        it += 1
        reason = convergence_reason(
            it, f_new_h, f_h, gn_new_h, anchor_f, anchor_gn,
            config.max_iterations, config.tolerance, ls.failed,
        )
        if it < len(values):  # max_iterations=0 still runs one iteration
            values[it], gnorms[it] = f_new_h, gn_new_h
        w, f, g, f_h, gn_h = w_new, f_new, g_new, f_new_h, gn_new_h

    return SolveResult(
        w=w,
        value=f,
        grad=g,
        iterations=it,
        reason=reason,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(gnorms),
        data_passes=it + 1,
    )


# -- the lane solver: one LBFGS per entity of a random-effect bucket ---------


class LaneHistory:
    """The circular (s, y) histories of E lanes: S and Y ``[E, m, K]``, rho
    ``[E, m]``, and per lane the next slot, the count of valid pairs and the
    H0 scaling. Each lane's slots are its own; updates are in place."""

    def __init__(self, n_lanes: int, m: int, d: int, device: torch.device):
        self.S = torch.zeros((n_lanes, m, d), dtype=torch.float32, device=device)
        self.Y = torch.zeros_like(self.S)
        self.rho = torch.zeros((n_lanes, m), dtype=torch.float32, device=device)
        self.head = torch.zeros(n_lanes, dtype=torch.int64, device=device)
        self.n_hist = torch.zeros_like(self.head)
        self.gamma = torch.ones(n_lanes, dtype=torch.float32, device=device)
        self._lanes = torch.arange(n_lanes, device=device)

    def direction(self, g: Tensor) -> Tensor:
        """Two-loop recursion per lane over its valid pairs: H^{-1} g (not
        negated), as ``two_loop_direction`` under ``vmap`` (every slot is
        visited; an invalid one adds nothing)."""
        m = self.S.shape[1]
        at = self._lanes
        q = g
        alphas = torch.zeros_like(self.rho)
        for i in range(m):
            idx = (self.head - 1 - i) % m
            a = torch.where(i < self.n_hist,
                            self.rho[at, idx] * torch.sum(self.S[at, idx] * q, dim=-1), 0.0)
            alphas[at, idx] = a
            q = q - a.unsqueeze(-1) * self.Y[at, idx]
        r = self.gamma.unsqueeze(-1) * q
        for i in range(m):
            idx = (self.head - self.n_hist + i) % m
            b = self.rho[at, idx] * torch.sum(self.Y[at, idx] * r, dim=-1)
            c = torch.where(i < self.n_hist, alphas[at, idx] - b, 0.0)
            r = r + c.unsqueeze(-1) * self.S[at, idx]
        return r

    def update(self, s: Tensor, y: Tensor, lanes: Tensor, min_curvature: float) -> None:
        """Push each of ``lanes``' (s, y) pair whose s.y passes
        ``min_curvature`` (``update_history`` per lane); other lanes keep
        their history exactly."""
        sy = torch.sum(s * y, dim=-1)
        yy = torch.sum(y * y, dim=-1)
        ok = lanes & (sy > min_curvature)
        m = self.S.shape[1]
        at, head = self._lanes, self.head
        self.S[at, head] = torch.where(ok.unsqueeze(-1), s, self.S[at, head])
        self.Y[at, head] = torch.where(ok.unsqueeze(-1), y, self.Y[at, head])
        self.rho[at, head] = torch.where(ok, 1.0 / torch.where(ok, sy, 1.0), self.rho[at, head])
        self.head = torch.where(ok, (head + 1) % m, head)
        self.n_hist = torch.where(ok, torch.clamp(self.n_hist + 1, max=m), self.n_hist)
        self.gamma = torch.where(ok & (yy > 0.0), sy / torch.where(yy > 0.0, yy, 1.0),
                                 self.gamma)


def first_step(n_hist: Tensor, grad_norm: Tensor) -> Tensor:
    """Each lane's initial trial step: min(1, 1/||g||) before any history, else 1."""
    return torch.where(n_hist == 0,
                       torch.clamp(1.0 / torch.clamp(grad_norm, min=1e-12), max=1.0),
                       torch.ones_like(grad_norm))


def lbfgs_solve_lanes(
    objective: Objective,
    w0: Tensor,
    config: LBFGSConfig = LBFGSConfig(),
    constraints: Optional[BoxConstraints] = None,
    device: torch.device | str | None = None,
) -> SolveResult:
    """Minimize E independent problems from ``w0 [E, K]`` on ``device``
    (default cuda), one LBFGS per lane: the reference's ``lbfgs_solve``
    under ``vmap`` over a random-effect bucket.

    Every lane has its own history (``LaneHistory``), its own strong-Wolfe
    search (``strong_wolfe_lanes``) and its own convergence reason; all
    lanes step together, and a lane whose reason is set is frozen (w, value,
    gradient, margins, history, iteration and reason stay exactly as they
    were) while the others go on. With the adapter's margin protocol and no
    box, z = X.w ``[E, R]`` is carried as in ``lbfgs_solve``; a box is
    projected per lane. The host fetches one flag per line-search round and
    one per iteration (is any lane still running?), nothing per entity.
    The result's fields are per lane, as ``newton_solve``'s."""
    dev = resolve_device(device)
    w0 = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    if w0.dim() != 2:
        raise ValueError(f"lbfgs_solve_lanes solves a bucket: w0 must be [E, K], got "
                         f"{tuple(w0.shape)}")
    n_lanes, d = w0.shape
    use_z = (
        constraints is None
        and objective.margins is not None
        and objective.ls_prepare_z is not None
        and objective.ls_advance is not None
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
    hist = LaneHistory(n_lanes, config.history, d, dev)
    iteration = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    reason = torch.full_like(iteration, NOT_CONVERGED)
    w = w0

    k = 0
    while True:
        active = reason == NOT_CONVERGED
        p = -hist.direction(g)
        dphi0 = torch.sum(g * p, dim=-1)
        bad = dphi0 >= 0.0  # not a descent direction: steepest descent
        p = torch.where(bad.unsqueeze(-1), -g, p)
        dphi0 = torch.where(bad, -torch.sum(g * g, dim=-1), dphi0)
        carry = objective.ls_prepare_z(z, w, p) if use_z else objective.ls_prepare(w, p)
        ls = strong_wolfe_lanes(
            objective.ls_eval, carry, f, dphi0, first_step(hist.n_hist, gn), active,
            c1=config.c1, c2=config.c2, max_evals=config.max_ls_evals,
        )
        w_new = w + ls.alpha.unsqueeze(-1) * p
        if use_z:
            z_new = objective.ls_advance(carry, ls.alpha)
            f_new, g_new = objective.value_and_grad_at(w_new, z_new)
        else:
            w_new = project_or_identity(constraints, w_new)
            f_new, g_new = objective.value_and_grad(w_new)
        hist.update(w_new - w, g_new - g, active, config.min_curvature)
        gn_new = torch.linalg.vector_norm(g_new, dim=-1)
        it = iteration + 1
        reason_new = convergence_reasons(it, f_new, f, gn_new, anchor_f, anchor_gn,
                                         config.max_iterations, config.tolerance, ls.failed)
        k += 1
        record_lanes(values, gnorms, k, active, f_new, gn_new)
        w = torch.where(active.unsqueeze(-1), w_new, w)
        g = torch.where(active.unsqueeze(-1), g_new, g)
        if use_z:
            z = torch.where(active.unsqueeze(-1), z_new, z)
        f = torch.where(active, f_new, f)
        gn = torch.where(active, gn_new, gn)
        iteration = torch.where(active, it, iteration)
        reason = torch.where(active, reason_new, reason)
        if not any_lane(reason == NOT_CONVERGED):
            break

    return SolveResult(w=w, value=f, grad=g, iterations=iteration, reason=reason,
                       values=values, grad_norms=gnorms, data_passes=iteration + 1)

