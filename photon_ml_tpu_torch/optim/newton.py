"""Damped Newton with explicit Hessians, one batched solve per bucket.

Counterpart of ``newton_solve`` in ``photon_ml_tpu/optim/newton.py:56-175``,
which the reference runs under ``vmap`` over the entities of a random-effect
bucket: a ``lax.while_loop`` that keeps iterating while any lane is
unconverged and freezes converged lanes with ``jnp.where``. Here the entity
axis is written out: every iteration is one set of batched tensor ops over
all E lanes (Hessians ``[E, K, K]``, one batched Cholesky, the step sizes of
all lanes in one sweep), and each state field is frozen per lane with
``torch.where`` once its reason is set. The host fetches one flag per
iteration (is any lane still active?) and nothing per entity; the fetches
count in the telemetry counter ``host_syncs``.

The step is the Cholesky solve of (H + ridge I) d = -g. ``cholesky_ex``
reports the lanes whose factorization failed in ``info``; they step along
-g (the reference tests its NaN-filled factor for finiteness, which
``cholesky_ex`` does not produce). The damping evaluates the step sizes
1, 1/2, ..., 2^-(max_halvings-1) in one sweep through the margin-space
oracle and takes the first that lowers the objective. In a box (the
reference's ``newton.py:77, 100, 130-137``) ``w0`` is projected, each damping
candidate is projected and swept through the full objective (the margin
oracle's affine margins do not survive a projection), and the accepted step
is projected.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.optim.common import (
    NOT_CONVERGED,
    BoxConstraints,
    SolveResult,
    any_lane,
    convergence_reasons,
    project_or_identity,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    max_iterations: int = 20
    tolerance: float = 1e-7
    max_halvings: int = 10  # damping: the step sizes 1, 1/2, ... tried at once
    ridge: float = 1e-8  # added to the Hessian's diagonal before factoring


def newton_solve(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    hessian: Callable[[Tensor], Tensor],
    w0: Tensor,
    ls_prepare: Callable,
    ls_eval: Callable,
    config: NewtonConfig = NewtonConfig(),
    device: torch.device | str | None = None,
    constraints: Optional[BoxConstraints] = None,
    value: Optional[Callable[[Tensor], Tensor]] = None,
) -> SolveResult:
    """Minimize E independent convex problems from ``w0 [E, K]`` on
    ``device`` (default cuda).

    ``value_and_grad(w) -> (f [E], g [E, K])``, ``hessian(w) -> [E, K, K]``;
    the oracle (``ls_prepare(w, p)``, ``ls_eval(carry, alphas) ->
    (phi [E, A], dphi)``) makes the damping candidates elementwise work on
    the carried margins. The result's fields are per lane: ``iterations``,
    ``reason`` and ``data_passes`` are int32 ``[E]`` tensors, ``values`` and
    ``grad_norms`` ``[E, max_iterations + 1]`` (+inf after each lane's last
    iteration). With ``constraints`` (per-lane ``[E, K]`` or shared ``[K]``
    bounds) the candidates go through ``value(w) -> [E]``, the full
    objective.
    """
    dev = resolve_device(device)
    if constraints is not None and value is None:
        raise ValueError("a box-constrained Newton sweeps its candidates through value(w)")
    if w0.dim() != 2:
        raise ValueError(f"newton_solve solves a bucket: w0 must be [E, K], got {tuple(w0.shape)}")
    w = project_or_identity(constraints, w0.to(device=dev, dtype=torch.float32))
    n_lanes, d = w.shape
    f, g = value_and_grad(w)
    gn = torch.linalg.vector_norm(g, dim=-1)
    anchor_f, anchor_gn = f, gn
    n_vals = config.max_iterations + 1
    values = torch.full((n_lanes, n_vals), float("inf"), dtype=f.dtype, device=dev)
    gnorms = torch.full_like(values, float("inf"))
    values[:, 0], gnorms[:, 0] = f, gn
    iteration = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    reason = torch.full_like(iteration, NOT_CONVERGED)

    eye = torch.eye(d, dtype=w.dtype, device=dev)
    alphas = torch.tensor(0.5, dtype=w.dtype, device=dev) ** torch.arange(
        config.max_halvings, dtype=w.dtype, device=dev)

    k = 0
    while True:
        active = reason == NOT_CONVERGED
        L, info = torch.linalg.cholesky_ex(hessian(w) + config.ridge * eye)
        ok = info == 0
        L = torch.where(ok[:, None, None], L, eye)
        newton = -torch.cholesky_solve(g.unsqueeze(-1), L).squeeze(-1)
        step = torch.where(ok[:, None], newton, -g)

        if constraints is None:
            f_tries = ls_eval(ls_prepare(w, step), alphas)[0]
        else:
            f_tries = torch.stack([value(constraints.project(w + a * step)) for a in alphas],
                                  dim=1)
        good = f_tries < f.unsqueeze(1)
        found = good.any(dim=1)
        first = torch.argmax(good.to(torch.int32), dim=1)  # the first decrease
        best = torch.where(found, alphas[first], torch.zeros_like(f))

        w_new = project_or_identity(constraints, w + best.unsqueeze(1) * step)
        f_new, g_new = value_and_grad(w_new)
        gn_new = torch.linalg.vector_norm(g_new, dim=-1)
        it = iteration + 1
        reason_new = convergence_reasons(it, f_new, f, gn_new, anchor_f, anchor_gn,
                                         config.max_iterations, config.tolerance, ~found)
        k += 1
        if k < n_vals:  # every active lane is at iteration k
            values[:, k] = torch.where(active, f_new, values[:, k])
            gnorms[:, k] = torch.where(active, gn_new, gnorms[:, k])
        w = torch.where(active[:, None], w_new, w)
        g = torch.where(active[:, None], g_new, g)
        f = torch.where(active, f_new, f)
        iteration = torch.where(active, it, iteration)
        reason = torch.where(active, reason_new, reason)
        if not any_lane(reason == NOT_CONVERGED):
            break

    return SolveResult(
        w=w,
        value=f,
        grad=g,
        iterations=iteration,
        reason=reason,
        values=values,
        grad_norms=gnorms,
        data_passes=iteration + 1,
    )
