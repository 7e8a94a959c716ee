"""Line searches: strong Wolfe (Nocedal & Wright Alg. 3.5/3.6) and the
backtracking search of OWLQN.

Counterpart of ``strong_wolfe`` and ``backtracking`` in
``photon_ml_tpu/optim/linesearch.py`` (:75-278). The reference runs each
search as a ``lax.while_loop`` of ``jnp.where`` selections; here the same
machine runs on the host, branch for branch, in float32 numpy scalars so
that it picks the same ``alpha`` sequence. Each trial costs one oracle call
on the device and one host fetch of its scalars.

The lane searches (``strong_wolfe_lanes``, ``backtracking_lanes``) run the
same machines for every entity of a random-effect bucket at once, as the
reference's ``vmap`` does: the state is [E] tensors, every decision a
``torch.where``, and the host fetches one flag per round of trials.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from photon_ml_tpu_torch.optim.common import any_lane, fetch_f32

F32 = np.float32
Tensor = torch.Tensor

_BRACKET = 0
_ZOOM = 1
_DONE = 2
_FAILED = 3


class LineSearchResult(NamedTuple):
    alpha: np.float32  # accepted step (0 on failure)
    phi: np.float32
    dphi: np.float32
    failed: bool
    num_evals: int


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant on [a, b]; bisection fallback."""
    with np.errstate(all="ignore"):
        d1 = dfa + dfb - F32(3.0) * (fa - fb) / (a - b)
        rad = d1 * d1 - dfa * dfb
        safe = bool(rad >= 0.0)
        d2 = np.sqrt(rad if safe else F32(0.0)) * np.sign(b - a)
        denom = dfb - dfa + F32(2.0) * d2
        x = b - (b - a) * (dfb + d2 - d1) / denom
        mid = F32(0.5) * (a + b)
        lo, hi = min(a, b), max(a, b)
        margin = F32(0.05) * (hi - lo)
        ok = (
            safe
            and bool(np.isfinite(x))
            and x > lo + margin
            and x < hi - margin
            and abs(denom) > F32(1e-20)
        )
    return F32(x) if ok else F32(mid)


def strong_wolfe(
    ls_eval: Callable[[Any, float], tuple],
    carry: Any,
    phi0: np.float32,
    dphi0: np.float32,
    init_step: float = 1.0,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 20,
    max_step: float = 1e10,
) -> LineSearchResult:
    """Find alpha with phi(a) <= phi0 + c1*a*dphi0 and |dphi(a)| <= c2*|dphi0|.

    ``ls_eval(carry, a) -> (phi(a), dphi(a))`` is the directional oracle (0-d
    tensors). On exhaustion it falls back to the best sufficient-decrease
    trial seen (Armijo-only acceptance).
    """
    phi0, dphi0 = F32(phi0), F32(dphi0)
    c1, c2, max_step = F32(c1), F32(c2), F32(max_step)

    def armijo(a, phi):
        return bool(phi <= phi0 + c1 * a * dphi0)

    def curvature(dphi):
        return bool(abs(dphi) <= c2 * abs(dphi0))

    zero = F32(0.0)
    mode = _BRACKET
    alpha, alpha_prev = F32(init_step), zero
    phi_prev, dphi_prev = phi0, dphi0
    lo, phi_lo, dphi_lo = zero, phi0, dphi0
    hi, phi_hi, dphi_hi = zero, phi0, dphi0
    best = (zero, phi0, dphi0)
    arm = (zero, phi0, dphi0)
    evals = 0

    while mode < _DONE and evals < max_evals:
        phi, dphi = fetch_f32(*ls_eval(carry, float(alpha)))
        evals += 1
        if armijo(alpha, phi) and phi < arm[1]:
            arm = (alpha, phi, dphi)

        if mode == _BRACKET:
            hit_armijo_fail = (not armijo(alpha, phi)) or (evals > 1 and phi >= phi_prev)
            accept = armijo(alpha, phi) and curvature(dphi)
            go_zoom = hit_armijo_fail or (not accept and dphi >= 0.0)
            if hit_armijo_fail:
                zlo = (alpha_prev, phi_prev, dphi_prev)
                zhi = (alpha, phi, dphi)
            else:
                zlo = (alpha, phi, dphi)
                zhi = (alpha_prev, phi_prev, dphi_prev)
            next_alpha = min(alpha * F32(2.0), max_step)
            overflow = alpha >= max_step
            if accept:
                mode = _DONE
            elif go_zoom:
                mode = _ZOOM
            elif overflow:
                mode = _FAILED
            if go_zoom:
                new_alpha = _cubic_min(*zlo, *zhi)
                (lo, phi_lo, dphi_lo), (hi, phi_hi, dphi_hi) = zlo, zhi
            else:
                new_alpha = next_alpha
            if accept:
                best = (alpha, phi, dphi)
            alpha_prev, phi_prev, dphi_prev = alpha, phi, dphi
            alpha = new_alpha
        else:
            a = alpha
            fail_armijo = (not armijo(a, phi)) or phi >= phi_lo
            accept = (not fail_armijo) and curvature(dphi)
            flip_hi = dphi * (hi - lo) >= 0.0
            if fail_armijo:
                new_hi = (a, phi, dphi)
                new_lo = (lo, phi_lo, dphi_lo)
            else:
                new_hi = (lo, phi_lo, dphi_lo) if flip_hi else (hi, phi_hi, dphi_hi)
                new_lo = (a, phi, dphi)
            (lo, phi_lo, dphi_lo), (hi, phi_hi, dphi_hi) = new_lo, new_hi
            tiny = abs(hi - lo) <= F32(1e-12) * max(F32(1.0), abs(lo))
            alpha = _cubic_min(lo, phi_lo, dphi_lo, hi, phi_hi, dphi_hi)
            if accept:
                mode = _DONE
                best = (a, phi, dphi)
            elif tiny:
                mode = _FAILED

    if mode == _DONE:
        return LineSearchResult(*best, failed=False, num_evals=evals)
    if arm[0] > 0.0 and arm[1] < phi0:
        return LineSearchResult(*arm, failed=False, num_evals=evals)
    return LineSearchResult(zero, phi0, dphi0, failed=True, num_evals=evals)


def backtracking(
    trial: Callable[[np.float32], tuple[np.float32, bool]],
    full_value0: np.float32,
    init_step: float = 1.0,
    shrink: float = 0.5,
    max_evals: int = 25,
) -> tuple[np.float32, np.float32, bool]:
    """Shrink alpha from ``init_step`` until ``trial`` accepts it.

    ``trial(alpha) -> (value, accepted)`` evaluates the (projected) candidate
    at ``alpha`` on the device and decides sufficient decrease on the host
    from one fetch. Returns (alpha, value, failed); after ``max_evals``
    rejections, (0, ``full_value0``, True) as the reference does.
    """
    alpha = F32(init_step)
    for _ in range(max_evals):
        value, accepted = trial(alpha)
        if accepted:
            return alpha, F32(value), False
        alpha = F32(alpha * F32(shrink))
    return F32(0.0), F32(full_value0), True


# -- the lane searches: one search per entity of a bucket ---------------------


class LaneSearchResult(NamedTuple):
    alpha: Tensor  # [E] accepted steps (0 on failure)
    phi: Tensor
    dphi: Tensor
    failed: Tensor  # bool [E]
    num_evals: Tensor  # int32 [E]


def _cubic_min_lanes(a, fa, dfa, b, fb, dfb):
    """``_cubic_min`` per lane, on [E] tensors (the reference's
    ``linesearch.py:57-72``)."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    rad = d1 * d1 - dfa * dfb
    safe = rad >= 0.0
    d2 = torch.sqrt(torch.where(safe, rad, 0.0)) * torch.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    x = b - (b - a) * (dfb + d2 - d1) / denom
    mid = 0.5 * (a + b)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    margin = 0.05 * (hi - lo)
    ok = (safe & torch.isfinite(x) & (x > lo + margin) & (x < hi - margin)
          & (torch.abs(denom) > 1e-20))
    return torch.where(ok, x, mid)


def strong_wolfe_lanes(
    ls_eval: Callable[[Any, Tensor], tuple[Tensor, Tensor]],
    carry: Any,
    phi0: Tensor,
    dphi0: Tensor,
    init_step: Tensor,
    active: Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 20,
    max_step: float = 1e10,
) -> LaneSearchResult:
    """``strong_wolfe`` for every lane of a bucket at once: each lane holds
    its own mode, bracket, step size and evaluation count as [E] tensors,
    every round evaluates all lanes' trial steps in one oracle call
    (``ls_eval(carry, alpha [E, 1]) -> (phi, dphi) [E, 1]``), and a lane that
    is done (or not ``active``) is frozen with ``torch.where``, as the
    reference's ``vmap`` of its while-loop freezes it. The host fetches one
    flag per round: is any lane still searching?"""
    dev = phi0.device
    zero = torch.zeros_like(phi0)
    mode = torch.where(active, _BRACKET, _DONE).to(torch.int32)
    alpha, alpha_prev = init_step.to(phi0.dtype), zero
    phi_prev, dphi_prev = phi0, dphi0
    lo, phi_lo, dphi_lo = zero, phi0, dphi0
    hi, phi_hi, dphi_hi = zero, phi0, dphi0
    best_a, best_phi, best_dphi = zero, phi0, dphi0
    arm_a, arm_phi, arm_dphi = zero, phi0, dphi0
    evals = torch.zeros(phi0.shape, dtype=torch.int32, device=dev)

    def armijo(a, phi):
        return phi <= phi0 + c1 * a * dphi0

    def curvature(dphi):
        return torch.abs(dphi) <= c2 * torch.abs(dphi0)

    searching = active
    while True:
        phi, dphi = (t[:, 0] for t in ls_eval(carry, alpha.unsqueeze(1)))
        evals_1 = evals + 1
        ok_armijo = armijo(alpha, phi)
        better = searching & ok_armijo & (phi < arm_phi)
        arm_a = torch.where(better, alpha, arm_a)
        arm_phi = torch.where(better, phi, arm_phi)
        arm_dphi = torch.where(better, dphi, arm_dphi)

        # the bracketing phase (Alg. 3.5): accept, zoom or extend
        fail_b = ~ok_armijo | ((evals_1 > 1) & (phi >= phi_prev))
        accept_b = ok_armijo & curvature(dphi)
        go_zoom = fail_b | (~accept_b & (dphi >= 0.0))
        z_lo = torch.where(fail_b, alpha_prev, alpha)
        z_philo = torch.where(fail_b, phi_prev, phi)
        z_dphilo = torch.where(fail_b, dphi_prev, dphi)
        z_hi = torch.where(fail_b, alpha, alpha_prev)
        z_phihi = torch.where(fail_b, phi, phi_prev)
        z_dphihi = torch.where(fail_b, dphi, dphi_prev)
        mode_b = torch.where(accept_b, _DONE, torch.where(
            go_zoom, _ZOOM, torch.where(alpha >= max_step, _FAILED, _BRACKET)))
        alpha_b = torch.where(go_zoom, _cubic_min_lanes(z_lo, z_philo, z_dphilo, z_hi,
                                                        z_phihi, z_dphihi),
                              torch.clamp(alpha * 2.0, max=max_step))

        # the zoom phase (Alg. 3.6), its trial at alpha
        fail_z = ~ok_armijo | (phi >= phi_lo)
        accept_z = ~fail_z & curvature(dphi)
        flip = dphi * (hi - lo) >= 0.0
        n_lo = torch.where(fail_z, lo, alpha)
        n_philo = torch.where(fail_z, phi_lo, phi)
        n_dphilo = torch.where(fail_z, dphi_lo, dphi)
        n_hi = torch.where(fail_z, alpha, torch.where(flip, lo, hi))
        n_phihi = torch.where(fail_z, phi, torch.where(flip, phi_lo, phi_hi))
        n_dphihi = torch.where(fail_z, dphi, torch.where(flip, dphi_lo, dphi_hi))
        tiny = torch.abs(n_hi - n_lo) <= 1e-12 * torch.clamp(torch.abs(n_lo), min=1.0)
        mode_z = torch.where(accept_z, _DONE, torch.where(tiny, _FAILED, _ZOOM))
        alpha_z = _cubic_min_lanes(n_lo, n_philo, n_dphilo, n_hi, n_phihi, n_dphihi)

        in_b = mode == _BRACKET
        accept = torch.where(in_b, accept_b, accept_z)
        take_b = searching & in_b
        take_z = searching & ~in_b
        zoom_b = take_b & go_zoom

        def pick(old, b_val, z_val, b_mask=take_b):
            return torch.where(b_mask, b_val, torch.where(take_z, z_val, old))

        lo = pick(lo, z_lo, n_lo, zoom_b)
        phi_lo = pick(phi_lo, z_philo, n_philo, zoom_b)
        dphi_lo = pick(dphi_lo, z_dphilo, n_dphilo, zoom_b)
        hi = pick(hi, z_hi, n_hi, zoom_b)
        phi_hi = pick(phi_hi, z_phihi, n_phihi, zoom_b)
        dphi_hi = pick(dphi_hi, z_dphihi, n_dphihi, zoom_b)
        took = searching & accept
        best_a = torch.where(took, alpha, best_a)
        best_phi = torch.where(took, phi, best_phi)
        best_dphi = torch.where(took, dphi, best_dphi)
        alpha_prev = torch.where(take_b, alpha, alpha_prev)
        phi_prev = torch.where(take_b, phi, phi_prev)
        dphi_prev = torch.where(take_b, dphi, dphi_prev)
        alpha = pick(alpha, alpha_b, alpha_z)
        mode = pick(mode, mode_b, mode_z).to(torch.int32)
        evals = torch.where(searching, evals_1, evals)
        searching = active & (mode < _DONE) & (evals < max_evals)
        if not any_lane(searching):
            break

    found = mode == _DONE
    usable = ~found & (arm_a > 0.0) & (arm_phi < phi0)
    return LaneSearchResult(
        alpha=torch.where(found, best_a, torch.where(usable, arm_a, zero)),
        phi=torch.where(found, best_phi, torch.where(usable, arm_phi, phi0)),
        dphi=torch.where(found, best_dphi, torch.where(usable, arm_dphi, dphi0)),
        failed=~(found | usable),
        num_evals=evals,
    )


def backtracking_lanes(
    value_fn: Callable[[Tensor], Tensor],
    full_value0: Tensor,
    sufficient_fn: Callable[[Tensor, Tensor], Tensor],
    init_step: Tensor,
    active: Tensor,
    shrink: float = 0.5,
    max_evals: int = 25,
) -> tuple[Tensor, Tensor, Tensor]:
    """``backtracking`` for every lane at once (the reference's
    ``linesearch.py:242-278`` under ``vmap``): ``value_fn(alpha [E]) ->
    [E]`` evaluates each lane's candidate, ``sufficient_fn(alpha, value) ->
    bool [E]`` decides it. A lane that accepted (or is not ``active``) is
    frozen; the host fetches one flag per round. Returns (alpha, value,
    failed), each [E]; a lane that never accepted gets (0, ``full_value0``,
    True)."""
    alpha = init_step.to(full_value0.dtype)
    value = full_value0
    evals = torch.zeros(full_value0.shape, dtype=torch.int32, device=full_value0.device)
    done = torch.zeros_like(active)
    searching = active
    while True:
        v = value_fn(alpha)
        ok = sufficient_fn(alpha, v)
        alpha = torch.where(searching & ~ok, alpha * shrink, alpha)
        value = torch.where(searching, v, value)
        evals = torch.where(searching, evals + 1, evals)
        done = torch.where(searching, ok, done)
        searching = active & ~done & (evals < max_evals)
        if not any_lane(searching):
            break
    zero = torch.zeros_like(alpha)
    return torch.where(done, alpha, zero), torch.where(done, value, full_value0), ~done
