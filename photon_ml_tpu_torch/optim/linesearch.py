"""Line searches: strong Wolfe (Nocedal & Wright Alg. 3.5/3.6) and the
backtracking search of OWLQN.

Counterpart of ``strong_wolfe`` and ``backtracking`` in
``photon_ml_tpu/optim/linesearch.py`` (:75-278). The reference runs each
search as a ``lax.while_loop`` of ``jnp.where`` selections; here the same
machine runs on the host, branch for branch, in float32 numpy scalars so
that it picks the same ``alpha`` sequence. Each trial costs one oracle call
on the device and one host fetch of its scalars.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

from photon_ml_tpu_torch.optim.common import fetch_f32

F32 = np.float32

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
