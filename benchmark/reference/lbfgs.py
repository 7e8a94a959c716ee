"""A plain L-BFGS (two-loop recursion, backtracking Armijo line search).

The control runs it in the program's place, in a lower precision than the
configuration states; it follows no particular implementation's steps.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def lbfgs(value_grad: Callable[[Tensor], tuple[Tensor, Tensor]], w0: Tensor,
          max_iterations: int, history: int = 10, c1: float = 1e-4,
          max_halvings: int = 30) -> tuple[Tensor, Tensor, int]:
    """Minimize from ``w0`` for at most ``max_iterations`` iterations, in
    ``w0``'s dtype; (w, F(w), data passes)."""
    w = w0
    f, g = value_grad(w)
    passes = 1
    S: list[Tensor] = []
    Y: list[Tensor] = []
    for it in range(max_iterations):
        d = _direction(g, S, Y)
        gd = (g * d).sum()
        if not bool(gd < 0):
            d, gd = -g, -(g * g).sum()
        step = 1.0 / max(float(g.float().norm()), 1e-30) if it == 0 else 1.0
        for _ in range(max_halvings):
            w_new = w + step * d
            f_new, g_new = value_grad(w_new)
            passes += 1
            if bool(f_new <= f + c1 * step * gd):
                break
            step *= 0.5
        else:
            break
        s, y = w_new - w, g_new - g
        if bool((s * y).sum() > 0):
            S.append(s)
            Y.append(y)
            if len(S) > history:
                S.pop(0)
                Y.pop(0)
        w, f, g = w_new, f_new, g_new
    return w, f, passes


def _direction(g: Tensor, S: list, Y: list) -> Tensor:
    q = -g
    alphas = []
    for s, y in zip(reversed(S), reversed(Y)):
        rho = 1.0 / (y * s).sum()
        a = rho * (s * q).sum()
        alphas.append((a, rho))
        q = q - a * y
    if S:
        q = q * ((S[-1] * Y[-1]).sum() / (Y[-1] * Y[-1]).sum())
    for (s, y), (a, rho) in zip(zip(S, Y), reversed(alphas)):
        b = rho * (y * q).sum()
        q = q + (a - b) * s
    return q
