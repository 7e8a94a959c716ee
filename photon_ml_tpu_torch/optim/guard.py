"""Guarded solves: divergence detection, damped retries, rollback.

Counterpart of ``photon_ml_tpu/optim/guard.py``. After each coordinate
solve a health reduce on the device checks the new coefficients and the
final loss for non-finite values and for a loss regression (the line
searches are monotone, so a final value above the initial one marks a
diverged solve); the coordinate-descent loop fetches that one boolean per
solve. A diverged solve is retried with escalating extra L2 damping, which
enters through the coordinate's ``extra_l2``; a solve that stays divergent
is rolled back to the pre-solve model, and a coordinate rolled back
``freeze_after`` consecutive times is frozen. The reference's
fault-injection seam (``faults.corrupt_health``) is not ported
(ROADMAP.md Queue 1 item 14).

Telemetry counters: ``solves.diverged``, ``solves.retried``,
``solves.rolled_back``, ``solves.frozen``.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# Relative slack of the loss-regression check: a warm-started re-solve may
# end a rounding error above its initial value; only a real regression (or a
# non-finite value) trips the guard.
_REGRESSION_RTOL = 1e-3
_REGRESSION_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """Divergence-recovery policy. ``max_retries`` damped re-runs follow a
    diverged solve; retry ``k`` (1-based) adds ``initial_damping *
    damping_factor**(k-1)`` extra L2. After ``freeze_after`` consecutive
    rollbacks a coordinate is dropped from the updating sequence (its last
    good model keeps scoring)."""

    max_retries: int = 2
    initial_damping: float = 1.0
    damping_factor: float = 10.0
    freeze_after: int = 2

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.initial_damping <= 0 or self.damping_factor < 1.0:
            raise ValueError("damping must be positive and escalate (factor >= 1)")
        if self.freeze_after < 1:
            raise ValueError("freeze_after must be >= 1")

    def damping_for(self, attempt: int) -> float:
        """Extra L2 weight of ``attempt`` (0 = the original solve)."""
        if attempt <= 0:
            return 0.0
        return self.initial_damping * self.damping_factor ** (attempt - 1)


def damped_objective(obj, extra_l2: float):
    """``obj`` with ``extra_l2`` added to its L2 weight; unchanged at 0."""
    if not extra_l2:
        return obj
    return obj.with_l2(obj.l2_weight + extra_l2)


def solve_health(res, w: Tensor) -> Tensor:
    """A 0-d boolean on ``w``'s device: ``res`` (a ``SolveResult``, with a
    leading lane axis for a bucket) produced finite coefficients ``w`` and a
    finite final loss no worse than its initial value ``res.values[..., 0]``
    (within the regression slack)."""
    finite_w = torch.isfinite(w).all()
    v = torch.as_tensor(res.value).to(w.device)
    v0 = torch.as_tensor(res.values).to(w.device)[..., 0]
    budget = _REGRESSION_RTOL * torch.abs(v0) + _REGRESSION_ATOL
    return finite_w & (torch.isfinite(v) & (v <= v0 + budget)).all()


def _coefficient_tensors(model) -> list[Tensor]:
    out = []
    if hasattr(model, "coefficients"):
        out.append(model.coefficients)
    for bm in getattr(model, "buckets", ()):
        # a table kept by its owners: each owner's block
        out.extend(getattr(bm.coefficients, "parts", (bm.coefficients,)))
    if hasattr(model, "latent"):  # a factored model's latent table
        out.append(model.latent)
    return out


def model_is_finite(model) -> Tensor:
    """A 0-d boolean: every coefficient tensor of ``model`` is finite. The
    check for a coordinate that exposes no per-solve ``last_health``."""
    tensors = _coefficient_tensors(model)
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all().to(tensors[0].device) for t in tensors]).all()
