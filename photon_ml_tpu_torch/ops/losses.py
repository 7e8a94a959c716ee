"""Pointwise GLM losses l(z, y), dl/dz, d2l/dz2 on torch tensors.

Counterpart of ``photon_ml_tpu/ops/losses.py``. Labels with y > 0.5 count as
positive, so both {0, 1} and {-1, 1} labels work.

``get_loss(name, lane_exact=True)`` gives the same losses with exp, sigmoid
and softplus evaluated element by element alike on the CPU (``_pointwise``):
the lanes of a design shared by a sweep or a bootstrap
(``ops/shared_design.py``) take them, so that a lane's result does not
depend on the other lanes of its batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_POSITIVE_THRESHOLD = 0.5


class PointwiseLoss(NamedTuple):
    """A pointwise loss with first and second derivatives in z.

    ``has_hessian`` is False for the smoothed hinge, which is not twice
    differentiable; TRON and variances refuse it.
    """

    name: str
    loss: Callable[[Tensor, Tensor], Tensor]
    dz: Callable[[Tensor, Tensor], Tensor]
    d2z: Callable[[Tensor, Tensor], Tensor]
    has_hessian: bool = True

    def loss_and_dz(self, z: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
        return self.loss(z, y), self.dz(z, y)


def _y01(y: Tensor) -> Tensor:
    return (y > _POSITIVE_THRESHOLD).to(y.dtype)


def _ypm1(y: Tensor) -> Tensor:
    return torch.where(y > _POSITIVE_THRESHOLD, 1.0, -1.0).to(y.dtype)


# logistic: l = log(1 + exp(z)) - y*z, y in {0, 1}


def _logistic_loss(z: Tensor, y: Tensor) -> Tensor:
    return F.softplus(z) - _y01(y) * z


def _logistic_dz(z: Tensor, y: Tensor) -> Tensor:
    return torch.sigmoid(z) - _y01(y)


def _logistic_d2z(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss("logistic", _logistic_loss, _logistic_dz, _logistic_d2z)


# squared: l = 0.5 * (z - y)^2


def _squared_loss(z: Tensor, y: Tensor) -> Tensor:
    d = z - y
    return 0.5 * d * d


def _squared_dz(z: Tensor, y: Tensor) -> Tensor:
    return z - y


def _squared_d2z(z: Tensor, y: Tensor) -> Tensor:
    return torch.ones_like(z)


SquaredLoss = PointwiseLoss("squared", _squared_loss, _squared_dz, _squared_d2z)


# poisson: l = exp(z) - y*z


def _poisson_loss(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y * z


def _poisson_dz(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z) - y


def _poisson_d2z(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z)


PoissonLoss = PointwiseLoss("poisson", _poisson_loss, _poisson_dz, _poisson_d2z)


# smoothed hinge (Rennie), u = y*z with y in {-1, +1}:
#   0.5 - u (u <= 0);  0.5*(1-u)^2 (0 < u < 1);  0 (u >= 1)


def _smoothed_hinge_loss(z: Tensor, y: Tensor) -> Tensor:
    u = _ypm1(y) * z
    return torch.where(
        u <= 0.0,
        0.5 - u,
        torch.where(u < 1.0, 0.5 * (1.0 - u) * (1.0 - u), torch.zeros_like(u)),
    )


def _smoothed_hinge_dz(z: Tensor, y: Tensor) -> Tensor:
    ym = _ypm1(y)
    u = ym * z
    du = torch.where(
        u < 0.0, -torch.ones_like(u), torch.where(u < 1.0, u - 1.0, torch.zeros_like(u))
    )
    return du * ym


def _smoothed_hinge_d2z(z: Tensor, y: Tensor) -> Tensor:
    u = _ypm1(y) * z
    return ((u > 0.0) & (u < 1.0)).to(z.dtype)


SmoothedHingeLoss = PointwiseLoss(
    "smoothed_hinge",
    _smoothed_hinge_loss,
    _smoothed_hinge_dz,
    _smoothed_hinge_d2z,
    has_hessian=False,
)


LOSSES: dict[str, PointwiseLoss] = {
    loss.name: loss
    for loss in (LogisticLoss, SquaredLoss, PoissonLoss, SmoothedHingeLoss)
}

_TASK_ALIASES = {
    "logistic_regression": "logistic",
    "linear_regression": "squared",
    "poisson_regression": "poisson",
    "smoothed_hinge_loss_linear_svm": "smoothed_hinge",
}


def _pointwise(fn, x: Tensor) -> Tensor:
    """``fn(x)`` for exp, sigmoid or softplus. On the CPU, PyTorch evaluates
    these with SIMD code on whole vectors and with scalar code on the rest of
    a contiguous run, and the two differ in the last bit, so an element's
    result would depend on where it falls in its tensor; the input is read
    here through a stride-2 copy, which takes the scalar loop for every
    element. On the card every element runs the same code."""
    if x.device.type != "cpu":
        return fn(x)
    spaced = torch.empty(2 * x.numel(), dtype=x.dtype)[::2]
    spaced.copy_(x.reshape(-1))
    return fn(spaced).reshape(x.shape)


def _exact_logistic_d2z(z: Tensor, y: Tensor) -> Tensor:
    s = _pointwise(torch.sigmoid, z)
    return s * (1.0 - s)


_LANE_EXACT: dict[str, PointwiseLoss] = {
    "logistic": PointwiseLoss(
        "logistic", lambda z, y: _pointwise(F.softplus, z) - _y01(y) * z,
        lambda z, y: _pointwise(torch.sigmoid, z) - _y01(y), _exact_logistic_d2z),
    "poisson": PointwiseLoss(
        "poisson", lambda z, y: _pointwise(torch.exp, z) - y * z,
        lambda z, y: _pointwise(torch.exp, z) - y, lambda z, y: _pointwise(torch.exp, z)),
    "squared": SquaredLoss,
    "smoothed_hinge": SmoothedHingeLoss,
}


def get_loss(name: str, lane_exact: bool = False) -> PointwiseLoss:
    """The loss of ``name`` (or a task alias); with ``lane_exact``, its
    position-independent form (module docstring)."""
    key = name.lower()
    key = _TASK_ALIASES.get(key, key)
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Available: {sorted(LOSSES)}")
    return _LANE_EXACT[key] if lane_exact else LOSSES[key]
