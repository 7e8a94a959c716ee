"""GLM objective: weighted loss value, gradient, Hessian-vector products and
Hessian diagonal over a batch, with feature normalization applied
algebraically and optional L2.

Counterpart of ``photon_ml_tpu/ops/objective.py``. For x' = (x - shift) *
factor the margins and derivatives run against the raw sparse x:
    z_i  = x_i . (w * factor) - (w * factor) . shift + offset_i
    grad = factor * scatter(dz) - (factor * shift) * sum(dz)
The margin shift stays a 0-d device tensor, so no host sync enters a pass.
Over a bucket (a ``DenseBatch`` or a ``BlockDiagonalBatch``) the
coefficients are ``[E, K]`` and every method returns one value per entity
(what the reference gets from ``vmap``): values ``[E]``, gradients, Hv and
the Hessian diagonal ``[E, K]``; ``dense_hessian`` gives the explicit
``[E, K, K]`` Hessians Newton factors. The L2 weight is a number, or one
weight per lane (a ``[L]`` tensor, a sweep's regularization grid), which
broadcasts as ``[L, 1]`` against ``[L, K]`` coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss, get_loss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """F(w) = sum_i weight_i * l(z_i, y_i) + (l2/2)|w|^2.

    ``factors``/``shifts`` implement x' = (x - shift) * factor; ``None`` is
    the identity. L1 is not part of this objective (OWLQN's business).
    """

    loss_name: str
    l2_weight: float | Tensor = 0.0
    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None

    @property
    def loss(self) -> PointwiseLoss:
        return get_loss(self.loss_name)

    def loss_for(self, batch) -> PointwiseLoss:
        """The loss over ``batch``: the position-independent form over the
        lanes of a shared design (``lane_exact``, ``ops/losses.py``)."""
        return get_loss(self.loss_name, lane_exact=getattr(batch, "lane_exact", False))

    @property
    def _l2_col(self) -> float | Tensor:
        """The L2 weight against coefficients: per lane as ``[L, 1]``."""
        l2 = self.l2_weight
        return l2.unsqueeze(-1) if isinstance(l2, Tensor) else l2

    # -- normalization algebra --------------------------------------------

    def _effective(self, w: Tensor) -> tuple[Tensor, Tensor | float]:
        """(w * factor, margin shift -(w*factor).shifts); per entity for [E, K]."""
        w_eff = w if self.factors is None else w * self.factors
        if self.shifts is None:
            return w_eff, 0.0
        if w.dim() == 1:
            return w_eff, -torch.dot(w_eff, self.shifts)
        return w_eff, -(w_eff @ self.shifts)

    def _back_transform_vec(self, raw: Tensor, row_total: Tensor) -> Tensor:
        """factor * raw - (factor * shift) * row_total."""
        out = raw if self.factors is None else raw * self.factors
        if self.shifts is not None:
            fs = self.shifts if self.factors is None else self.factors * self.shifts
            out = out - fs * (row_total if raw.dim() == 1 else row_total.unsqueeze(-1))
        return out

    def margins(self, w: Tensor, batch) -> Tensor:
        w_eff, shift = self._effective(w)
        return batch.margins(w_eff, shift)

    # -- value / gradient --------------------------------------------------

    def value_and_grad(self, w: Tensor, batch) -> tuple[Tensor, Tensor]:
        w_eff, shift = self._effective(w)
        data_value, raw_grad, row_total = batch.fused_value_grad(
            w_eff, shift, self.loss_name
        )
        grad = self._back_transform_vec(raw_grad, row_total)
        return data_value + 0.5 * self.l2_weight * sqnorm(w), grad + self._l2_col * w

    def value_and_grad_at_margins(
        self, w: Tensor, z: Tensor, batch
    ) -> tuple[Tensor, Tensor]:
        """value_and_grad with the margins z already known: one scatter pass
        (the margin-carrying LBFGS fast path); per entity over a bucket."""
        l, dz = self.loss_for(batch).loss_and_dz(z, batch.labels)
        wdz = batch.weights * dz
        data_value = torch.sum(batch.weights * l, dim=-1)
        grad = self._back_transform_vec(batch.scatter_features(wdz), torch.sum(wdz, dim=-1))
        return data_value + 0.5 * self.l2_weight * sqnorm(w), grad + self._l2_col * w

    def value(self, w: Tensor, batch) -> Tensor:
        z = self.margins(w, batch)
        l = self.loss_for(batch).loss(z, batch.labels)
        return torch.sum(batch.weights * l, dim=-1) + 0.5 * self.l2_weight * sqnorm(w)

    # -- second order ------------------------------------------------------

    def hessian_vector(self, w: Tensor, v: Tensor, batch) -> Tensor:
        """H(w) @ v = sum_i weight_i l''(z_i) (x'_i . v) x'_i + l2 v."""
        v_eff, v_shift = self._effective(v)
        w_eff, w_shift = self._effective(w)
        raw_hv, q_total = batch.fused_hessian_vector(
            w_eff, w_shift, v_eff, v_shift, self.loss_name
        )
        return self._back_transform_vec(raw_hv, q_total) + self._l2_col * v

    def curvature_at_margins(self, z: Tensor, batch) -> Tensor:
        """Per-row curvature d2 = weight * l''(z)."""
        return batch.weights * self.loss_for(batch).d2z(z, batch.labels)

    def hessian_vector_with_curvature(self, d2: Tensor, v: Tensor, batch) -> Tensor:
        """H @ v with the per-row curvature d2 already known."""
        v_eff, v_shift = self._effective(v)
        raw_hv, q_total = batch.fused_hv_at(d2, v_eff, v_shift)
        return self._back_transform_vec(raw_hv, q_total) + self._l2_col * v

    def hessian_diagonal(self, w: Tensor, batch) -> Tensor:
        """diag H(w)_j = sum_i weight_i l''(z_i) x'_ij^2 + l2."""
        z = self.margins(w, batch)
        d2_row = batch.weights * self.loss_for(batch).d2z(z, batch.labels)
        raw_sq = batch.scatter_features_sq(d2_row)
        if self.factors is None and self.shifts is None:
            diag = raw_sq
        else:
            f = torch.ones_like(raw_sq) if self.factors is None else self.factors
            if self.shifts is None:
                diag = f * f * raw_sq
            else:
                raw_lin = batch.scatter_features(d2_row)
                total = torch.sum(d2_row, dim=-1)
                total = total if w.dim() == 1 else total.unsqueeze(-1)
                s = self.shifts
                diag = f * f * (raw_sq - 2.0 * s * raw_lin + s * s * total)
        return diag + self._l2_col

    def dense_hessian(self, w: Tensor, batch) -> Tensor:
        """H(w) = X'^T diag(wgt * l'') X' + l2 I as a dense [K, K] per entity
        ([E, K, K] for a bucket; ``ops/objective.py:215-232``), for small K.
        Normalization materializes X' = (X - shift) * factor on the dense
        design. A batch of lanes over a shared bucket design gives its
        Hessians through ``weighted_gram(d2)`` (a random effect has no
        normalization)."""
        z = self.margins(w, batch)
        d2 = batch.weights * self.loss_for(batch).d2z(z, batch.labels)
        if hasattr(batch, "weighted_gram") and self.factors is None and self.shifts is None:
            H = batch.weighted_gram(d2)
        else:
            X = batch.dense_rows()
            if self.shifts is not None:
                X = X - self.shifts
            if self.factors is not None:
                X = X * self.factors
            H = (X * d2.unsqueeze(-1)).transpose(-1, -2) @ X
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        l2 = self._l2_col
        return H + (l2.unsqueeze(-1) if isinstance(l2, Tensor) else l2) * eye

    # -- plumbing ----------------------------------------------------------

    def with_l2(self, l2_weight: float | Tensor) -> "GLMObjective":
        """This objective with L2 weight ``l2_weight``: a number, or a ``[L]``
        tensor of per-lane weights."""
        return dataclasses.replace(self, l2_weight=_l2(l2_weight))


def sqnorm(w: Tensor) -> Tensor:
    """w.w, per entity for [E, K] coefficients."""
    return torch.dot(w, w) if w.dim() == 1 else torch.sum(w * w, dim=-1)


def _l2(l2_weight: float | Tensor) -> float | Tensor:
    return l2_weight if isinstance(l2_weight, Tensor) else float(l2_weight)


def make_objective(
    loss: str | PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    factors: Optional[Tensor] = None,
    shifts: Optional[Tensor] = None,
) -> GLMObjective:
    name = loss if isinstance(loss, str) else loss.name
    return GLMObjective(
        loss_name=get_loss(name).name,
        l2_weight=_l2(l2_weight),
        factors=factors,
        shifts=shifts,
    )
