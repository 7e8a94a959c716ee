"""Dense per-entity designs: a bucket of small GLM problems in one batch.

Counterpart of ``DenseBatch`` (``photon_ml_tpu/ops/dense.py:40-126``). The
reference holds one entity's design ``x [R, K]`` and reaches a bucket of
entities with ``vmap``; here the entity axis is written out:
``x [E, R, K]`` and ``labels``/``offsets``/``weights`` ``[E, R]``, with
coefficients ``w [E, K]``. Every sweep is one batched contraction
(``torch.einsum`` to cuBLAS's batched GEMM on the card): the reference left
these to XLA and never wrote them in Pallas. Weight 0 marks a padded row.

A margin shift is a host number or one value per entity (``[E]``); the sums
that the reference returns per problem come back per entity (``[E]``).

Each contraction reports its modelled work (``kernels/cost.py``
``dense_rows`` / ``dense_scatter``) to the executable accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.kernels import cost
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.telemetry.executables import account

Tensor = torch.Tensor


def per_entity(shift: Tensor | float):
    """A per-entity [E] shift as an [E, 1] column; a number as it is."""
    if isinstance(shift, Tensor) and shift.dim() == 1:
        return shift.unsqueeze(-1)
    return shift


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    x: Tensor  # f32[E, R, K]
    labels: Tensor  # f32[E, R]
    offsets: Tensor  # f32[E, R]
    weights: Tensor  # f32[E, R]

    @staticmethod
    def from_arrays(
        x: np.ndarray,
        labels: np.ndarray,
        offsets: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
        device: torch.device | str | None = None,
    ) -> "DenseBatch":
        """Upload host arrays ``x [E, R, K]``, ``labels [E, R]`` (offsets 0 and
        weights 1 by default) to ``device``."""
        dev = resolve_device(device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        shape = np.shape(labels)
        return DenseBatch(
            x=up(x),
            labels=up(labels),
            offsets=up(np.zeros(shape) if offsets is None else offsets),
            weights=up(np.ones(shape) if weights is None else weights),
        )

    def dense_rows(self) -> Tensor:
        return self.x

    # -- sweeps (SparseBatch duck type, one problem per entity) --------------

    def dot_rows(self, w: Tensor) -> Tensor:
        """x_er . w_e  -> [E, R]."""
        out = torch.einsum("erk,ek->er", self.x, w)
        account(*cost.dense_rows(*self.x.shape))
        return out

    def margins(self, w: Tensor, shift: Tensor | float = 0.0) -> Tensor:
        return self.dot_rows(w) + per_entity(shift) + self.offsets

    def margins_pair(self, w, shift, p, p_shift) -> tuple[Tensor, Tensor]:
        zu = torch.einsum("erk,ekj->erj", self.x, torch.stack([w, p], dim=-1))
        account(*cost.dense_rows(*self.x.shape, vectors=2))
        return zu[..., 0] + per_entity(shift) + self.offsets, zu[..., 1] + per_entity(p_shift)

    def scatter_features(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[e, r] * x_er  -> [E, K]."""
        out = torch.einsum("er,erk->ek", per_row, self.x)
        account(*cost.dense_scatter(*self.x.shape))
        return out

    def fused_value_grad(self, w, shift, loss_name: str) -> tuple[Tensor, Tensor, Tensor]:
        """Per entity: (sum wgt*l(z), raw gradient sum wgt*dz*x, sum wgt*dz)."""
        z = self.margins(w, shift)
        l, dz = get_loss(loss_name).loss_and_dz(z, self.labels)
        wdz = self.weights * dz
        return (torch.sum(self.weights * l, dim=-1), self.scatter_features(wdz),
                torch.sum(wdz, dim=-1))

    def fused_hessian_vector(self, w, shift, v, v_shift, loss_name: str) -> tuple[Tensor, Tensor]:
        """Per entity: (raw Hv sum wgt*l''(z)*(x.v + v_shift)*x, sum of those row terms)."""
        z, u = self.margins_pair(w, shift, v, v_shift)
        q = self.weights * get_loss(loss_name).d2z(z, self.labels) * u
        return self.scatter_features(q), torch.sum(q, dim=-1)

    def fused_hv_at(self, d2_row: Tensor, v: Tensor, v_shift) -> tuple[Tensor, Tensor]:
        """Per entity: (raw Hv with the row curvature d2 given, sum q), q = d2*(x.v + v_shift)."""
        q = d2_row * (self.dot_rows(v) + per_entity(v_shift))
        return self.scatter_features(q), torch.sum(q, dim=-1)

    def scatter_features_sq(self, per_row: Tensor) -> Tensor:
        """sum_r per_row[e, r] * x_er**2  -> [E, K] (the Hessian diagonal)."""
        out = torch.einsum("er,erk->ek", per_row, self.x * self.x)
        account(*cost.dense_scatter(*self.x.shape, square=True))
        return out

    def with_offsets(self, offsets: Tensor) -> "DenseBatch":
        return dataclasses.replace(self, offsets=offsets.to(torch.float32))
