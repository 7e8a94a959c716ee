"""Feature normalization contexts.

Counterpart of ``NormalizationType``/``NormalizationContext`` in
``photon_ml_tpu/data/normalization.py``: x' = (x - shift) * factor is applied
algebraically inside the objective, and trained coefficients map back by
w = w' * factor; intercept -= w . shift. ``build_normalization_context``
(:82-119) builds a context from a ``FeatureSummary`` (``data/stats.py``).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import torch

from photon_ml_tpu_torch.data.stats import FeatureSummary

Tensor = torch.Tensor


class NormalizationType(str, Enum):
    NONE = "none"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    STANDARDIZATION = "standardization"


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """factors/shifts may be None (identity). The intercept column must be
    left unnormalized (factor 1, shift 0) for the inverse to be exact."""

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    def _intercept(self) -> int:
        if self.intercept_index is None:
            raise ValueError("shifts require an intercept column")
        return self.intercept_index

    def transform_model_coefficients(self, w: Tensor) -> Tensor:
        """Normalized-space coefficients -> original space."""
        out = w if self.factors is None else w * self.factors
        if self.shifts is not None:
            i = self._intercept()
            delta = torch.dot(out, self.shifts)
            out = out.clone()
            out[i] = out[i] - delta
        return out

    def inverse_transform_model_coefficients(self, w: Tensor) -> Tensor:
        """Original space -> normalized space (exact inverse of the above)."""
        out = w
        if self.shifts is not None:
            i = self._intercept()
            delta = torch.dot(out, self.shifts)
            out = out.clone()
            out[i] = out[i] + delta
        if self.factors is not None:
            out = out / self.factors
        return out


def build_normalization_context(
    normalization_type: NormalizationType | str,
    summary: Optional[FeatureSummary] = None,
    intercept_index: Optional[int] = None,
) -> NormalizationContext:
    """A context of ``normalization_type`` from a feature summary, on the
    summary's device. The intercept column keeps factor 1 (and shift 0);
    STANDARDIZATION needs one, so that the shifts can be absorbed."""
    ntype = NormalizationType(normalization_type)
    if ntype == NormalizationType.NONE:
        return NormalizationContext(intercept_index=intercept_index)
    if summary is None:
        raise ValueError(f"{ntype} requires a feature summary")

    def inv_or_one(x: Tensor) -> Tensor:
        return torch.where(x > 0.0, 1.0 / torch.where(x > 0.0, x, 1.0), 1.0)

    def keep_intercept(t: Tensor, value: float) -> Tensor:
        if intercept_index is not None:
            t = t.clone()
            t[intercept_index] = value
        return t

    if ntype == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        magnitude = torch.maximum(torch.abs(summary.max), torch.abs(summary.min))
        return NormalizationContext(factors=keep_intercept(inv_or_one(magnitude), 1.0),
                                    intercept_index=intercept_index)
    factors = keep_intercept(inv_or_one(torch.sqrt(summary.variance)), 1.0)
    if ntype == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        return NormalizationContext(factors=factors, intercept_index=intercept_index)
    if intercept_index is None:
        raise ValueError("STANDARDIZATION requires an intercept column")
    return NormalizationContext(factors=factors, shifts=keep_intercept(summary.mean, 0.0),
                                intercept_index=intercept_index)
